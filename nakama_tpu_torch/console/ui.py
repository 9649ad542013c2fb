"""Embedded operator UI — a multi-view admin app over the console JSON API.

The port's copy of the JAX package's static operator page. The
reference embeds a full Angular build (reference console/ui.go:24);
here the JSON API is the contract and this page is a dependency-free
operator app covering every console rpc: status/runtime dashboard,
accounts (profile/metadata/wallet editing, ledger, friends, groups,
ban/unban/unlink/export/delete), storage (browse by collection,
read/write/delete objects, import, delete-all), groups (detail, members,
promote/demote, export), matches with live state, the matchmaker,
leaderboards (detail, records, record delete), chat message browse +
delete, purchases/subscriptions, console operator users, config +
warnings, and the API explorer (list endpoints, call any endpoint as any
user, rpc). Served at `/` on the console listener.

The `R` table below names every (method, path-template) pair the UI
calls; tests/test_torch_console.py parses it out of this source and
diffs it against the port console's route table, so a console rpc
cannot be added without the UI reaching it.
"""

PAGE = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>nakama-tpu console</title>
<style>
 body { font-family: ui-monospace, Menlo, monospace; margin: 0;
        background: #0b1020; color: #d7e0ff; }
 header { padding: 10px 16px; background: #141b33; display: flex;
          gap: 12px; align-items: baseline; flex-wrap: wrap; }
 header h1 { font-size: 16px; margin: 0; color: #8ab4ff; }
 nav { display: flex; gap: 4px; flex-wrap: wrap; }
 nav button, .bar button, form button, td button, div button {
   background: #1d2747; color: #d7e0ff; border: 1px solid #31407a;
   padding: 4px 10px; cursor: pointer; font: inherit; }
 nav button.active { background: #31407a; }
 button.danger { border-color: #a33; color: #ff8a8a; }
 main { padding: 16px; }
 table { border-collapse: collapse; width: 100%; margin-top: 8px; }
 td, th { border: 1px solid #2a3663; padding: 4px 8px; text-align: left;
          font-size: 12px; }
 input, textarea, select { background: #0f1630; color: #d7e0ff;
   border: 1px solid #31407a; padding: 4px 6px; font: inherit; }
 pre { background: #0f1630; padding: 10px; overflow: auto;
       border: 1px solid #2a3663; }
 .err { color: #ff8a8a; }
 .ok { color: #8aff9e; }
 .bar { display: flex; gap: 6px; align-items: center; flex-wrap: wrap;
        margin: 6px 0; }
 h3, h4 { margin: 12px 0 4px; color: #8ab4ff; }
 #login { max-width: 320px; margin: 80px auto; display: flex;
          flex-direction: column; gap: 8px; }
</style>
</head>
<body>
<div id="app"></div>
<script>
// Route table: every console rpc the UI can reach, by logical name.
// Templates use {param} placeholders filled by u(). The server-side
// coverage test diffs THIS table against the live route table.
const R = {
  authenticate:     ['POST',   '/v2/console/authenticate'],
  logout:           ['POST',   '/v2/console/authenticate/logout'],
  status:           ['GET',    '/v2/console/status'],
  overload:         ['GET',    '/v2/console/overload'],
  traces:           ['GET',    '/v2/console/traces'],
  traceGet:         ['GET',    '/v2/console/traces/{trace_id}'],
  config:           ['GET',    '/v2/console/config'],
  runtime:          ['GET',    '/v2/console/runtime'],
  accountList:      ['GET',    '/v2/console/account'],
  accountsDelete:   ['DELETE', '/v2/console/account'],
  accountGet:       ['GET',    '/v2/console/account/{id}'],
  accountUpdate:    ['POST',   '/v2/console/account/{id}'],
  accountDelete:    ['DELETE', '/v2/console/account/{id}'],
  accountWallet:    ['GET',    '/v2/console/account/{id}/wallet'],
  accountBan:       ['POST',   '/v2/console/account/{id}/ban'],
  accountUnban:     ['POST',   '/v2/console/account/{id}/unban'],
  accountExport:    ['GET',    '/v2/console/account/{id}/export'],
  accountFriends:   ['GET',    '/v2/console/account/{id}/friend'],
  friendDelete:     ['DELETE', '/v2/console/account/{id}/friend/{friend_id}'],
  accountGroups:    ['GET',    '/v2/console/account/{id}/group'],
  ledgerList:       ['GET',    '/v2/console/account/{id}/walletledger'],
  ledgerDelete:     ['DELETE', '/v2/console/account/{id}/walletledger/{ledger_id}'],
  accountUnlink:    ['POST',   '/v2/console/account/{id}/unlink/{provider}'],
  storageList:      ['GET',    '/v2/console/storage'],
  storageWrite:     ['POST',   '/v2/console/storage'],
  storageDeleteAll: ['DELETE', '/v2/console/storage'],
  storageCollections: ['GET',  '/v2/console/storage/collections'],
  storageImport:    ['POST',   '/v2/console/storage/import'],
  storageGet:       ['GET',    '/v2/console/storage/{collection}/{key}/{user_id}'],
  storageDelete:    ['DELETE', '/v2/console/storage/{collection}/{key}/{user_id}'],
  matchList:        ['GET',    '/v2/console/match'],
  matchState:       ['GET',    '/v2/console/match/{id}/state'],
  matchmaker:       ['GET',    '/v2/console/matchmaker'],
  cluster:          ['GET',    '/v2/console/cluster'],
  fleet:            ['GET',    '/v2/console/fleet'],
  fleetTraces:      ['GET',    '/v2/console/fleet/traces'],
  fleetTraceGet:    ['GET',    '/v2/console/fleet/traces/{trace_id}'],
  fleetReshard:     ['POST',   '/v2/console/fleet/reshard'],
  soak:             ['GET',    '/v2/console/soak'],
  device:           ['GET',    '/v2/console/device'],
  deviceCapture:    ['POST',   '/v2/console/device/capture'],
  lbList:           ['GET',    '/v2/console/leaderboard'],
  lbDevice:         ['GET',    '/v2/console/leaderboard/device'],
  lbGet:            ['GET',    '/v2/console/leaderboard/{id}/detail'],
  lbRecords:        ['GET',    '/v2/console/leaderboard/{id}'],
  lbRecordDelete:   ['DELETE', '/v2/console/leaderboard/{id}/owner/{owner_id}'],
  channelMessages:  ['GET',    '/v2/console/channel/{channel_id}'],
  messageDelete:    ['DELETE', '/v2/console/channel/{channel_id}/message/{message_id}'],
  messagesDelete:   ['DELETE', '/v2/console/message'],
  groupList:        ['GET',    '/v2/console/group'],
  groupGet:         ['GET',    '/v2/console/group/{id}'],
  groupUpdate:      ['POST',   '/v2/console/group/{id}'],
  groupDelete:      ['DELETE', '/v2/console/group/{id}'],
  groupExport:      ['GET',    '/v2/console/group/{id}/export'],
  groupMembers:     ['GET',    '/v2/console/group/{id}/member'],
  groupMemberAdd:   ['POST',   '/v2/console/group/{id}/member'],
  groupMemberRemove: ['DELETE', '/v2/console/group/{id}/member/{user_id}'],
  groupPromote:     ['POST',   '/v2/console/group/{id}/member/{user_id}/promote'],
  groupDemote:      ['POST',   '/v2/console/group/{id}/member/{user_id}/demote'],
  purchaseList:     ['GET',    '/v2/console/purchase'],
  subscriptionList: ['GET',    '/v2/console/subscription'],
  userList:         ['GET',    '/v2/console/user'],
  userCreate:       ['POST',   '/v2/console/user'],
  userDelete:       ['DELETE', '/v2/console/user/{username}'],
  apiEndpoints:     ['GET',    '/v2/console/api/endpoints'],
  apiCall:          ['POST',   '/v2/console/api/endpoints/call'],
  apiRpc:           ['POST',   '/v2/console/api/endpoints/rpc/{id}'],
  deleteAll:        ['DELETE', '/v2/console/all'],
};

const $ = (h) => { const d = document.createElement('div');
                   d.innerHTML = h; return d; };
// EVERY server-sourced value is escaped before touching innerHTML:
// player-controlled names/keys/metadata must never execute with the
// operator's console token (stored-XSS).
const esc = (v) => String(v).replace(/[&<>"']/g, (c) => ({
  '&': '&amp;', '<': '&lt;', '>': '&gt;', '"': '&quot;', "'": '&#39;',
})[c]);
const jpre = (v) => `<pre>${esc(JSON.stringify(v, null, 2))}</pre>`;
let token = sessionStorage.getItem('ctok') || '';

// Fill a R-table path template with encoded params + query string.
const u = (tpl, params, query) => {
  let path = tpl.replace(/\{(\w+)\}/g,
    (_, k) => encodeURIComponent((params || {})[k] ?? ''));
  if (query) {
    const qs = Object.entries(query)
      .filter(([, v]) => v !== undefined && v !== '')
      .map(([k, v]) => `${k}=${encodeURIComponent(v)}`).join('&');
    if (qs) path += '?' + qs;
  }
  return path;
};

const call = async (route, params, body, query) => {
  const [method, tpl] = R[route];
  const r = await fetch(u(tpl, params, query), {
    method,
    headers: Object.assign(
      { 'Authorization': 'Bearer ' + token },
      body !== undefined ? { 'Content-Type': 'application/json' } : {}),
    body: body !== undefined ? JSON.stringify(body) : undefined,
  });
  const text = await r.text();
  let data; try { data = JSON.parse(text); } catch { data = { raw: text }; }
  if (!r.ok) {
    if (r.status === 401) { loginView(data.error || 'session expired'); }
    throw new Error(data.error || r.status);
  }
  return data;
};

// Report an action's outcome into a status span.
const report = (el, fn) => async () => {
  try {
    const out = await fn();
    el.innerHTML = `<span class="ok">${esc(out || 'ok')}</span>`;
  } catch (e) {
    el.innerHTML = `<span class="err">${esc(e.message)}</span>`;
  }
};
const app = document.getElementById('app');

function loginView(msg) {
  app.innerHTML = '';
  const v = $(`<div id="login"><h1>nakama-tpu console</h1>
    <input id="u" placeholder="username">
    <input id="p" type="password" placeholder="password">
    <button id="go">Sign in</button>
    <div class="err">${esc(msg || '')}</div></div>`);
  v.querySelector('#go').onclick = async () => {
    try {
      const r = await fetch(R.authenticate[1], {
        method: 'POST', headers: { 'Content-Type': 'application/json' },
        body: JSON.stringify({ username: v.querySelector('#u').value,
                               password: v.querySelector('#p').value })});
      const d = await r.json();
      if (!r.ok) throw new Error(d.error || r.status);
      token = d.token; sessionStorage.setItem('ctok', token); mainView();
    } catch (e) { loginView(e.message); }
  };
  app.appendChild(v);
}

// ------------------------------------------------------------ account detail
async function accountDetail(el, id) {
  const det = el.querySelector('#detail');
  const [acct, w, friends, groups] = await Promise.all([
    call('accountGet', { id }), call('accountWallet', { id }),
    call('accountFriends', { id }), call('accountGroups', { id }),
  ]);
  const ledger = await call('ledgerList', { id });
  det.innerHTML = `<h3>${esc(id)}</h3>
    <div class="bar">
      <button id="export">Export</button>
      <button id="ban">Ban</button>
      <button id="unban">Unban</button>
      <select id="prov">${['device', 'email', 'custom', 'apple',
        'facebook', 'facebookinstantgame', 'gamecenter', 'google',
        'steam'].map(p => `<option>${p}</option>`).join('')}</select>
      <input id="provid" placeholder="device id (device only)" size="18">
      <button id="unlink">Unlink</button>
      <button id="del" class="danger">Delete account</button>
      <span id="r"></span>
    </div>
    <div id="exported"></div>
    ${jpre(acct)}
    <h4>edit profile / wallet</h4>
    <div class="bar">
      <input id="un" placeholder="username">
      <input id="dn" placeholder="display_name">
      <input id="md" placeholder='metadata {"k": "v"}' size="24">
      <input id="wl" placeholder='wallet {"gold": 10}' size="24">
      <button id="save">Save</button>
    </div>
    <h4>wallet</h4>${jpre(w.wallet !== undefined ? w.wallet : w)}
    <h4>wallet ledger</h4>
    <table><tr><th>id</th><th>changeset</th><th>metadata</th><th></th></tr>
    ${(ledger.items || []).map(l =>
      `<tr><td>${esc(l.id)}</td><td>${esc(JSON.stringify(l.changeset))}</td>
       <td>${esc(JSON.stringify(l.metadata))}</td>
       <td><button data-led="${esc(l.id)}">delete</button></td></tr>`
    ).join('')}</table>
    <h4>friends</h4>
    <table><tr><th>user</th><th>state</th><th></th></tr>
    ${(friends.friends || []).map(f =>
      `<tr><td>${esc(f.user && f.user.id || f.user_id)}</td>
       <td>${esc(f.state)}</td>
       <td><button data-fr="${esc(f.user && f.user.id || f.user_id)}">
       remove</button></td></tr>`).join('')}</table>
    <h4>groups</h4>${jpre(groups.user_groups || groups)}`;
  const r = det.querySelector('#r');
  det.querySelector('#export').onclick = report(r, async () => {
    const d = await call('accountExport', { id });
    det.querySelector('#exported').innerHTML = jpre(d);
    return 'exported';
  });
  det.querySelector('#ban').onclick =
    report(r, () => call('accountBan', { id }, {}));
  det.querySelector('#unban').onclick =
    report(r, () => call('accountUnban', { id }, {}));
  det.querySelector('#unlink').onclick = report(r, () =>
    call('accountUnlink',
         { id, provider: det.querySelector('#prov').value },
         { device_id: det.querySelector('#provid').value }));
  det.querySelector('#del').onclick = report(r, async () => {
    await call('accountDelete', { id });
    det.innerHTML = '';
    return 'deleted';
  });
  det.querySelector('#save').onclick = report(r, async () => {
    const body = {};
    for (const [sel, key] of [['#un', 'username'],
                              ['#dn', 'display_name']]) {
      const v = det.querySelector(sel).value;
      if (v) body[key] = v;
    }
    for (const [sel, key] of [['#md', 'metadata'], ['#wl', 'wallet']]) {
      const v = det.querySelector(sel).value;
      if (v) body[key] = JSON.parse(v);
    }
    await call('accountUpdate', { id }, body);
    return 'saved';
  });
  // On success re-render (which replaces the status span with a fresh
  // one); on failure leave the error visible — a refresh would detach
  // the span and silently swallow it.
  const actThenRefresh = (fn) => async () => {
    try {
      await fn();
      await accountDetail(el, id);
    } catch (e) {
      r.innerHTML = `<span class="err">${esc(e.message)}</span>`;
    }
  };
  det.querySelectorAll('[data-led]').forEach(b => b.onclick =
    actThenRefresh(() =>
      call('ledgerDelete', { id, ledger_id: b.dataset.led })));
  det.querySelectorAll('[data-fr]').forEach(b => b.onclick =
    actThenRefresh(() =>
      call('friendDelete', { id, friend_id: b.dataset.fr })));
}

// ------------------------------------------------------------ group detail
async function groupDetail(el, id) {
  const det = el.querySelector('#detail');
  const [g, members] = await Promise.all([
    call('groupGet', { id }), call('groupMembers', { id }),
  ]);
  det.innerHTML = `<h3>${esc(g.name || id)}</h3>
    <div class="bar">
      <button id="export">Export</button>
      <button id="del" class="danger">Delete group</button>
      <span id="r"></span>
    </div>
    <div id="exported"></div>
    ${jpre(g)}
    <h4>edit</h4>
    <div class="bar">
      <input id="gn" placeholder="name">
      <input id="gd" placeholder="description">
      <select id="go2"><option value="">open?</option>
        <option value="true">open</option>
        <option value="false">closed</option></select>
      <button id="save">Save</button>
    </div>
    <h4>members</h4>
    <div class="bar">
      <input id="uid" placeholder="user id to add" size="36">
      <button id="add">Add member</button>
    </div>
    <table><tr><th>user</th><th>state</th><th></th></tr>
    ${(members.group_users || members.members || []).map(m => {
      const uid = m.user && m.user.id || m.user_id;
      return `<tr><td>${esc(uid)}</td><td>${esc(m.state)}</td>
        <td><button data-p="${esc(uid)}">promote</button>
            <button data-d="${esc(uid)}">demote</button>
            <button data-k="${esc(uid)}">remove</button></td></tr>`;
    }).join('')}</table>`;
  const r = det.querySelector('#r');
  const actThenRefresh = (fn) => async () => {
    try {
      await fn();
      await groupDetail(el, id);
    } catch (e) {
      r.innerHTML = `<span class="err">${esc(e.message)}</span>`;
    }
  };
  det.querySelector('#export').onclick = report(r, async () => {
    const d = await call('groupExport', { id });
    det.querySelector('#exported').innerHTML = jpre(d);
    return 'exported';
  });
  det.querySelector('#del').onclick = report(r, async () => {
    await call('groupDelete', { id });
    det.innerHTML = '';
    return 'deleted';
  });
  det.querySelector('#save').onclick = report(r, async () => {
    const body = {};
    const gn = det.querySelector('#gn').value;
    const gd = det.querySelector('#gd').value;
    const go = det.querySelector('#go2').value;
    if (gn) body.name = gn;
    if (gd) body.description = gd;
    if (go) body.open = go === 'true';
    await call('groupUpdate', { id }, body);
    return 'saved';
  });
  det.querySelector('#add').onclick = actThenRefresh(() =>
    call('groupMemberAdd', { id },
         { user_id: det.querySelector('#uid').value }));
  det.querySelectorAll('[data-p]').forEach(b => b.onclick =
    actThenRefresh(() =>
      call('groupPromote', { id, user_id: b.dataset.p }, {})));
  det.querySelectorAll('[data-d]').forEach(b => b.onclick =
    actThenRefresh(() =>
      call('groupDemote', { id, user_id: b.dataset.d }, {})));
  det.querySelectorAll('[data-k]').forEach(b => b.onclick =
    actThenRefresh(() =>
      call('groupMemberRemove', { id, user_id: b.dataset.k })));
}

const TABS = {
  status: async (el) => {
    const [s, ov, rt] = await Promise.all([
      call('status'), call('overload'), call('runtime'),
    ]);
    el.appendChild($(`<h4>status</h4>${jpre(s)}
      <h4>overload</h4>${jpre(ov)}
      <h4>runtime</h4>${jpre(rt)}`));
  },
  accounts: async (el) => {
    el.appendChild($(`<div class="bar">
        <input id="q" placeholder="filter (username/id)">
        <button id="go">Search</button>
        <button id="bulkdel" class="danger">Delete ALL accounts</button>
        <button id="nuke" class="danger">Delete ALL data</button>
        <span id="r"></span>
      </div>
      <div id="list"></div><div id="detail"></div>`));
    const r = el.querySelector('#r');
    const load = async () => {
      const d = await call('accountList', {}, undefined,
        { limit: 50, filter: el.querySelector('#q').value });
      const rows = (d.users || []).map(u2 =>
        `<tr><td><a href="#" data-id="${esc(u2.id)}">${esc(u2.id)}</a></td>
         <td>${esc(u2.username)}</td><td>${esc(u2.create_time)}</td></tr>`)
        .join('');
      el.querySelector('#list').innerHTML =
        `<table><tr><th>id</th><th>username</th><th>created</th></tr>` +
        rows + `</table>`;
      el.querySelectorAll('a[data-id]').forEach(a => a.onclick = (e) => {
        e.preventDefault();
        accountDetail(el, a.dataset.id).catch(err =>
          el.querySelector('#detail').innerHTML =
            `<pre class="err">${esc(err.message)}</pre>`);
      });
    };
    el.querySelector('#go').onclick = () => load().catch(() => {});
    el.querySelector('#bulkdel').onclick = report(r, async () => {
      if (!confirm('Delete ALL user accounts?')) return 'cancelled';
      await call('accountsDelete', {});
      await load();
      return 'all accounts deleted';
    });
    el.querySelector('#nuke').onclick = report(r, async () => {
      if (!confirm('Delete ALL DATA (accounts, storage, everything)?'))
        return 'cancelled';
      await call('deleteAll', {});
      await load();
      return 'all data deleted';
    });
    await load();
  },
  storage: async (el) => {
    const cols = await call('storageCollections');
    el.appendChild($(`
      <div class="bar">
        <select id="col"><option value="">(all collections)</option>
        ${(cols.collections || []).map(c =>
          `<option>${esc(c)}</option>`).join('')}</select>
        <button id="go">Browse</button>
        <button id="delall" class="danger">Delete ALL storage</button>
        <span id="r"></span>
      </div>
      <div class="bar">
        <input id="c" placeholder="collection">
        <input id="k" placeholder="key">
        <input id="u" placeholder="user_id" size="36">
        <input id="v" placeholder='{"json": "value"}' size="28">
        <button id="w">Write</button>
        <button id="rd">Read</button>
        <button id="dl" class="danger">Delete</button>
      </div>
      <div class="bar">
        <textarea id="imp" rows="3" cols="60"
          placeholder="import: JSON array or CSV"></textarea>
        <button id="doimp">Import</button>
      </div>
      <div id="one"></div><div id="list"></div>`));
    const r = el.querySelector('#r');
    const params = () => ({
      collection: el.querySelector('#c').value,
      key: el.querySelector('#k').value,
      user_id: el.querySelector('#u').value });
    const load = async () => {
      const d = await call('storageList', {}, undefined,
        { limit: 50, collection: el.querySelector('#col').value });
      el.querySelector('#list').innerHTML =
        `<table><tr><th>collection</th><th>key</th><th>owner</th>
         <th>version</th></tr>` +
        (d.objects || []).map(o =>
          `<tr><td>${esc(o.collection)}</td><td>${esc(o.key)}</td>
           <td>${esc(o.user_id)}</td><td>${esc(o.version)}</td></tr>`)
          .join('') + `</table>`;
    };
    el.querySelector('#go').onclick = () => load().catch(() => {});
    el.querySelector('#w').onclick = report(r, async () => {
      const p = params();
      await call('storageWrite', {}, {
        collection: p.collection, key: p.key, user_id: p.user_id,
        value: el.querySelector('#v').value });
      await load();
      return 'written';
    });
    el.querySelector('#rd').onclick = report(r, async () => {
      const d = await call('storageGet', params());
      el.querySelector('#one').innerHTML = jpre(d);
      return 'read';
    });
    el.querySelector('#dl').onclick = report(r, async () => {
      await call('storageDelete', params());
      await load();
      return 'deleted';
    });
    el.querySelector('#delall').onclick = report(r, async () => {
      if (!confirm('Delete ALL storage objects?')) return 'cancelled';
      await call('storageDeleteAll', {});
      await load();
      return 'storage wiped';
    });
    el.querySelector('#doimp').onclick = report(r, async () => {
      const resp = await fetch(R.storageImport[1], {
        method: 'POST',
        headers: { 'Authorization': 'Bearer ' + token },
        body: el.querySelector('#imp').value });
      const d2 = await resp.json();
      if (!resp.ok) throw new Error(d2.error || resp.status);
      await load();
      return `imported ${d2.imported}`;
    });
    await load();
  },
  groups: async (el) => {
    const d = await call('groupList', {}, undefined, { limit: 50 });
    const rows = (d.groups || []).map(g =>
      `<tr><td><a href="#" data-id="${esc(g.id)}">${esc(g.id)}</a></td>
       <td>${esc(g.name)}</td><td>${esc(g.edge_count)}</td>
       <td>${esc(g.open)}</td></tr>`).join('');
    el.appendChild($(`<table><tr><th>id</th><th>name</th><th>members</th>
      <th>open</th></tr>${rows}</table><div id="detail"></div>`));
    el.querySelectorAll('a[data-id]').forEach(a => a.onclick = (e) => {
      e.preventDefault();
      groupDetail(el, a.dataset.id).catch(err =>
        el.querySelector('#detail').innerHTML =
          `<pre class="err">${esc(err.message)}</pre>`);
    });
  },
  matches: async (el) => {
    const d = await call('matchList');
    const rows = (d.matches || []).map(m =>
      `<tr><td><a href="#" data-id="${esc(m.match_id)}">
       ${esc(m.match_id)}</a></td><td>${esc(m.label || '')}</td>
       <td>${esc(m.size)}</td><td>${esc(m.authoritative)}</td></tr>`)
      .join('');
    el.appendChild($(`<table><tr><th>id</th><th>label</th><th>size</th>
      <th>authoritative</th></tr>${rows}</table><div id="st"></div>`));
    el.querySelectorAll('a[data-id]').forEach(a => a.onclick = async (e) => {
      e.preventDefault();
      try {
        const s = await call('matchState', { id: a.dataset.id });
        el.querySelector('#st').innerHTML =
          `<h4>live state</h4>${jpre(s)}`;
      } catch (err) {
        el.querySelector('#st').innerHTML =
          `<pre class="err">${esc(err.message)}</pre>`;
      }
    });
  },
  matchmaker: async (el) => {
    const d = await call('matchmaker');
    el.appendChild($(jpre(d)));
  },
  cluster: async (el) => {
    // Cluster posture: role, peer liveness, per-peer bus queue +
    // breaker state, local/remote presence split.
    const d = await call('cluster');
    el.appendChild($(jpre(d)));
  },
  fleet: async (el) => {
    // Fleet pane of glass: health roll-up + active alerts, per-node
    // freshness, the merged scenario SLO table, the shard/lease map,
    // and the stitched cross-node trace browser (hop latencies +
    // clock offsets shown per span).
    const d = await call('fleet');
    if (!d.enabled || !d.is_collector) {
      el.appendChild($(jpre(d))); return;
    }
    const alerts = ((d.alerts || {}).active || []).map(a =>
      `<tr><td>${esc(a.rule)}</td><td>${esc(a.subject)}</td>
       <td>${esc(a.severity)}</td><td>${esc(a.detail)}</td>
       <td>${esc(a.rounds)}</td></tr>`).join('');
    const nodes = Object.entries(d.nodes || {}).map(([n, i]) => {
      // Per-node shard-map generation + live migration phase: a node
      // still on an older generation than the collector's is mid-fold
      // of a reshard; a non-idle phase is a migration in flight.
      const cl = (i.data || {}).cluster || {};
      const rs = cl.reshard || {};
      const mig = rs.phase && rs.phase !== 'idle'
        ? `${rs.phase} ${(rs.plan || {}).shard || ''}` : '';
      return `<tr><td>${esc(n)}</td><td>${esc(i.state)}</td>
       <td>${esc(i.stale ? 'STALE' : 'fresh')}</td>
       <td>${esc(i.age_ms)}</td>
       <td>${esc(i.clock_offset_ms)}</td>
       <td>${esc(cl.generation != null ? cl.generation : '')}</td>
       <td>${esc(mig)}</td></tr>`;
    }).join('');
    const slo = Object.entries(d.slo_merged || {}).map(([n, r]) =>
      `<tr><td>${esc(n)}</td><td>${esc(r.ops)}</td>
       <td>${esc(r.availability)}</td><td>${esc(r.p99_ms)}</td>
       <td>${esc(r.burn_1h)}</td>
       <td>${esc(r.internal_errors)}</td></tr>`).join('');
    el.appendChild($(`<h4>status: ${esc(d.status)}</h4>
      <h4>active alerts</h4>
      <table><tr><th>rule</th><th>subject</th><th>sev</th>
      <th>detail</th><th>rounds</th></tr>${alerts}</table>
      <h4>nodes</h4>
      <table><tr><th>node</th><th>state</th><th>fresh</th>
      <th>age ms</th><th>clock off ms</th><th>map gen</th>
      <th>migration</th></tr>${nodes}</table>
      <h4>merged scenario SLO table</h4>
      <table><tr><th>scenario</th><th>ops</th><th>avail</th>
      <th>p99ms</th><th>burn1h</th><th>interr</th></tr>${slo}</table>
      <h4>shards (map generation ${esc(d.generation || 0)})</h4>
      ${jpre(d.shards || {})}
      ${d.reshard ? `<h4>reshard planner</h4>${jpre(d.reshard)}` : ''}
      <h4>submit reshard plan</h4>
      <input id="rsplan" size="80" placeholder=
        '{"kind":"split","shard":"o1/1","shards":["o1/0","o1/1"],"source":"o1","target":"o5"}'>
      <button id="rsgo">submit</button> <span id="rsout"></span>
      <h4>recent alert events</h4>
      ${jpre((d.alerts || {}).recent_events || [])}
      <div id="ftr"></div><div id="fdet"></div>`));
    el.querySelector('#rsgo').onclick = report(
      el.querySelector('#rsout'),
      async () => {
        const plan = JSON.parse(el.querySelector('#rsplan').value);
        const q = await call('fleetReshard', {}, plan);
        return `queued ${q.queued} (${q.pending} pending)`;
      });
    const t = await call('fleetTraces', {}, undefined, { n: 50 });
    const rows = (t.traces || []).map(x =>
      `<tr><td><a href="#" data-id="${esc(x.trace_id)}">` +
      `${esc(x.trace_id)}</a></td><td>${esc(x.root)}</td>` +
      `<td>${esc((x.nodes || []).join(','))}</td>` +
      `<td>${esc(x.stitched)}</td><td>${esc(x.n_spans)}</td>` +
      `<td>${esc(x.extent_ms)}</td><td>${esc(x.status)}</td></tr>`)
      .join('');
    el.querySelector('#ftr').innerHTML =
      `<h4>stitched fleet traces</h4>
      <table><tr><th>trace</th><th>root</th><th>nodes</th>
      <th>stitched</th><th>spans</th><th>ms</th><th>status</th>
      </tr>${rows}</table>`;
    el.querySelectorAll('#ftr a[data-id]').forEach(a => a.onclick =
      async (e) => {
        e.preventDefault();
        const one = await call('fleetTraceGet',
          { trace_id: a.dataset.id });
        el.querySelector('#fdet').innerHTML = jpre(one);
      });
  },
  soak: async (el) => {
    // Soak posture: open-loop session population + the live
    // per-scenario SLO table the soak judge gates on.
    const d = await call('soak');
    if (!d.enabled) { el.appendChild($(jpre(d))); return; }
    const rows = Object.entries(d.slo_table || {}).map(([n, r]) =>
      `<tr><td>${esc(n)}</td><td>${esc(r.ops)}</td>
       <td>${esc(r.availability)}</td><td>${esc(r.p99_ms)}</td>
       <td>${esc(r.burn_5m)}</td><td>${esc(r.burn_1h)}</td>
       <td>${esc(r.internal_errors)}</td></tr>`).join('');
    el.appendChild($(`<h4>sessions</h4>${jpre(d.sessions || {})}
      <h4>per-scenario SLO table</h4>
      <table><tr><th>scenario</th><th>ops</th><th>avail</th>
      <th>p99ms</th><th>burn5m</th><th>burn1h</th><th>interr</th>
      </tr>${rows}</table>`));
  },
  device: async (el) => {
    // Device telemetry: kernel clocks + compile-watch, HBM ledger by
    // owner, mesh occupancy, recent kernel timeline, and the bounded
    // on-demand profiler capture.
    const d = await call('device');
    const rows = (d.kernels || []).map(k =>
      `<tr><td>${esc(k.kernel)}</td><td>${esc(k.calls)}</td>
       <td>${esc(k.p50_ms)}</td><td>${esc(k.p99_ms)}</td>
       <td>${esc(k.ema_ms)}</td><td>${esc(k.compiles)}</td>
       <td>${esc(k.recompiles)}</td></tr>`).join('');
    // Per-shard occupancy rows when the pool mesh is live: which
    // device holds how many tickets (and how much HBM) at a glance.
    const shards = ((d.mesh || {}).mesh || {}).shards || [];
    const shardTable = shards.length ?
      `<h4>mesh shards</h4>
      <table><tr><th>device</th><th>slots</th><th>occupied</th>
      <th>hbm_bytes</th></tr>` + shards.map(s =>
        `<tr><td>${esc(s.device)}</td><td>${esc(s.slots)}</td>
         <td>${esc(s.occupied)}</td><td>${esc(s.hbm_bytes)}</td>
         </tr>`).join('') + `</table>` : '';
    el.appendChild($(`<div class="bar">
        <button id="cap">Capture 1s profile</button><span id="r"></span>
      </div>
      <h4>kernels (warmed=${esc((d.warmup || {}).warmed)})</h4>
      <table><tr><th>kernel</th><th>calls</th><th>p50ms</th>
      <th>p99ms</th><th>emams</th><th>compiles</th><th>recompiles</th>
      </tr>${rows}</table>
      <h4>memory by owner</h4>${jpre(d.memory || {})}
      <h4>transfers</h4>${jpre(d.transfers || [])}
      ${shardTable}
      <h4>mesh</h4>${jpre(d.mesh || {})}
      <h4>timeline</h4>${jpre(d.timeline || [])}`));
    el.querySelector('#cap').onclick = report(
      el.querySelector('#r'),
      async () => {
        const out = await call('deviceCapture', {}, {
          duration_ms: 1000,
        });
        return `capture written to ${out.path}`;
      });
  },
  traces: async (el) => {
    // Tail-sampled request traces: summary table → one-click span
    // drill-down (OTLP-ish body rendered verbatim).
    const d = await call('traces', {}, undefined, { n: 100 });
    const rows = (d.traces || []).map(t =>
      `<tr><td><a href="#" data-id="${esc(t.trace_id)}">` +
      `${esc(t.trace_id)}</a></td><td>${esc(t.root)}</td>` +
      `<td>${esc(t.duration_ms)}</td><td>${esc(t.status)}</td>` +
      `<td>${esc(t.reason)}</td><td>${esc(t.n_spans)}</td></tr>`)
      .join('');
    el.appendChild($(`<h4>sampling</h4>${jpre({
      sample_rate: d.sample_rate, slow_ms: d.slow_ms,
      finished_total: d.finished_total, kept_total: d.kept_total,
      kept_by: d.kept_by })}
      <h4>slo burn rates</h4>${jpre(d.slo || {})}
      <h4>kept traces</h4>
      <table><tr><th>trace</th><th>root</th><th>ms</th><th>status</th>
      <th>reason</th><th>spans</th></tr>${rows}</table>
      <div id="det"></div>`));
    el.querySelectorAll('a[data-id]').forEach(a => a.onclick =
      async (e) => {
        e.preventDefault();
        const one = await call('traceGet', { trace_id: a.dataset.id });
        el.querySelector('#det').innerHTML = jpre(one);
      });
  },
  leaderboards: async (el) => {
    const [d, dev] = await Promise.all([
      call('lbList'), call('lbDevice'),
    ]);
    const rows = (d.leaderboards || []).map(l =>
      `<tr><td><a href="#" data-id="${esc(l.id)}">${esc(l.id)}</a></td>
       <td>${esc(l.sort_order)}</td><td>${esc(l.operator)}</td>
       <td>${esc(l.tournament || false)}</td></tr>`).join('');
    el.appendChild($(`<p>device engine: ${esc(dev.enabled
      ? `${dev.breaker_state} · ${(dev.boards || []).length} board(s) ·
         ${dev.device_reads || 0} device reads ·
         ${dev.fallbacks || 0} fallbacks`
      : 'disabled')}</p>
      <table><tr><th>id</th><th>sort</th><th>operator</th>
      <th>tournament</th></tr>${rows}</table><div id="det"></div>`));
    el.querySelectorAll('a[data-id]').forEach(a => a.onclick = async (e) => {
      e.preventDefault();
      const id = a.dataset.id;
      const det = el.querySelector('#det');
      const [meta, recs] = await Promise.all([
        call('lbGet', { id }), call('lbRecords', { id }),
      ]);
      det.innerHTML = `<h3>${esc(id)}</h3>${jpre(meta)}
        <h4>records</h4><span id="r"></span>
        <table><tr><th>owner</th><th>username</th><th>score</th>
        <th>rank</th><th></th></tr>
        ${(recs.records || []).map(rc =>
          `<tr><td>${esc(rc.owner_id)}</td><td>${esc(rc.username)}</td>
           <td>${esc(rc.score)}</td><td>${esc(rc.rank)}</td>
           <td><button data-o="${esc(rc.owner_id)}">delete</button>
           </td></tr>`).join('')}</table>`;
      const r = det.querySelector('#r');
      det.querySelectorAll('[data-o]').forEach(b => b.onclick =
        report(r, async () => {
          await call('lbRecordDelete', { id, owner_id: b.dataset.o });
          return 'record deleted';
        }));
    });
  },
  chat: async (el) => {
    el.appendChild($(`<div class="bar">
        <input id="ch" placeholder="channel id (e.g. 2...room name)"
          size="36">
        <button id="go">Browse</button> <span id="r"></span>
      </div>
      <div class="bar">
        <input id="ids" placeholder="message ids, comma separated"
          size="40">
        <input id="before" placeholder="before (epoch seconds)">
        <button id="bulk" class="danger">Bulk delete</button>
      </div>
      <div id="list"></div>`));
    const r = el.querySelector('#r');
    const load = async () => {
      const ch = el.querySelector('#ch').value;
      if (!ch) return;
      const d = await call('channelMessages', { channel_id: ch });
      el.querySelector('#list').innerHTML =
        `<table><tr><th>id</th><th>user</th><th>content</th><th></th></tr>`
        + (d.messages || []).map(m =>
          `<tr><td>${esc(m.message_id || m.id)}</td>
           <td>${esc(m.username || m.sender_id)}</td>
           <td>${esc(m.content)}</td>
           <td><button data-m="${esc(m.message_id || m.id)}">delete
           </button></td></tr>`).join('') + `</table>`;
      el.querySelectorAll('[data-m]').forEach(b => b.onclick =
        report(r, async () => {
          await call('messageDelete',
                     { channel_id: ch, message_id: b.dataset.m });
          await load();
          return 'message deleted';
        }));
    };
    el.querySelector('#go').onclick = () => load().catch(e2 =>
      r.innerHTML = `<span class="err">${esc(e2.message)}</span>`);
    el.querySelector('#bulk').onclick = report(r, async () => {
      const ids = el.querySelector('#ids').value
        .split(',').map(s => s.trim()).filter(Boolean);
      const before = el.querySelector('#before').value;
      const body = {};
      if (ids.length) body.ids = ids;
      if (before) body.before = parseFloat(before);
      const d = await call('messagesDelete', {}, body);
      await load();
      return `deleted ${d.deleted !== undefined ? d.deleted : 'ok'}`;
    });
  },
  purchases: async (el) => {
    const [p, s] = await Promise.all([
      call('purchaseList'), call('subscriptionList'),
    ]);
    el.appendChild($(`<h4>purchases</h4>${jpre(p)}
      <h4>subscriptions</h4>${jpre(s)}`));
  },
  users: async (el) => {
    el.appendChild($(`<div class="bar">
        <input id="nu" placeholder="username">
        <input id="np" type="password" placeholder="password">
        <input id="ne" placeholder="email">
        <select id="nr"><option value="4">readonly</option>
          <option value="3">maintainer</option>
          <option value="2">developer</option>
          <option value="1">admin</option></select>
        <button id="add">Create operator</button> <span id="r"></span>
      </div><div id="list"></div>`));
    const r = el.querySelector('#r');
    const load = async () => {
      const d = await call('userList');
      el.querySelector('#list').innerHTML =
        `<table><tr><th>username</th><th>email</th><th>role</th>
         <th></th></tr>` +
        (d.users || []).map(u2 =>
          `<tr><td>${esc(u2.username)}</td><td>${esc(u2.email || '')}</td>
           <td>${esc(u2.role)}</td>
           <td><button data-u="${esc(u2.username)}" class="danger">
           delete</button></td></tr>`).join('') + `</table>`;
      el.querySelectorAll('[data-u]').forEach(b => b.onclick =
        report(r, async () => {
          await call('userDelete', { username: b.dataset.u });
          await load();
          return 'operator deleted';
        }));
    };
    el.querySelector('#add').onclick = report(r, async () => {
      await call('userCreate', {}, {
        username: el.querySelector('#nu').value,
        password: el.querySelector('#np').value,
        email: el.querySelector('#ne').value,
        role: parseInt(el.querySelector('#nr').value, 10) });
      await load();
      return 'created';
    });
    await load();
  },
  config: async (el) => {
    const [d, s] = await Promise.all([call('config'), call('status')]);
    el.appendChild($(`<h4>warnings</h4>
      ${jpre(s.config_warnings)}
      <h4>config (redacted)</h4>
      ${jpre(d)}`));
  },
  explorer: async (el) => {
    const eps = await call('apiEndpoints');
    el.appendChild($(`
      <h4>call any api endpoint</h4>
      <div class="bar">
        <select id="m"><option>GET</option><option>POST</option>
          <option>PUT</option><option>DELETE</option></select>
        <select id="ep">${(eps.endpoints || []).map(ep =>
          `<option>${esc(ep.path)}</option>`).join('')}</select>
        <input id="as" placeholder="act as user_id (optional)" size="36">
      </div>
      <div class="bar">
        <textarea id="b" rows="3" cols="60"
          placeholder="request body (JSON)"></textarea>
        <button id="go">Call</button>
      </div>
      <div id="out"></div>
      <h4>rpc</h4>
      <div class="bar">
        <input id="id" placeholder="rpc id">
        <textarea id="pl" rows="2" cols="40" placeholder="payload">
        </textarea>
        <button id="rpc">Call rpc</button>
      </div>
      <div id="rout"></div>`));
    el.querySelector('#go').onclick = async () => {
      try {
        const body = {
          method: el.querySelector('#m').value,
          path: el.querySelector('#ep').value,
        };
        const as = el.querySelector('#as').value;
        const b = el.querySelector('#b').value;
        if (as) body.user_id = as;
        if (b) body.body = b;
        const d = await call('apiCall', {}, body);
        el.querySelector('#out').innerHTML = jpre(d);
      } catch (e) {
        el.querySelector('#out').innerHTML =
          `<pre class="err">${esc(e.message)}</pre>`;
      }
    };
    el.querySelector('#rpc').onclick = async () => {
      try {
        const d = await call('apiRpc',
          { id: el.querySelector('#id').value },
          { payload: el.querySelector('#pl').value.trim() });
        el.querySelector('#rout').innerHTML = jpre(d);
      } catch (e) {
        el.querySelector('#rout').innerHTML =
          `<pre class="err">${esc(e.message)}</pre>`;
      }
    };
  },
};

function mainView(active) {
  active = active || 'status';
  app.innerHTML = '';
  const nav = $(`<header><h1>nakama-tpu</h1><nav>` +
    Object.keys(TABS).map(t =>
      `<button class="${t === active ? 'active' : ''}" data-t="${t}">` +
      `${t}</button>`).join('') +
    `</nav><button id="out">sign out</button></header><main></main>`);
  nav.querySelectorAll('[data-t]').forEach(b =>
    b.onclick = () => mainView(b.dataset.t));
  nav.querySelector('#out').onclick = async () => {
    try { await call('logout', {}, {}); } catch (e) {}
    token = ''; sessionStorage.removeItem('ctok'); loginView();
  };
  app.appendChild(nav);
  const el = app.querySelector('main');
  TABS[active](el).catch(e => {
    if (String(e.message).includes('auth')) return loginView(e.message);
    el.appendChild($(`<pre class="err">${esc(e.message)}</pre>`));
  });
}

token ? mainView() : loginView();
</script>
</body>
</html>
"""
