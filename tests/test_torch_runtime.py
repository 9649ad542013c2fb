"""The port's runtime (`nakama_tpu_torch/runtime/`) held against the JAX
package's `runtime/`: the Lua and JS interpreters run the same sources
(the language cases of `test_lua_runtime.py` and `test_js_runtime.py`)
and must print the same lines, return the same converted values, raise
the same error class with the same message and run out of fuel at the
same step; the loader, over one directory holding a `.py`, a `.lua` and
a `.js` module (each package loads its own copy), gives the same
modules, rpc ids, match names, hook keys, rpc answers, matched-hook
answers and load errors; `nk` has the same public methods, fails the
same way without a social client or purchases, and gives the same
answers with them (a `StubSocialClient`, `Purchases` over one injected
store fetcher, a Satori client over one injected fetcher); a Python matchmaker
override picks the same groups from the same seeded pool in the JAX
`LocalMatchmaker` and the port's over `CudaBackend(device="cpu")`; and
the leaderboard scheduler hands the reset and end hooks the same
payloads, fired on a fake clock.

Stated tolerance: none — every compared value must be equal."""

import importlib
import inspect
import json
import time

import numpy as np
import pytest

import provider_fakes as F
from fixtures import quiet_logger

from nakama_tpu.config import Config as JaxConfig
from nakama_tpu.config import MatchmakerConfig as JaxMatchmakerConfig
from nakama_tpu.leaderboard import LeaderboardRankCache as JaxRankCache
from nakama_tpu.leaderboard import LeaderboardScheduler as JaxScheduler
from nakama_tpu.leaderboard import Leaderboards as JaxLeaderboards
from nakama_tpu.leaderboard import Tournaments as JaxTournaments
from nakama_tpu.matchmaker import LocalMatchmaker as JaxLocal
from nakama_tpu.matchmaker import MatchmakerPresence as JaxPresence
from nakama_tpu.matchmaker.types import MatchmakerEntry as JaxEntry
from nakama_tpu.runtime import NakamaModule as JaxNakamaModule
from nakama_tpu.storage.db import Database as JaxDatabase
from nakama_tpu.utils import cronexpr as jax_cron
from nakama_tpu_torch.config import Config
from nakama_tpu_torch.config import MatchmakerConfig
from nakama_tpu_torch.leaderboard import (
    LeaderboardRankCache,
    LeaderboardScheduler,
    Leaderboards,
    Tournaments,
)
from nakama_tpu_torch.logger import test_logger as port_logger
from nakama_tpu_torch.matchmaker import LocalMatchmaker, MatchmakerPresence
from nakama_tpu_torch.matchmaker.cuda import CudaBackend
from nakama_tpu_torch.matchmaker.types import MatchmakerEntry
from nakama_tpu_torch.runtime import NakamaModule
from nakama_tpu_torch.storage.db import Database

PACKAGES = ("nakama_tpu", "nakama_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.runtime.{name}")


def _error(e: Exception):
    """An error as a comparable value: its class name and message (a JS
    throw's value converted to a host value)."""
    value = getattr(e, "value", None)
    if value is not None and type(e).__name__ == "JsThrow":
        stdlib = importlib.import_module(type(e).__module__[:-6] + "stdlib")
        return type(e).__name__, repr(stdlib.from_js(value))
    return type(e).__name__, str(e)


# ------------------------------------------------------------------ Lua

LUA_CASES = {
    "core": ("""
        local function fib(n)
          if n < 2 then return n end
          return fib(n - 1) + fib(n - 2)
        end
        print(fib(15))
        local acc = {}
        for i = 10, 1, -2 do table.insert(acc, i) end
        print(table.concat(acc, " "))
        local t = {x = 1}
        function t.get(self) return self.x end
        function t:bump() self.x = self.x + 1 end
        t:bump()
        print(t:get())
        local a, b, c = (function() return 1, 2, 3 end)()
        print(a + b + c)
        """, None),
    "strings_tables_json": ("""
        print(("Xyz"):lower(), string.rep("ab", 3))
        print(string.format("%05d|%.2f|%s", 42, 3.14159, "ok"))
        print(string.match("user-123", "%a+%-(%d+)"))
        local words = {}
        for w in string.gmatch("alpha beta gamma", "%a+") do
          table.insert(words, w)
        end
        print(#words, words[2])
        local doc = json.decode('{"nums": [1,2,3], "flag": false}')
        doc.nums[4] = 4
        print(json.encode(doc.nums), tostring(doc.flag))
        return doc
        """, None),
    "closures_scoping": ("""
        local function make(step)
          local n = 0
          return function() n = n + step return n end
        end
        local by2, by10 = make(2), make(10)
        by2() by10()
        print(by2(), by10())
        local x = "outer"
        do local x = "inner" print(x) end
        print(x)
        """, None),
    "pcall_error_values": ("""
        local ok, err = pcall(function() error({code = 42}) end)
        print(ok, type(err), err.code)
        local ok2, err2 = pcall(function() return nil + 1 end)
        print(ok2, err2)
        print(pcall(function() return "fine" end))
        """, None),
    "uncaught_error": ('print("before") error("boom: " .. 7)', None),
    "fuel_uncatchable": (
        "pcall(function() while true do end end)", 50_000),
    # The step at which the budget runs out: the same last print.
    "fuel_same_budget": ("""
        local i = 0
        while true do
          i = i + 1
          if i % 97 == 0 then print(i) end
        end
        """, 20_000),
    "no_ambient_capabilities": (
        "return io, os, require, load, loadstring, dofile, debug", None),
    "depth_cap": ("local function f() return f() + 1 end f()", None),
    "host_values_cross_by_conversion": (
        "return {list = {1, 2}, n = 3.0, s = 'x', f = 2.5}, 7, nil, true",
        None),
    "bracket_classes_and_gsub_limit": ("""
        print(string.match("foo42", "[a-z]+"))
        print(string.match("x7", "[%d]"))
        print(string.gsub("aaa", "a", "b", 0))
        print(string.gsub("aaa", "a", "b", 2))
        print(pcall(tonumber, "zz", 16))
        print(pcall(string.rep, "a", 200000000))
        print(pcall(function() return unpack({}, 1, 1e9) end))
        """, None),
    "malformed_number": ("return 0x", None),
    "syntax_error": ("local = 3", None),
}


def lua_run(pkg: str, src: str, fuel):
    parser, stdlib = _mod(pkg, "lua.parser"), _mod(pkg, "lua.stdlib")
    out: list = []
    try:
        interp = stdlib.new_interp(print_fn=out.append, fuel=fuel)
        result = interp.run_chunk(parser.parse(src, "case"))
    except Exception as e:
        return {"out": out, "error": _error(e)}
    return {"out": out,
            "result": [stdlib.from_lua(v) for v in (result or ())]}


@pytest.mark.parametrize("case", sorted(LUA_CASES))
def test_lua_cases_run_as_in_the_jax_package(case):
    src, fuel = LUA_CASES[case]
    want, got = (lua_run(pkg, src, fuel) for pkg in PACKAGES)
    assert got == want
    if "fuel" in case:
        assert got["error"][0] == "FuelExhausted"
    if case == "fuel_same_budget":
        assert len(got["out"]) > 5


# ------------------------------------------------------------------- JS

JS_CASES = {
    "core": ("""
        var total = 0;
        for (let i = 1; i <= 100; i++) { total += i; }
        console.log(total);
        function fib(n) { return n < 2 ? n : fib(n - 1) + fib(n - 2); }
        console.log(fib(15));
        let m = 0;
        switch (2) {
          case 1: m = 1; break;
          case 2: m = 2;
          case 3: m += 10; break;
          default: m = 99;
        }
        console.log(m);
        let i = 0, acc = "";
        do { acc += i; i++; } while (i < 3);
        console.log(acc);
        console.log(1 == "1", 1 === "1", null == undefined,
                    null === undefined, NaN === NaN);
        console.log(typeof 1, typeof "s", typeof undefined,
                    typeof null, typeof fib);
        console.log(5 & 3, 5 | 2, 1 << 4, -8 >> 1, -8 >>> 28, ~0);
        """, None),
    "objects_arrays_json": ("""
        let o = {a: 1, "b": 2, ["c" + 1]: 3, short: 4};
        o.d = Object.keys(o).length;
        delete o.short;
        console.log(JSON.stringify(o));
        let arr = [5, 3, 1, 4].sort(function(a, b) { return a - b; });
        console.log(arr.join("-"), arr.length, arr.indexOf(4));
        let mapped = arr.map(x => x * 2).filter(x => x > 4);
        console.log(JSON.stringify(mapped));
        console.log(arr.reduce((acc, x) => acc + x, 100));
        let round = JSON.parse('{"deep": {"list": [1, 2, {"k": "v"}]}}');
        console.log(round.deep.list[2].k, "k" in round.deep.list[2]);
        console.log("a,b,,c".split(",").length, "  pad  ".trim());
        for (const entry of Object.entries({x: 9, y: 2.5})) {
            console.log(entry[0], entry[1]);
        }
        """, None),
    "closures_arrows_this": ("""
        function counter() { let n = 0; return () => { n++; return n; }; }
        const c = counter();
        c(); c();
        console.log(c());
        const obj = {
            v: 7,
            plain: function() { return this.v; },
            viaArrow: function() { const get = () => this.v; return get(); }
        };
        console.log(obj.plain(), obj.viaArrow());
        const add = (a, b) => a + b;
        console.log(add.call(undefined, 1, 2), add.apply(null, [3, 4]));
        """, None),
    "try_catch_throw_finally": ("""
        let steps = [];
        try {
            try { throw {code: 7, message: "boom"}; }
            finally { steps.push("inner-finally"); }
        } catch (e) {
            steps.push("caught:" + e.code + ":" + e.message);
        } finally {
            steps.push("outer-finally");
        }
        try { undefinedFunction(); } catch (e) { steps.push(e.message); }
        console.log(steps.join("|"));
        """, None),
    "uncaught_throw": (
        'console.log("before"); throw {code: 3, message: "late"};', None),
    "fuel_uncatchable": ("try { while (true) {} } catch (e) {}", 50_000),
    "fuel_same_budget": ("""
        let i = 0;
        while (true) { i++; if (i % 97 === 0) { console.log(i); } }
        """, 20_000),
    "depth_cap": ("function f() { return f(); } f();", None),
    "no_ambient_require": ("require();", None),
    "no_ambient_process": ("process();", None),
    "no_ambient_eval": ("eval();", None),
    "no_ambient_date": ("Date();", None),
    "no_math_random": ("console.log(typeof Math.random);", None),
    "spread_in_call_position": ("""
        function sum() {
          var total = 0;
          for (var i = 0; i < arguments.length; i++) { total += arguments[i]; }
          return total;
        }
        var parts = [1, 2, 3];
        console.log(sum(...parts));
        console.log(sum(10, ...parts, ...[4, 5]));
        console.log(Math.max(...parts, 7));
        function count() { return arguments.length; }
        console.log(count(..."abc"));
        """, None),
    "spread_of_non_iterable": ("function f() {} f(...42);", None),
    "template_literal_unsupported": ("let t = `template`;", None),
    "rest_not_last": ("function f(...rest, after) {}", None),
    "destructuring_unsupported": ("let [a, b] = [1, 2];", None),
    "rest_params": ("""
        function tag(level, ...parts) {
          return level + ":" + parts.join(",") + "/" + parts.length;
        }
        console.log(tag("info"));
        console.log(tag("err", "a", "b", "c"));
        var pick = (first, ...others) => first + "|" + others.length;
        console.log(pick("x", "y", "z"));
        function both(...xs) { return xs.length + arguments.length; }
        console.log(both(1, 2));
        """, None),
    "new_operator": ("""
        function Point(x, y) { this.x = x; this.y = y; }
        var p = new Point(3, 4);
        console.log(p.x + p.y);
        function Box() { this.v = 1; return {inner: 42}; }
        console.log(new Box().inner);
        function Prim() { this.v = 7; return 5; }
        console.log(new Prim().v);
        var ns = {Ctor: Point};
        console.log(new ns.Ctor(10, 20).y);
        var bare = new Point;
        console.log(bare.x === undefined);
        var s = new Point(...[7, 8]);
        console.log(s.x + s.y);
        """, None),
    "class_declarations": ("""
        class Animal {
          constructor(name) { this.name = name; this.sound = "..."; }
          speak() { return this.name + " says " + this.sound; }
          static family() { return "Animalia"; }
        }
        class Dog extends Animal {
          constructor(name) { super(name); this.sound = "woof"; }
          speak() { return super.speak() + "!"; }
          tags() { return [1, 2].map(i => this.name + i).join(","); }
        }
        class Puppy extends Dog {}
        console.log(new Animal("generic").speak());
        var d = new Dog("rex");
        console.log(d.speak(), d.tags());
        console.log(new Puppy("spot").speak(), Dog.family());
        """, None),
    "class_called_without_new": ("class A {} A();", None),
    "extends_non_class": ("var f = 5; class B extends f {}", None),
    "duplicate_constructor": (
        "class C { constructor() {} constructor() {} }", None),
    "new_arrow": ("var f = () => {}; new f();", None),
    "new_number": ("new 5();", None),
    "asi_newline_termination": ("""
        let a = 1
        let b = 2
        console.log(a + b)
        function f() {
            return
        }
        console.log(f() === undefined)
        """, None),
}


def js_run(pkg: str, src: str, fuel):
    interp_m, parser, stdlib = (
        _mod(pkg, "js.interp"), _mod(pkg, "js.parser"), _mod(pkg, "js.stdlib"))
    out: list = []
    try:
        interp = interp_m.Interp(stdlib.new_globals(print_fn=out.append))
        interp.fuel = fuel if fuel is not None else 2_000_000
        interp.run_chunk(parser.parse(src, "case"))
    except Exception as e:
        return {"out": out, "error": _error(e)}
    return {"out": out}


@pytest.mark.parametrize("case", sorted(JS_CASES))
def test_js_cases_run_as_in_the_jax_package(case):
    src, fuel = JS_CASES[case]
    want, got = (js_run(pkg, src, fuel) for pkg in PACKAGES)
    assert got == want
    if "fuel" in case:
        assert got["error"][0] == "JsFuelError"
    if case == "fuel_same_budget":
        assert len(got["out"]) > 5


@pytest.mark.parametrize("lang", ["lua", "js"])
def test_host_values_convert_as_in_the_jax_package(lang):
    """`to_lua`/`to_js` then back, and what a guest sees of them
    (`json.encode` / `JSON.stringify`): floats stay floats."""
    host = {"presence": {"user_id": "u", "session_id": "s"},
            "party_id": "", "string_properties": {"mode": "duel"},
            "numeric_properties": {"rank": 7.0, "skill": 1.5},
            "list": [1, 2.5, None, True, "x"]}
    got = []
    for pkg in PACKAGES:
        stdlib = _mod(pkg, f"{lang}.stdlib")
        to, back = ((stdlib.to_lua, stdlib.from_lua) if lang == "lua"
                    else (stdlib.to_js, stdlib.from_js))
        value = to(host)
        if lang == "lua":
            interp = stdlib.new_interp()
            interp.globals.set("v", value)
            parser = _mod(pkg, "lua.parser")
            text = interp.run_chunk(parser.parse("return json.encode(v)", "c"))
        else:
            interp_m, parser = _mod(pkg, "js.interp"), _mod(pkg, "js.parser")
            interp = interp_m.Interp(stdlib.new_globals())
            interp.globals.vars["v"] = value
            interp.globals.vars["out"] = stdlib.to_js([])
            interp.run_chunk(parser.parse("out.push(JSON.stringify(v));", "c"))
            text = stdlib.from_js(interp.globals.vars["out"])
        got.append((back(value), list(text)))
    assert got[0] == got[1]


# ------------------------------------------------------ loader, registry

PY_MODULE = '''
import json


def init_module(ctx, logger, nk, initializer):
    initializer.register_rpc("py_echo", lambda ctx, p: json.dumps(
        {"payload": p, "user": ctx.user_id, "mode": ctx.execution_mode}))
    initializer.register_before_rt("MatchmakerAdd", lambda ctx, k, b: b)
    initializer.register_after_req("UpdateAccount", lambda c, b, r: None)
    initializer.register_match("py_arena", lambda: None)
    initializer.register_event(lambda ctx, e: None)
    initializer.register_event_session_start(lambda ctx, t: None)
    initializer.register_matchmaker_override(lambda ctx, c: c)
'''

LUA_MODULE = '''
nk.register_rpc(function(ctx, payload)
  return json.encode({payload = payload, user = ctx.user_id})
end, "lua_echo")
nk.register_rt_before(function(ctx, env) return env end, "channel_join")
nk.register_req_before(function(ctx, body) return body end,
                       "WriteLeaderboardRecord")
nk.register_matchmaker_matched(function(ctx, entries)
  return json.encode(entries)
end)
nk.register_tournament_end(function(ctx, lb, t) end)
'''

JS_MODULE = '''
function InitModule(ctx, logger, nk, initializer) {
  initializer.registerRpc("JS_Echo", function(ctx, payload) {
    return JSON.stringify({payload: payload, user: ctx.userId,
                           node: ctx.node});
  });
  initializer.registerRtAfter("MatchDataSend", function(ctx, b) {});
  initializer.registerReqBefore("AuthenticateDevice", function(ctx, b) {
    return b;
  });
  initializer.registerMatch("js_arena", {matchInit: function() {
    return {state: {}, tickRate: 1, label: ""};
  }});
  initializer.registerMatchmakerMatched(function(ctx, entries) {
    return JSON.stringify(entries);
  });
  initializer.registerLeaderboardReset(function(ctx, lb, t) {});
  initializer.registerEventSessionEnd(function(ctx, reason) {});
}
'''


def _module_dir(path, files: dict) -> str:
    path.mkdir()
    for name, text in files.items():
        (path / name).write_text(text)
    return str(path)


def _runtime(pkg, path):
    loader = _mod(pkg, "loader")
    if pkg == "nakama_tpu":
        config, log = JaxConfig(), quiet_logger()
    else:
        config, log = Config(), port_logger()
    config.runtime.path = path
    config.name = "node1"
    return loader.load_runtime(log, config)


def _entries(pkg):
    presence, entry = ((JaxPresence, JaxEntry) if pkg == "nakama_tpu"
                       else (MatchmakerPresence, MatchmakerEntry))
    return [
        entry(f"t{i}", presence(f"u{i}", f"s{i}", f"name{i}"),
              {"mode": "duel", "region": "eu"}, {"rank": 10.0 + i, "w": 1.5},
              party_id="p1" if i else "")
        for i in range(2)
    ]


async def _registry_view(pkg, path):
    rt = _runtime(pkg, path)
    try:
        view = {
            "modules": rt.modules, "rpcs": rt.rpc_ids(),
            "matches": rt.match_names(),
            "keys": [sorted(d) for d in (rt._before_rt, rt._after_rt,
                                         rt._before_req, rt._after_req)],
            "single": [f() is not None for f in (
                rt.matchmaker_matched, rt.matchmaker_override,
                rt.tournament_end, rt.tournament_reset,
                rt.leaderboard_reset)],
            "lists": [len(x) for x in (rt._event_fns, rt._session_start_fns,
                                       rt._session_end_fns, rt._shutdown_fns)],
        }
        ctx = rt.context(mode="rpc", user_id="user-1")
        view["answers"] = {}
        for rid in rt.rpc_ids():
            answer = rt.rpc(rid)(ctx, '{"x": 1}')
            if inspect.iscoroutine(answer):
                answer = await answer
            view["answers"][rid] = answer
        view["matched"] = rt.matchmaker_matched()(_entries(pkg))
        return view
    finally:
        if pkg == "nakama_tpu_torch":
            await rt.close_guests()


@pytest.mark.parametrize("last", ["lua", "js"])
async def test_loader_and_registry_agree_with_the_jax_package(tmp_path, last):
    """Both orders of the Lua and JS files: the last `matchmaker_matched`
    registered is the one kept."""
    names = {"lua": "b_mod.lua", "js": "b_mod.js"}
    names[last] = "c_mod." + last
    files = {"a_mod.py": PY_MODULE, names["lua"]: LUA_MODULE,
             names["js"]: JS_MODULE, "_skipped.py": "raise SystemExit",
             "notes.txt": "not a module"}
    views = [await _registry_view(
        pkg, _module_dir(tmp_path / pkg, files)) for pkg in PACKAGES]
    assert views[0] == views[1]
    got = views[1]
    assert got["modules"] == ["a_mod.py", "b_mod." + ("js" if last == "lua"
                                                      else "lua"),
                              "c_mod." + last]
    assert got["rpcs"] == ["js_echo", "lua_echo", "py_echo"]
    assert got["matches"] == ["js_arena", "py_arena"]
    # What the guest encodes of the entries: every field of both.
    for part in ('"p1"', '"rank": 11', '"w": 1.5', '"s1"'):
        assert part in got["matched"]


@pytest.mark.parametrize("files", [
    {"a.py": "x = 1\n"},
    {"a.py": "raise ValueError('at import')\n"},
    {"a.lua": "this is not lua ==="},
    {"a.lua": "nk.register_rpc(function() end)"},
    {"a.js": "function InitModule(ctx, logger, nk, init) { init.registerRpc("},
    {"a.js": "var x = 1;"},
    {"a.js": "function InitModule() { throw {message: 'no'}; }"},
], ids=["py-no-init", "py-import", "lua-syntax", "lua-no-id", "js-syntax",
        "js-no-init", "js-throws"])
def test_load_errors_read_as_in_the_jax_package(tmp_path, files):
    errors = []
    for pkg in PACKAGES:
        with pytest.raises(Exception) as e:
            _runtime(pkg, _module_dir(tmp_path / pkg, files))
        errors.append(_error(e.value))
    assert errors[0] == errors[1]
    assert errors[1][0] == "ModuleLoadError"


# --------------------------------------------------------------------- nk


def _public(cls) -> set:
    return {n for n, v in inspect.getmembers(cls)
            if not n.startswith("_") and callable(v)}


def test_nk_has_the_jax_public_methods():
    assert _public(NakamaModule) == _public(JaxNakamaModule)
    # 138 methods in the JAX class: these 133, `__init__` and 4 helpers.
    assert len(_public(NakamaModule)) == 133
    for name in _public(NakamaModule):
        assert (inspect.iscoroutinefunction(getattr(NakamaModule, name))
                == inspect.iscoroutinefunction(getattr(JaxNakamaModule, name))
                ), name


NO_COMPONENT = [
    ("authenticate_apple", ("tok",)), ("authenticate_facebook", ("tok",)),
    ("authenticate_facebook_instant_game", ("info",)),
    ("authenticate_game_center", ("p", "b", 1, "s", "sig", "url")),
    ("authenticate_google", ("tok",)), ("authenticate_steam", ("tok",)),
    ("link_apple", ("u", "tok")), ("link_facebook", ("u", "n", "tok")),
    ("link_facebook_instant_game", ("u", "info")),
    ("link_game_center", ("u", "p", "b", 1, "s", "sig", "url")),
    ("link_google", ("u", "tok")), ("link_steam", ("u", "n", "tok")),
    ("purchase_validate_apple", ("u", "r")),
    ("purchase_validate_google", ("u", "r")),
    ("purchase_validate_huawei", ("u", "r")),
    ("purchase_get_by_transaction_id", ("t",)), ("purchases_list", ()),
    ("subscription_validate_apple", ("u", "r")),
    ("subscription_validate_google", ("u", "r")),
    ("subscription_get_by_product_id", ("u", "p")),
    ("subscriptions_list", ("u",)),
    ("wallet_update", ("u", {})), ("friends_list", ("u",)),
    ("match_create", ("arena",)), ("stream_count", ({},)),
    ("metrics_counter_add", ("c", None, 1)), ("event", ("e",)),
    ("account_get_id", ("u",)), ("read_file", ("x",)),
]


@pytest.mark.parametrize("with_db", [False, True])
async def test_nk_fails_as_the_jax_one_without_a_component(with_db):
    """No social client, no purchases, and (with_db False) no database
    or any other component: the same error class and message."""
    errors = []
    for pkg, cls, config, log in (
        ("jax", JaxNakamaModule, JaxConfig(), quiet_logger()),
        ("torch", NakamaModule, Config(), port_logger()),
    ):
        db = (JaxDatabase if pkg == "jax" else Database)(":memory:")
        nk = cls(log, config, db=db if with_db else None)
        seen = []
        for name, args in NO_COMPONENT:
            with pytest.raises(Exception) as e:
                out = getattr(nk, name)(*args)
                if inspect.iscoroutine(out):
                    await out
            seen.append((name, _error(e.value)))
        errors.append(seen)
    assert errors[0] == errors[1]
    assert ("authenticate_apple", ("RuntimeError", "social client not configured"
            if with_db else "database not configured")) in errors[1]
    # Both hand out an unconfigured Satori client that raises on use.
    satori = [NakamaModule(port_logger(), Config()).get_satori(),
              JaxNakamaModule(quiet_logger(), JaxConfig()).get_satori()]
    assert [c.configured for c in satori] == [False, False]
    refused = []
    for client in satori:
        with pytest.raises(Exception) as e:
            await client.flags_list("identity-1")
        refused.append(_error(e.value))
    assert refused[0] == refused[1] == ("SatoriError", "satori is not configured")


async def test_nk_social_unlinks_work_without_a_social_client():
    """The social unlinks need no client: over each package's database,
    the same answers (unlinking a provider the account lacks, and the
    account's last method)."""
    got = []
    for db, cls, config, log in (
        (JaxDatabase(":memory:"), JaxNakamaModule, JaxConfig(), quiet_logger()),
        (Database(":memory:"), NakamaModule, Config(), port_logger()),
    ):
        await db.connect()
        try:
            nk = cls(log, config, db=db)
            uid, _, created = await nk.authenticate_custom("custom-unlink-1")
            seen = [created]
            for name in ("unlink_apple", "unlink_facebook",
                         "unlink_facebook_instant_game", "unlink_game_center",
                         "unlink_google", "unlink_steam", "unlink_custom"):
                try:
                    seen.append((name, await getattr(nk, name)(uid)))
                except Exception as e:
                    seen.append((name, _error(e)))
            got.append(seen)
        finally:
            await db.close()
    assert got[0] == got[1]


async def nk_with_providers(pkg: str) -> list:
    """One package's `nk` over its SQLite engine with a `StubSocialClient`,
    `Purchases` over the stores' fetcher and a Satori client over an
    injected fetcher: what each social, purchase, subscription and Satori
    method answers (user ids and generated usernames named, the clock's
    times masked)."""
    if pkg == "jax":
        from nakama_tpu.core.purchase import Purchases as P
        from nakama_tpu.social import client as social_mod

        db, config, log, cls = JaxDatabase(":memory:"), JaxConfig(), quiet_logger(), JaxNakamaModule
    else:
        from nakama_tpu_torch.core.purchase import Purchases as P
        from nakama_tpu_torch.social import client as social_mod

        db, config, log, cls = Database(":memory:"), Config(), port_logger(), NakamaModule
    F.configure(config)
    config.satori.url = "https://satori.test"
    config.satori.api_key_name = "key-name"
    config.satori.signing_key = "signing-key"
    await db.connect()
    nk = cls(log, config, db=db, social=F.stub_social(social_mod),
             purchases=P(log, db, config, fetch=F.store_fetch()))
    names: dict = {}
    out = []

    def name(v):
        if isinstance(v, dict):
            return {k: "<time>" if k in ("purchase_time", "create_time",
                                         "update_time")
                    and isinstance(x, float) and x > 1.75e9 else name(x)
                    for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [name(x) for x in v]
        return names.get(v, v) if isinstance(v, str) else v

    async def step(label, coro):
        try:
            value = await coro
            if label.startswith("auth") and isinstance(value, tuple):
                names.setdefault(value[0], f"user{len(names)}")
                names.setdefault(value[1], f"name{len(names)}")
        except Exception as e:
            value = _error(e)
        out.append((label, name(value)))
        return value

    try:
        uid, _, _ = await step("auth google", nk.authenticate_google("google-token-0"))
        await step("auth google refused", nk.authenticate_google("bogus"))
        await step("auth apple", nk.authenticate_apple("apple-token-0", "appler"))
        await step("auth facebook", nk.authenticate_facebook("facebook-token-0"))
        await step("auth instant", nk.authenticate_facebook_instant_game(
            F.instant_info("ig-5")))
        gc = F.gamecenter_account("gc-player-0")
        await step("auth game center", nk.authenticate_game_center(
            gc["player_id"], gc["bundle_id"], gc["timestamp_seconds"], gc["salt"],
            gc["signature"], gc["public_key_url"]))
        await step("auth steam", nk.authenticate_steam("steam-token-0"))
        await step("auth steam no create", nk.authenticate_steam(
            "steam-token-3", create=False))
        await step("link apple", nk.link_apple(uid, "apple-token-1"))
        await step("link apple taken", nk.link_apple(uid, "apple-token-0"))
        await step("link facebook", nk.link_facebook(uid, "u", "facebook-token-1"))
        await step("link instant", nk.link_facebook_instant_game(
            uid, F.instant_info("ig-6")))
        await step("link game center", nk.link_game_center(
            uid, "gc-player-1", gc["bundle_id"], 1, "c2FsdA==", "c2ln",
            gc["public_key_url"]))
        await step("link google", nk.link_google(uid, "google-token-1"))
        await step("link steam", nk.link_steam(uid, "u", "steam-token-1"))
        await step("unlink steam", nk.unlink_steam(uid))
        await step("account", nk.account_get_id(uid))
        await step("buy apple", nk.purchase_validate_apple(
            uid, F.apple_receipt(["n1", "n2"])))
        await step("buy apple again", nk.purchase_validate_apple(
            uid, F.apple_receipt(["n1"])))
        await step("buy google", nk.purchase_validate_google(
            uid, F.google_receipt("gems", "n3")))
        await step("buy huawei", nk.purchase_validate_huawei(
            uid, F.huawei_receipt("coins", "n4")))
        await step("buy huawei refused", nk.purchase_validate_huawei(
            uid, F.huawei_receipt("coins", "hw-bad")))
        await step("by txn", nk.purchase_get_by_transaction_id("GPA.n3"))
        await step("purchases", nk.purchases_list(uid, 2))
        await step("sub apple", nk.subscription_validate_apple(
            uid, F.apple_receipt(["ns1"])))
        await step("sub google", nk.subscription_validate_google(
            uid, F.google_receipt("vip", "ns2"), persist=False))
        await step("sub by product", nk.subscription_get_by_product_id(
            uid, "product.ns1"))
        await step("subs", nk.subscriptions_list(uid))
        satori = nk.get_satori()
        satori_calls = []

        async def satori_fetch(url, method="GET", headers=None, body=None):
            satori_calls.append((method, url.split("?")[0]))
            return 200, json.dumps({"url": url}).encode()

        satori._fetch = satori_fetch
        await step("satori flags", satori.flags_list("identity-1", ["a"]))
        await step("satori events", satori.events_publish("identity-1", []))
        out.append(("satori", (satori.configured, satori_calls,
                               nk.get_satori() is satori)))
    finally:
        await db.close()
    return out


async def test_nk_social_purchase_and_satori_methods_agree():
    want = await nk_with_providers("jax")
    got = await nk_with_providers("torch")
    assert got == want
    steps = dict(got)
    assert steps["auth google"][2] is True
    assert steps["auth google refused"] == ["AuthError", "invalid google token"]
    assert [p["seen_before"] for p in steps["buy apple again"]] == [True]
    assert steps["satori"][0] is True and steps["satori"][2] is True


# ------------------------------------------------------------- override

OVERRIDE_MODULE = '''
def init_module(ctx, logger, nk, initializer):
    def override(ctx, candidates):
        """The closest ranks first; a ticket in one group only."""
        def spread(c):
            ranks = [e.numeric_properties["rank"] for e in c]
            return (max(ranks) - min(ranks),
                    sorted(e.presence.session_id for e in c))
        chosen, taken = [], set()
        for c in sorted(candidates, key=spread):
            ids = {e.ticket for e in c}
            if not ids & taken and ctx.execution_mode == "matchmaker_override":
                chosen.append(c)
                taken |= ids
        return chosen

    initializer.register_matchmaker_override(override)
'''


def _override_groups(pkg, path, n_tickets: int):
    rt = _runtime(pkg, path)
    cfg_kw = dict(pool_capacity=256, max_intervals=3, interval_sec=1)
    if pkg == "nakama_tpu":
        mm = JaxLocal(quiet_logger(), JaxMatchmakerConfig(
            **cfg_kw, backend="cpu"))
        presence = JaxPresence
    else:
        cfg = MatchmakerConfig(**cfg_kw)
        mm = LocalMatchmaker(port_logger(), cfg, backend=CudaBackend(
            cfg, port_logger(), device="cpu"))
        presence = MatchmakerPresence
    mm.override_fn = rt.matchmaker_override()
    got = []
    mm.on_matched = lambda batch: got.extend(
        sorted(e.presence.session_id for e in entries) for entries in batch)
    rng = np.random.default_rng(21)
    for i in range(n_tickets):
        mode = ("a", "b")[int(rng.integers(0, 2))]
        size = int(rng.choice([2, 2, 3]))
        mm.add([presence(f"u{i}", f"s{i:02d}", f"n{i}")], f"s{i:02d}", "",
               f"+properties.mode:{mode}", 2, size,
               string_properties={"mode": mode},
               numeric_properties={"rank": float(rng.integers(0, 50))})
    for _ in range(3):
        mm.process()
    mm.stop()
    return sorted(got)


def test_matchmaker_override_picks_the_same_groups(tmp_path):
    groups = [_override_groups(
        pkg, _module_dir(tmp_path / pkg, {"override.py": OVERRIDE_MODULE}), 24)
        for pkg in PACKAGES]
    assert groups[0] == groups[1]
    assert len(groups[1]) >= 4


# ------------------------------------------------------------- scheduler

SCHEDULER_MODULE = '''
FIRED = []


def init_module(ctx, logger, nk, initializer):
    for kind in ("leaderboard_reset", "tournament_reset", "tournament_end"):
        getattr(initializer, "register_" + kind)(
            lambda ctx, board, when, kind=kind: FIRED.append(
                (kind, ctx.execution_mode, board, when)))
'''


def _masked(obj):
    if isinstance(obj, dict):
        return {k: "<time>" if k in ("create_time", "update_time")
                else _masked(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_masked(v) for v in obj]
    return obj


async def _scheduler_fires(pkg, path, now: float, fire_at: float):
    import sys

    if pkg == "nakama_tpu":
        db, lbs, ts, cache, sched, log = (
            JaxDatabase(":memory:"), JaxLeaderboards, JaxTournaments,
            JaxRankCache, JaxScheduler, quiet_logger())
    else:
        db, lbs, ts, cache, sched, log = (
            Database(":memory:"), Leaderboards, Tournaments,
            LeaderboardRankCache, LeaderboardScheduler, port_logger())
    await db.connect()
    try:
        rt = _runtime(pkg, path)
        fired = sys.modules["nakama_runtime_sched"].FIRED
        fired.clear()
        lb = lbs(log, db, cache())
        t = ts(lb)
        await lb.create("daily", reset_schedule="0 0 * * *")
        await t.create("weekly", duration=86_400 * 7,
                       reset_schedule="0 0 * * *", start_time=now - 100)
        await t.create("closing", duration=3600, start_time=now - 100,
                       end_time=now + 30)
        for i, score in enumerate((5, 9, 9, 1)):
            await lb.record_write("daily", f"owner-{i}", f"name{i}", score, i)
            await t.record_write("weekly", f"owner-{i}", f"name{i}", score)
            await t.record_write("closing", f"owner-{i}", f"name{i}", -score)
        scheduler = sched(log, lb, t, rt)
        await scheduler._fire(fire_at)
        await scheduler._fire(fire_at + 1)  # nothing fires twice
        return _masked(sorted(fired, key=lambda f: (f[0], f[2]["id"])))
    finally:
        await db.close()


async def test_scheduler_hooks_get_the_same_payloads(tmp_path):
    now = time.time()
    # The fake clock: just past the next midnight, after the closing
    # tournament's end.
    fire_at = jax_cron.parse("0 0 * * *").next(now) + 0.5
    fires = [await _scheduler_fires(
        pkg, _module_dir(tmp_path / pkg, {"sched.py": SCHEDULER_MODULE}),
        now, fire_at) for pkg in PACKAGES]
    assert fires[0] == fires[1]
    assert [(f[0], f[1], f[2]["id"]) for f in fires[1]] == [
        ("leaderboard_reset", "reset", "daily"),
        ("tournament_end", "end", "closing"),
        ("tournament_reset", "reset", "weekly"),
    ]
    assert all(len(f[2]["standings"]) == 4 for f in fires[1])
