"""The port's match engine and parties (`nakama_tpu_torch/match/`, the
pipeline's `match_*` and `party_*` handlers) held against the JAX
package's: the same envelope script from four captured sessions runs
through each package's `Pipeline` over its own tracker, router,
`LocalMatchRegistry`, `LocalPartyRegistry` and `LocalMatchmaker` (the
port's on `CudaBackend(device="cpu")`), with a copy of the JAX tests'
`ScriptedMatch` registered by name. Compared: every envelope each
session received (relayed and authoritative joins, data relays and the
match loop's echoes, rejects, errors, party membership, join requests,
leader changes and party data), tick counts, labels, `list_matches`
under label queries, signals, `stop_all`, and the party tickets in each
matchmaker.

Ticks are driven by the test (`MatchHandler._loop_once`), not by the
wall clock, so the counts are exact: in both packages the match task
serves its call queue only.

One test drives the port's own tick task (`MatchHandler._run`) on the
wall clock: a player's join queued while the task catches up on late
ticks reaches the match before that player's data.

Stated tolerance: none — every compared value must be equal."""

import asyncio
import base64
import json
import time

import pytest

from fixtures import FakeSession, quiet_logger

from nakama_tpu import config as jax_config
from nakama_tpu.api import pipeline as jax_pipeline
from nakama_tpu.api import session_token as jax_token
from nakama_tpu.match import LocalMatchRegistry as JaxMatchRegistry
from nakama_tpu.match import LocalPartyRegistry as JaxPartyRegistry
from nakama_tpu.match import handler as jax_handler
from nakama_tpu.matchmaker import LocalMatchmaker as JaxMatchmaker
from nakama_tpu.realtime import LocalMessageRouter as JaxRouter
from nakama_tpu.realtime import LocalSessionRegistry as JaxSessions
from nakama_tpu.realtime import LocalTracker as JaxTracker
from nakama_tpu.realtime import StreamMode as JaxStreamMode
from nakama_tpu_torch import config as port_config
from nakama_tpu_torch.api import pipeline as port_pipeline
from nakama_tpu_torch.api import session_token as port_token
from nakama_tpu_torch.logger import test_logger as port_logger
from nakama_tpu_torch.match import LocalMatchRegistry, LocalPartyRegistry
from nakama_tpu_torch.match import handler as port_handler
from nakama_tpu_torch.match.core import MatchMessage
from nakama_tpu_torch.matchmaker import LocalMatchmaker
from nakama_tpu_torch.matchmaker.cuda import CudaBackend
from nakama_tpu_torch.realtime import (
    LocalMessageRouter,
    LocalSessionRegistry,
    LocalTracker,
    Presence,
    PresenceID,
    PresenceMeta,
    Stream,
    StreamMode,
)


class ScriptedMatch:
    """A copy of `tests/test_match_engine.py::ScriptedMatch`: counts
    ticks, echoes data with op_code + 1, rejects users named 'badguy',
    ends on the signal "end", and relabels on "relabel"."""

    def match_init(self, ctx, params):
        return (
            {"ticks": 0, "echoed": 0, "end": False},
            params.get("tick_rate", 30),
            json.dumps({"mode": params.get("mode", "demo"), "skill": 7}),
        )

    def match_join_attempt(self, ctx, dispatcher, tick, state, presence, md):
        if presence.meta.username == "badguy":
            return state, False, "banned"
        return state, True, ""

    def match_join(self, ctx, dispatcher, tick, state, presences):
        return state

    def match_leave(self, ctx, dispatcher, tick, state, presences):
        return state

    def match_loop(self, ctx, dispatcher, tick, state, messages):
        state["ticks"] += 1
        for m in messages:
            state["echoed"] += 1
            dispatcher.broadcast_message(m.op_code + 1, m.data, sender=m.sender)
        if state["end"]:
            return None
        return state

    def match_terminate(self, ctx, dispatcher, tick, state, grace):
        state["terminated"] = True
        return state

    def match_signal(self, ctx, dispatcher, tick, state, data):
        if data == "end":
            state["end"] = True
        if data == "relabel":
            dispatcher.match_label_update(
                json.dumps({"mode": "casual", "skill": 9}))
        return state, f"ack:{data}"


async def _calls_only(self):
    """The match task without its clock: calls are served as they
    arrive, ticks come from `_tick`."""
    try:
        while not self.stopped:
            call = await self._calls.get()
            await call()
    except asyncio.CancelledError:
        pass
    finally:
        self.registry.remove(self.match_id)


def _tick(handler, n=1):
    for _ in range(n):
        if not handler._loop_once():
            handler._task.cancel()
            return


class Rig:
    """One package's components behind its pipeline."""

    def __init__(self, name):
        if name == "jax":
            cfg = jax_config.Config()
            cfg.matchmaker.backend = "cpu"
            log = quiet_logger()
            self.sessions = JaxSessions(log)
            self.tracker = JaxTracker(log, cfg.name)
            router = JaxRouter(log, self.sessions, self.tracker)
            self.matchmaker = JaxMatchmaker(log, cfg.matchmaker)
            mreg, preg, mode = JaxMatchRegistry, JaxPartyRegistry, JaxStreamMode
            pipe, self.token = jax_pipeline, jax_token
        else:
            cfg = port_config.Config()
            cfg.matchmaker.pool_capacity = 2048
            log = port_logger()
            self.sessions = LocalSessionRegistry(log)
            self.tracker = LocalTracker(log, cfg.name)
            router = LocalMessageRouter(log, self.sessions, self.tracker)
            self.matchmaker = LocalMatchmaker(
                log, cfg.matchmaker, backend=CudaBackend(
                    cfg.matchmaker, log, device="cpu", row_block=8,
                    col_block=64, big_row_block=8, big_col_block=64))
            mreg, preg, mode = LocalMatchRegistry, LocalPartyRegistry, StreamMode
            pipe, self.token = port_pipeline, port_token
        self.config = cfg
        self.matches = mreg(log, cfg.match, router, cfg.name, tracker=self.tracker)
        self.matches.register("scripted", ScriptedMatch)
        self.tracker.add_listener(mode.MATCH_AUTHORITATIVE,
                                  self.matches.join_listener())
        self.parties = preg(log, self.tracker, router, self.matchmaker, cfg.name)
        self.tracker.add_listener(mode.PARTY, self.parties.join_listener())
        self.pipeline = pipe.Pipeline(log, pipe.Components(
            config=cfg, tracker=self.tracker, router=router,
            status_registry=None, matchmaker=self.matchmaker,
            match_registry=self.matches, party_registry=self.parties,
            session_registry=self.sessions,
        ))
        self.clients = {}
        for sid, uid, uname in (("sa", "ua", "alice"), ("sb", "ub", "bob"),
                                ("sc", "uc", "carol"), ("sd", "ud", "badguy")):
            self.clients[uid] = FakeSession(sid, uid, uname)
            self.sessions.add(self.clients[uid])
        self.ids: dict[str, str] = {}

    def norm(self, obj):
        if isinstance(obj, dict):
            return {k: self.norm(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [self.norm(v) for v in obj]
        if isinstance(obj, str):
            return self.ids.get(obj, obj)
        return obj

    def learn(self, value, name):
        self.ids[value] = name

    async def send(self, user, envelope):
        await self.pipeline.process(self.clients[user], envelope)
        await self.tracker.drain()
        await asyncio.sleep(0)

    def last(self, user, key):
        return [e for e in self.clients[user].sent if key in e][-1]


def b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


async def run_script(rig: Rig) -> dict:
    out: dict = {}
    rig.tracker.start()
    try:
        # A relayed match: create, joins, data, a bad payload, leave.
        await rig.send("ua", {"cid": "1", "match_create": {}})
        m1 = rig.last("ua", "match")["match"]["match_id"]
        rig.learn(m1, "match:relayed")
        for user in ("ub", "uc"):
            await rig.send(user, {"cid": "2", "match_join": {"match_id": m1}})
        await rig.send("ua", {"cid": "3", "match_data_send": {
            "match_id": m1, "op_code": 3, "data": b64(b"hi")}})
        await rig.send("ub", {"cid": "4", "match_data_send": {
            "match_id": m1, "op_code": 3, "data": "not base64!"}})
        await rig.send("ud", {"cid": "5", "match_data_send": {
            "match_id": m1, "op_code": 3, "data": b64(b"x")}})
        await rig.send("uc", {"cid": "6", "match_leave": {"match_id": m1}})
        await rig.send("ud", {"cid": "7", "match_join": {"match_id": "nope"}})
        await rig.send("ud", {"cid": "8", "match_leave": {}})
        # The matchmaker's rendezvous token names the relayed match.
        token, _ = rig.token.generate(
            rig.config.session.encryption_key, "ud", "badguy", 30,
            vars={"kind": "match_token", "mid": m1})
        await rig.send("ud", {"cid": "9", "match_join": {"token": token}})
        bad, _ = rig.token.generate(
            rig.config.session.encryption_key, "ud", "badguy", 30,
            vars={"kind": "session"})
        await rig.send("ud", {"cid": "10", "match_join": {"token": bad}})
        await rig.send("ud", {"cid": "11", "match_join": {"token": "x.y.z"}})
        # Authoritative matches by handler name.
        await rig.send("ua", {"cid": "20", "match_create": {
            "name": "scripted", "params": {"mode": "ranked", "tick_rate": 10}}})
        m2 = rig.last("ua", "match")["match"]["match_id"]
        rig.learn(m2, "match:ranked")
        await rig.send("ub", {"cid": "21", "match_create": {"name": "nope"}})
        m3 = rig.matches.create_match("scripted", {"tick_rate": 5})
        rig.learn(m3, "match:demo")
        h2, h3 = rig.matches.get(m2), rig.matches.get(m3)
        _tick(h2, 3)
        for user in ("ub", "ud"):
            await rig.send(user, {"cid": "22", "match_join": {"match_id": m2}})
        await rig.send("uc", {"cid": "23", "match_join": {"match_id": m3}})
        await rig.send("ua", {"cid": "24", "match_data_send": {
            "match_id": m2, "op_code": 7, "data": b64(b"payload")}})
        await rig.send("ub", {"cid": "25", "match_data_send": {
            "match_id": m2, "op_code": 1, "data": b64(b"b")}})
        await rig.send("uc", {"cid": "26", "match_data_send": {
            "match_id": m2, "op_code": 1, "data": b64(b"c")}})
        _tick(h2, 2)
        _tick(h3, 1)
        await asyncio.sleep(0)
        out["ticks"] = [(h.tick, dict(h.state)) for h in (h2, h3)]
        queries = [
            dict(query="+label.mode:ranked"), dict(query="+label.skill:>=5"),
            dict(limit=1), dict(min_size=2), dict(max_size=1),
            dict(label=h3.label), dict(query="+label.mode:casual"),
        ]

        def listing():
            return [
                sorted((rig.norm(m["match_id"]), m["label"], m["size"],
                        m["authoritative"])
                       for m in rig.matches.list_matches(**q))
                for q in queries
            ]

        out["list"] = listing()
        out["signal"] = [await rig.matches.signal(m2, "relabel"),
                         await rig.matches.signal(m3, "end")]
        _tick(h2, 1)
        _tick(h3, 1)
        await asyncio.sleep(0)
        out["after_signal"] = (listing(), h2.label, len(rig.matches),
                               rig.matches.get(m3) is None)
        await rig.send("ub", {"cid": "27", "match_leave": {"match_id": m2}})
        _tick(h2, 1)
        out["presences"] = sorted(p.user_id for p in h2.presences.list())

        # Parties: a closed party with a join request, accept, remove,
        # party matchmaking, data, promote, leave and close.
        await rig.send("ua", {"cid": "30", "party_create": {
            "open": False, "max_size": 4}})
        p1 = rig.last("ua", "party")["party"]["party_id"]
        rig.learn(p1, "party:closed")
        await rig.send("ub", {"cid": "31", "party_join": {"party_id": p1}})
        await rig.send("uc", {"cid": "32", "party_join": {"party_id": p1}})
        await rig.send("ua", {"cid": "33", "party_join_request_list": {
            "party_id": p1}})
        pending = rig.last("ua", "party_join_request")["party_join_request"]
        by_user = {p["user_id"]: p for p in pending["presences"]}
        await rig.send("ub", {"cid": "34", "party_accept": {
            "party_id": p1, "presence": by_user["ub"]}})
        await rig.send("ua", {"cid": "35", "party_accept": {
            "party_id": p1, "presence": by_user["ub"]}})
        await rig.send("ua", {"cid": "36", "party_remove": {
            "party_id": p1, "presence": by_user["uc"]}})
        await rig.send("ua", {"cid": "37", "party_matchmaker_add": {
            "party_id": p1, "min_count": 2, "max_count": 4, "query": "*",
            "string_properties": {"region": "eu"},
            "numeric_properties": {"rank": 5}}})
        ticket = rig.last("ua", "party_matchmaker_ticket")[
            "party_matchmaker_ticket"]["ticket"]
        rig.learn(ticket, "ticket:party")
        t = rig.matchmaker.store.party_tickets(p1)
        out["party_tickets"] = [
            (x.party_id == p1, x.min_count, x.max_count, x.query,
             sorted((e.presence.user_id, e.presence.session_id)
                    for e in x.entries),
             x.string_properties, x.numeric_properties)
            for x in t
        ]
        await rig.send("ub", {"cid": "38", "party_matchmaker_add": {
            "party_id": p1, "min_count": 2, "max_count": 4}})
        await rig.send("ua", {"cid": "39", "party_data_send": {
            "party_id": p1, "op_code": 2, "data": b64(b"go")}})
        await rig.send("ua", {"cid": "40", "party_promote": {
            "party_id": p1, "presence": by_user["ub"]}})
        await rig.send("ub", {"cid": "41", "party_matchmaker_remove": {
            "party_id": p1, "ticket": ticket}})
        await rig.send("ub", {"cid": "42", "party_matchmaker_add": {
            "party_id": p1, "min_count": 2, "max_count": 2}})
        ticket2 = rig.last("ub", "party_matchmaker_ticket")[
            "party_matchmaker_ticket"]["ticket"]
        rig.learn(ticket2, "ticket:party2")
        out["pooled_before_leave"] = len(rig.matchmaker)
        await rig.send("ua", {"cid": "43", "party_leave": {"party_id": p1}})
        out["pooled_after_leave"] = len(rig.matchmaker)
        await rig.send("ud", {"cid": "44", "party_join": {"party_id": "x"}})
        await rig.send("uc", {"cid": "45", "party_create": {"open": True}})
        p2 = rig.last("uc", "party")["party"]["party_id"]
        rig.learn(p2, "party:open")
        await rig.send("ud", {"cid": "46", "party_join": {"party_id": p2}})
        await rig.send("uc", {"cid": "47", "party_close": {"party_id": p2}})
        await rig.send("ub", {"cid": "48", "party_close": {"party_id": p1}})
        out["parties_left"] = len(rig.parties)
        await rig.matches.stop_all(0)
        out["stopped"] = (len(rig.matches), h2.state.get("terminated"))
        out["sent"] = {
            uid: rig.norm(c.sent) for uid, c in rig.clients.items()
        }
    finally:
        rig.tracker.stop()
    return out


async def test_match_and_party_script_same_answers_as_the_jax_package(
        monkeypatch):
    monkeypatch.setattr(jax_handler.MatchHandler, "_run", _calls_only)
    monkeypatch.setattr(port_handler.MatchHandler, "_run", _calls_only)
    want = await run_script(Rig("jax"))
    got = await run_script(Rig("torch"))
    for key in want:
        if key != "sent":
            assert got[key] == want[key], key
    for user in want["sent"]:
        assert got["sent"][user] == want["sent"][user], user
    # The script reached what it means to compare.
    assert want["ticks"][0][1]["echoed"] == 2 and want["ticks"][0][0] == 5
    assert want["party_tickets"] and want["party_tickets"][0][0]
    echoes = [e for e in want["sent"]["ub"]
              if e.get("match_data", {}).get("op_code") == 8]
    assert len(echoes) == 1
    assert want["stopped"] == (0, True)


@pytest.mark.parametrize("name", ["jax", "torch"])
async def test_max_empty_sec_ends_an_empty_match(name, monkeypatch):
    """`match.max_empty_sec`: an authoritative match with nobody in it
    ends after that many seconds of ticks, in both packages."""
    for mod in (jax_handler, port_handler):
        monkeypatch.setattr(mod.MatchHandler, "_run", _calls_only)
    rig = Rig(name)
    rig.config.match.max_empty_sec = 1
    match_id = rig.matches.create_match("scripted", {"tick_rate": 4})
    handler = rig.matches.get(match_id)
    _tick(handler, 3)
    await asyncio.sleep(0)
    assert rig.matches.get(match_id) is handler
    _tick(handler, 1)
    await asyncio.sleep(0)
    assert rig.matches.get(match_id) is None and handler.tick == 4


async def test_a_join_queued_during_late_ticks_applies_before_the_next_tick():
    """The port's tick task after a loop stall: at tick 3 the match loop
    blocks the event loop for 3.5 periods while the player's join is
    queued and its data arrives. The late ticks then run back to back,
    and the join must apply before the tick that reads the data, so the
    echo, addressed to the live presences, reaches the sender."""
    player = Presence(
        PresenceID("node", "s1"),
        Stream(StreamMode.MATCH_AUTHORITATIVE, subject="m.node"), "u1",
        PresenceMeta())
    sent = []

    class Registry:
        def remove(self, match_id):
            pass

    class Router:
        def send_to_presence_ids(self, targets, envelope):
            sent.append(list(targets))

    class StallingEcho:
        seen = []

        def match_init(self, ctx, params):
            return {}, 10, ""

        def match_join(self, ctx, dispatcher, tick, state, presences):
            return state

        def match_loop(self, ctx, dispatcher, tick, state, messages):
            if tick == 3:
                asyncio.get_running_loop().create_task(handler.join([player]))
                time.sleep(0.35)
                handler.queue_data(MatchMessage(player, 1, b"x"))
            for m in messages:
                live = [p for p in handler.presences.list()
                        if p.id == m.sender.id]
                self.seen.append((tick, len(live)))
                dispatcher.broadcast_message(2, m.data, live)
            return state

    handler = port_handler.MatchHandler(
        port_logger(), port_config.MatchConfig(), Registry(), Router(),
        "m.node", "node", StallingEcho(), {})
    handler.start()
    try:
        for _ in range(100):
            await asyncio.sleep(0.02)
            if StallingEcho.seen:
                break
    finally:
        handler.stopped = True
    assert StallingEcho.seen == [(4, 1)]
    assert sent == [[player.id]]
