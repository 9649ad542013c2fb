"""Extensibility runtime: hook registry + initializer.

Parity with the reference Runtime struct (reference server/runtime.go:493,
NewRuntime :619): a registry of user-registered functions — per-message
before/after realtime hooks, per-method before/after request hooks, named
RPC functions, matchmaker matched/override, tournament end/reset,
leaderboard reset, purchase/subscription notification callbacks, and
session start/end events. The reference merges three providers (Go
plugins, Lua VMs, goja JS — runtime_go.go / runtime_lua.go /
runtime_javascript.go); here Python modules export
``init_module(ctx, logger, nk, initializer)`` and register through the
``Initializer`` exactly the way Go modules use ``runtime.Initializer``,
and the Lua and JS providers (`runtime/lua`, `runtime/js`) adapt guest
registrations onto the same ``Initializer``.

The port's copy of the JAX package's `runtime/registry.py`. One
addition: `shutdown()` ends with `close_guests()`, which stops the
worker thread of every Lua and JS module the loader loaded
(`guest_modules`); the JAX runtime leaves those threads to the
interpreter's exit.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Callable


class RuntimeError_(Exception):
    """Raised for registration-time misuse (bad names, duplicates)."""


@dataclass
class RuntimeContext:
    """Call context handed to every user function (reference
    server/runtime_go_context.go NewRuntimeGoContext: env, node, headers,
    user/session identity, lang, expiry)."""

    node: str = ""
    env: dict[str, str] = field(default_factory=dict)
    execution_mode: str = ""  # rpc | before | after | match | event | ...
    user_id: str = ""
    username: str = ""
    session_id: str = ""
    expiry: int = 0
    vars: dict[str, str] = field(default_factory=dict)
    client_ip: str = ""
    client_port: str = ""
    headers: dict[str, str] = field(default_factory=dict)
    query_params: dict[str, list[str]] = field(default_factory=dict)
    extra: dict[str, Any] = field(default_factory=dict)


class Initializer:
    """What ``init_module`` receives; mirrors the registration surface of
    the reference's runtime.Initializer (vendored nakama-common
    runtime/runtime.go) without the Go ceremony."""

    def __init__(self, runtime: "Runtime"):
        self._r = runtime

    # -------------------------------------------------------------- rpc
    def register_rpc(self, id: str, fn: Callable):
        rpc_id = (id or "").strip().lower()
        if not rpc_id:
            raise RuntimeError_("rpc id required")
        self._r._rpc[rpc_id] = fn

    # ------------------------------------------------- realtime hooks
    def register_before_rt(self, message: str, fn: Callable):
        self._r._before_rt[_rt_key(message)] = fn

    def register_after_rt(self, message: str, fn: Callable):
        self._r._after_rt[_rt_key(message)] = fn

    # -------------------------------------------------- request hooks
    def register_before_req(self, method: str, fn: Callable):
        self._r._before_req[_req_key(method)] = fn

    def register_after_req(self, method: str, fn: Callable):
        self._r._after_req[_req_key(method)] = fn

    # ------------------------------------------------------ matchmaker
    def register_matchmaker_matched(self, fn: Callable):
        """fn(ctx, entries) -> match id string ('' → token rendezvous)
        (reference runtime.go:3298 MatchmakerMatched)."""
        self._r._matchmaker_matched = fn

    def register_matchmaker_override(self, fn: Callable):
        """fn(ctx, candidate_matches) -> matches to form (reference
        matchmakerOverrideFunction, runtime.go:505)."""
        self._r._matchmaker_override = fn

    # ----------------------------------------------------------- match
    def register_match(self, name: str, factory: Callable):
        """factory() -> MatchCore instance; name usable in match_create
        and nk.match_create (reference RegisterMatch)."""
        if not name:
            raise RuntimeError_("match name required")
        self._r._match_factories[name] = factory

    # ----------------------------------------- tournaments/leaderboards
    def register_tournament_end(self, fn: Callable):
        self._r._tournament_end = fn

    def register_tournament_reset(self, fn: Callable):
        self._r._tournament_reset = fn

    def register_leaderboard_reset(self, fn: Callable):
        self._r._leaderboard_reset = fn

    # ------------------------------------------------------------- iap
    def register_purchase_notification_apple(self, fn: Callable):
        self._r._purchase_notifications["apple"] = fn

    def register_purchase_notification_google(self, fn: Callable):
        self._r._purchase_notifications["google"] = fn

    def register_subscription_notification_apple(self, fn: Callable):
        self._r._subscription_notifications["apple"] = fn

    def register_subscription_notification_google(self, fn: Callable):
        self._r._subscription_notifications["google"] = fn

    # ---------------------------------------------------------- events
    def register_event(self, fn: Callable):
        """fn(ctx, event) — custom events from nk.event() and API /event
        (reference RuntimeEventCustomFunction)."""
        self._r._event_fns.append(fn)

    def register_event_session_start(self, fn: Callable):
        self._r._session_start_fns.append(fn)

    def register_event_session_end(self, fn: Callable):
        self._r._session_end_fns.append(fn)

    # ---------------------------------------------------------- shutdown
    def register_shutdown(self, fn: Callable):
        self._r._shutdown_fns.append(fn)


class Runtime:
    """The hook registry queried by the pipeline, the API layer, the
    matchmaker, and the schedulers (reference server/runtime.go:493 struct
    + getter methods :3200-3340)."""

    def __init__(
        self,
        logger,
        config,
        nk=None,
        node: str = "",
    ):
        self.logger = logger.with_fields(subsystem="runtime")
        self.config = config
        self.nk = nk
        self.node = node or getattr(config, "name", "")
        env = {}
        rc = getattr(config, "runtime", None)
        if rc is not None:
            env = dict(rc.env or {})
        self.env = env

        self._rpc: dict[str, Callable] = {}
        self._before_rt: dict[str, Callable] = {}
        self._after_rt: dict[str, Callable] = {}
        self._before_req: dict[str, Callable] = {}
        self._after_req: dict[str, Callable] = {}
        self._matchmaker_matched: Callable | None = None
        self._matchmaker_override: Callable | None = None
        self._match_factories: dict[str, Callable] = {}
        self._tournament_end: Callable | None = None
        self._tournament_reset: Callable | None = None
        self._leaderboard_reset: Callable | None = None
        self._purchase_notifications: dict[str, Callable] = {}
        self._subscription_notifications: dict[str, Callable] = {}
        self._event_fns: list[Callable] = []
        self._session_start_fns: list[Callable] = []
        self._session_end_fns: list[Callable] = []
        self._shutdown_fns: list[Callable] = []
        self.modules: list[str] = []
        # Loaded Lua/JS modules (loader.py), each with its worker thread.
        self.guest_modules: list = []
        self._event_queue: asyncio.Queue | None = None
        self._event_workers: list[asyncio.Task] = []

    # ------------------------------------------------------------ getters
    # (shape matched to what api/pipeline.py and matchmaker_events.py call)

    def rpc(self, id: str) -> Callable | None:
        return self._rpc.get((id or "").lower())

    def rpc_ids(self) -> list[str]:
        return sorted(self._rpc)

    def before_rt(self, key: str) -> Callable | None:
        fn = self._before_rt.get(key)
        if fn is None:
            return None

        def wrapped(session, k, body, _fn=fn):
            return _fn(self.session_context(session, mode="before"), k, body)

        return wrapped

    def after_rt(self, key: str) -> Callable | None:
        fn = self._after_rt.get(key)
        if fn is None:
            return None

        def wrapped(session, k, body, _fn=fn):
            return _fn(self.session_context(session, mode="after"), k, body)

        return wrapped

    def before_req(self, method: str) -> Callable | None:
        return self._before_req.get(_req_key(method))

    def after_req(self, method: str) -> Callable | None:
        return self._after_req.get(_req_key(method))

    def matchmaker_matched(self) -> Callable | None:
        """Adapter: the matched-event router calls hook(entries)
        (api/matchmaker_events.py:37-40); user code receives
        (ctx, entries) like the reference's (ctx, nk, logger, entries)."""
        fn = self._matchmaker_matched
        if fn is None:
            return None

        def wrapped(entries, _fn=fn):
            return _fn(self.context(mode="matchmaker"), entries)

        return wrapped

    def matchmaker_override(self) -> Callable | None:
        """Adapter to the matchmaker's OverrideFn shape
        (matchmaker/process.py process_custom: fn(candidates) -> chosen)."""
        fn = self._matchmaker_override
        if fn is None:
            return None

        def wrapped(candidates, _fn=fn):
            return _fn(self.context(mode="matchmaker_override"), candidates)

        return wrapped

    def match_factory(self, name: str) -> Callable | None:
        return self._match_factories.get(name)

    def match_names(self) -> list[str]:
        return sorted(self._match_factories)

    def tournament_end(self) -> Callable | None:
        return self._tournament_end

    def tournament_reset(self) -> Callable | None:
        return self._tournament_reset

    def leaderboard_reset(self) -> Callable | None:
        return self._leaderboard_reset

    def purchase_notification(self, store: str) -> Callable | None:
        return self._purchase_notifications.get(store)

    def subscription_notification(self, store: str) -> Callable | None:
        return self._subscription_notifications.get(store)

    # ------------------------------------------------------------ contexts

    def context(self, mode: str = "", **extra) -> RuntimeContext:
        return RuntimeContext(
            node=self.node, env=dict(self.env), execution_mode=mode, **extra
        )

    def session_context(self, session, mode: str = "rpc") -> RuntimeContext:
        return RuntimeContext(
            node=self.node,
            env=dict(self.env),
            execution_mode=mode,
            user_id=getattr(session, "user_id", ""),
            username=getattr(session, "username", ""),
            session_id=getattr(session, "id", ""),
            expiry=int(getattr(session, "expiry", 0) or 0),
            vars=dict(getattr(session, "vars", {}) or {}),
        )

    # -------------------------------------------------------------- events
    # Reference RuntimeEventQueue (server/runtime_event.go:23): a bounded
    # queue drained by worker goroutines so user event code never blocks
    # the caller.

    def start_events(self):
        rc = getattr(self.config, "runtime", None)
        size = getattr(rc, "event_queue_size", 65_536)
        workers = getattr(rc, "event_queue_workers", 8)
        self._event_queue = asyncio.Queue(maxsize=size)
        self._event_workers = [
            asyncio.get_running_loop().create_task(self._event_worker())
            for _ in range(max(1, workers))
        ]

    async def _event_worker(self):
        while True:
            fns, ctx, payload = await self._event_queue.get()
            for fn in fns:
                try:
                    result = fn(ctx, payload)
                    if asyncio.iscoroutine(result):
                        await result
                except Exception as e:
                    self.logger.error("event fn error", error=str(e))

    def _enqueue(self, fns, ctx, payload) -> bool:
        if not fns:
            return True
        if self._event_queue is None:
            # Synchronous fallback when the queue isn't started (tests,
            # non-async callers): run inline, coroutine results scheduled.
            for fn in fns:
                try:
                    result = fn(ctx, payload)
                    if asyncio.iscoroutine(result):
                        asyncio.ensure_future(result)
                except Exception as e:
                    self.logger.error("event fn error", error=str(e))
            return True
        try:
            self._event_queue.put_nowait((fns, ctx, payload))
            return True
        except asyncio.QueueFull:
            self.logger.error("event queue full, dropping event")
            return False

    def fire_event(self, ctx: RuntimeContext, event: dict):
        self._enqueue(list(self._event_fns), ctx, event)

    def fire_session_start(self, session):
        ctx = self.session_context(session, mode="session_start")
        self._enqueue(list(self._session_start_fns), ctx, int(time.time()))

    def fire_session_end(self, session, reason: str = ""):
        ctx = self.session_context(session, mode="session_end")
        self._enqueue(list(self._session_end_fns), ctx, reason)

    async def shutdown(self):
        # Drain queued events before stopping the workers: session-end
        # events fired by the server's own shutdown (it closes every live
        # session just before calling here) must still reach user code.
        if self._event_queue is not None:
            while not self._event_queue.empty():
                fns, ctx, payload = self._event_queue.get_nowait()
                for fn in fns:
                    try:
                        result = fn(ctx, payload)
                        if asyncio.iscoroutine(result):
                            await result
                    except Exception as e:
                        self.logger.error("event fn error", error=str(e))
        for task in self._event_workers:
            task.cancel()
        self._event_workers = []
        self._event_queue = None
        for fn in self._shutdown_fns:
            try:
                result = fn(self.context(mode="shutdown"))
                if asyncio.iscoroutine(result):
                    await result
            except Exception as e:
                self.logger.error("shutdown fn error", error=str(e))
        await self.close_guests()

    async def close_guests(self):
        """Stop each guest module's worker thread, off the loop: a worker
        still finishing a call may need the loop to return."""
        modules, self.guest_modules = self.guest_modules, []
        for module in modules:
            await asyncio.to_thread(module._pool.shutdown, True)


def _rt_key(message: str) -> str:
    """Normalize a realtime message name to the envelope key used by the
    pipeline ('MatchmakerAdd' / 'matchmaker_add' → 'matchmaker_add')."""
    name = (message or "").strip()
    if not name:
        raise RuntimeError_("message name required")
    if name != name.lower():
        out = [name[0].lower()]
        for ch in name[1:]:
            if ch.isupper():
                out.append("_")
                out.append(ch.lower())
            else:
                out.append(ch)
        name = "".join(out)
    return name


def _req_key(method: str) -> str:
    """Normalize an API method name ('AuthenticateDevice' →
    'authenticatedevice') the way the reference keys REQ hooks by
    lowercased method name (server/runtime.go api id constants)."""
    name = (method or "").strip().lower().replace("_", "")
    if not name:
        raise RuntimeError_("method name required")
    return name
