"""Match registry: the live match directory.

Parity with the reference MatchRegistry (reference server/match_registry.go:
87-893): create authoritative matches from registered match-core factories,
track relayed matches implicitly, list with label queries (the reference
indexes labels in Bluge, :151-225 — we flatten label JSON into documents and
reuse the matchmaker query language), route join attempts into the match
task with a timeout, route data, signal, and drain gracefully on shutdown.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Any, Callable

from ..config import MatchConfig
from ..logger import Logger
from ..matchmaker.query import QueryError, evaluate, parse_query
from ..metrics import Metrics
from ..realtime import Presence
from .core import MatchMessage
from .handler import MatchHandler


class MatchError(Exception):
    pass


class LocalMatchRegistry:
    def __init__(
        self,
        logger: Logger,
        config: MatchConfig,
        router,
        node: str = "local",
        metrics: Metrics | None = None,
        tracker=None,
    ):
        self.logger = logger.with_fields(subsystem="match_registry")
        self.config = config
        self.router = router
        self.node = node
        self.tracker = tracker
        self.metrics = metrics
        self._handlers: dict[str, MatchHandler] = {}
        self._factories: dict[str, Callable[[], Any]] = {}
        self._stopped = False

    # ----------------------------------------------------------- factories

    def register(self, name: str, factory: Callable[[], Any]):
        """Register a named match-core factory (the reference's runtime match
        creation functions, server/runtime.go:1124)."""
        self._factories[name.lower()] = factory

    # ------------------------------------------------------------ creation

    def create_match(self, handler_name: str, params: dict | None = None) -> str:
        """Spawn an authoritative match (reference CreateMatch,
        match_registry.go:227)."""
        if self._stopped:
            raise MatchError("shutting down")
        factory = self._factories.get(handler_name.lower())
        if factory is None:
            raise MatchError(f"unknown match handler: {handler_name}")
        # Thread-agnostic (guest nk.match_create runs on a module worker
        # thread): match_init executes inline on the caller — guest
        # module locks are reentrant per-thread — and the tick task
        # schedules onto the server loop.
        try:
            loop = asyncio.get_running_loop()
            self.loop = loop
        except RuntimeError:
            loop = getattr(self, "loop", None)
            if loop is None or not loop.is_running():
                raise MatchError("no event loop available for match tasks")
        match_id = f"{uuid.uuid4()}.{self.node}"
        core = factory()
        handler = MatchHandler(
            self.logger,
            self.config,
            self,
            self.router,
            match_id,
            self.node,
            core,
            params or {},
            tracker=self.tracker,
        )
        handler.create_time = time.time()
        self._handlers[match_id] = handler
        handler.start(loop)
        if self.metrics:
            self.metrics.matches.set(len(self._handlers))
        return match_id

    def remove(self, match_id: str):
        self._handlers.pop(match_id, None)
        if self.metrics:
            self.metrics.matches.set(len(self._handlers))

    def get(self, match_id: str) -> MatchHandler | None:
        return self._handlers.get(match_id)

    def __len__(self) -> int:
        return len(self._handlers)

    # ------------------------------------------------------------- listing

    def _label_doc(self, handler: MatchHandler) -> dict:
        doc: dict[str, Any] = {"label": handler.label}
        try:
            data = json.loads(handler.label)
        except (ValueError, TypeError):
            data = None
        if isinstance(data, dict):
            _flatten("label", data, doc)
        doc["size"] = float(len(handler.presences))
        doc["tick_rate"] = float(handler.tick_rate)
        return doc

    def list_matches(
        self,
        limit: int = 10,
        label: str | None = None,
        min_size: int | None = None,
        max_size: int | None = None,
        query: str | None = None,
    ) -> list[dict]:
        """Reference ListMatches (match_registry.go:415-). Query strings use
        the matchmaker query language over flattened label JSON."""
        parsed = None
        if query:
            try:
                parsed = parse_query(query)
            except QueryError as e:
                raise MatchError(f"invalid match listing query: {e}") from e
        out = []
        for handler in self._handlers.values():
            size = len(handler.presences)
            if label is not None and handler.label != label:
                continue
            if min_size is not None and size < min_size:
                continue
            if max_size is not None and size > max_size:
                continue
            if parsed is not None:
                if evaluate(parsed, self._label_doc(handler)) is None:
                    continue
            out.append(
                {
                    "match_id": handler.match_id,
                    "authoritative": True,
                    "label": handler.label,
                    "size": size,
                    "tick_rate": handler.tick_rate,
                }
            )
            if len(out) >= limit:
                break
        return out

    # ---------------------------------------------------------- operations

    async def join_attempt(
        self,
        match_id: str,
        presence: Presence,
        metadata: dict | None = None,
    ) -> tuple[bool, str, MatchHandler | None]:
        handler = self._handlers.get(match_id)
        if handler is None:
            return False, "match not found", None
        allow, reason = await handler.join_attempt(presence, metadata or {})
        return allow, reason, handler

    async def join(self, match_id: str, presences: list[Presence]):
        handler = self._handlers.get(match_id)
        if handler is not None:
            await handler.join(presences)

    async def leave(self, match_id: str, presences: list[Presence]):
        handler = self._handlers.get(match_id)
        if handler is not None:
            await handler.leave(presences)

    def send_data(
        self,
        match_id: str,
        sender: Presence,
        op_code: int,
        data: bytes,
        reliable: bool = True,
    ) -> bool:
        handler = self._handlers.get(match_id)
        if handler is None:
            return False
        return handler.queue_data(
            MatchMessage(
                sender=sender,
                op_code=op_code,
                data=data,
                reliable=reliable,
                receive_time_ms=int(time.time() * 1000),
            )
        )

    async def signal(self, match_id: str, data: str) -> str:
        handler = self._handlers.get(match_id)
        if handler is None:
            raise MatchError("match not found")
        return await handler.signal(data)

    def get_state(self, match_id: str) -> tuple[str, int, int] | None:
        """(state json, tick, presence count) for the console."""
        handler = self._handlers.get(match_id)
        if handler is None:
            return None
        return handler.get_state_json(), handler.tick, len(handler.presences)

    async def stop_all(self, grace_seconds: int = 0):
        """Graceful drain (reference Stop, main.go:209-240). All matches
        share one grace window, draining concurrently like the reference."""
        import asyncio

        self._stopped = True
        handlers = list(self._handlers.values())
        if handlers:
            results = await asyncio.gather(
                *(h.stop(grace_seconds) for h in handlers),
                return_exceptions=True,
            )
            for handler, result in zip(handlers, results):
                if isinstance(result, BaseException):
                    self.logger.error(
                        "match drain error",
                        match_id=handler.match_id,
                        error=str(result),
                    )

    # ------------------------------------------------------------ listeners

    def join_listener(self):
        """Tracker listener for MATCH_AUTHORITATIVE streams (reference
        main.go:153): completed stream joins/leaves feed the match task."""
        import asyncio

        # asyncio keeps only weak refs to tasks; retain them until done or a
        # delivery task can be collected mid-flight and silently dropped.
        tasks: set[asyncio.Task] = set()

        def _spawn(loop, coro):
            task = loop.create_task(coro)
            tasks.add(task)
            task.add_done_callback(tasks.discard)

        def on_event(joins: list[Presence], leaves: list[Presence]):
            by_match_j: dict[str, list[Presence]] = {}
            by_match_l: dict[str, list[Presence]] = {}
            for p in joins:
                by_match_j.setdefault(p.stream.subject, []).append(p)
            for p in leaves:
                by_match_l.setdefault(p.stream.subject, []).append(p)
            loop = asyncio.get_running_loop()
            for match_id, ps in by_match_j.items():
                _spawn(loop, self.join(match_id, ps))
            for match_id, ps in by_match_l.items():
                _spawn(loop, self.leave(match_id, ps))

        return on_event


def _flatten(prefix: str, data: dict, out: dict):
    for k, v in data.items():
        key = f"{prefix}.{k}"
        if isinstance(v, dict):
            _flatten(key, v, out)
        elif isinstance(v, bool):
            out[key] = "T" if v else "F"
        elif isinstance(v, (int, float)):
            out[key] = float(v)
        elif isinstance(v, str):
            out[key] = v
