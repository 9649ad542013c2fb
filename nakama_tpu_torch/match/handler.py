"""Match handler: one asyncio task per authoritative match.

Parity with the reference MatchHandler (reference server/match_handler.go:
101-616): a ticker at the core's tick rate drives MatchLoop with the
messages queued since the last tick; join attempts, joins/leaves, and
signals are serialized through bounded queues onto the same task (the
reference's channel-per-concern pattern, :101-106); deferred broadcasts
flush at end of tick; empty matches auto-terminate after max_empty_sec; join
markers expire un-completed joins.
"""

from __future__ import annotations

import asyncio
import base64
import time
from typing import Any

from ..config import MatchConfig
from ..logger import Logger
from ..realtime import Presence, PresenceID, Stream, StreamMode
from .core import MatchDispatcher, MatchMessage
from .presence import JoinMarkerList, MatchPresenceList


def _resolve(fut: asyncio.Future, value):
    """Resolve a waiter future; the caller's wait_for may have already
    cancelled it (timeout), which must not crash the match task."""
    if not fut.done():
        fut.set_result(value)


class MatchHandler:
    def __init__(
        self,
        logger: Logger,
        config: MatchConfig,
        registry,  # LocalMatchRegistry
        router,
        match_id: str,
        node: str,
        core: Any,
        params: dict,
        label_update=None,
        tracker=None,
    ):
        self.logger = logger.with_fields(subsystem="match", mid=match_id)
        self.config = config
        self.registry = registry
        self.router = router
        self.match_id = match_id
        self.node = node
        self.core = core
        self.tracker = tracker
        self.stream = Stream(StreamMode.MATCH_AUTHORITATIVE, subject=match_id)
        self.presences = MatchPresenceList()
        self.tick = 0
        self.stopped = False
        self._task: asyncio.Task | None = None
        self._input: asyncio.Queue[MatchMessage] = asyncio.Queue(
            maxsize=config.input_queue_size
        )
        self._calls: asyncio.Queue = asyncio.Queue(
            maxsize=config.call_queue_size
        )
        self._deferred: list[tuple[list[PresenceID] | None, dict]] = []
        self._pending_kicks: list[Presence] = []
        self._empty_ticks = 0

        self.ctx = {
            "match_id": match_id,
            "node": node,
            "match_params": params,
        }
        self.dispatcher = MatchDispatcher(self)
        state, tick_rate, label = core.match_init(self.ctx, params)
        if state is None:
            raise ValueError("match_init returned no state")
        if not (1 <= int(tick_rate) <= 60):
            raise ValueError("tick rate must be 1..60")
        self.state = state
        self.tick_rate = int(tick_rate)
        self.label = label or ""
        self._label_update = label_update
        self.join_markers = JoinMarkerList(
            config.join_marker_deadline_ms, self.tick_rate
        )

    # ------------------------------------------------------------ lifecycle

    def start(self, loop: asyncio.AbstractEventLoop | None = None):
        """Spawn the tick task. Callable off-loop (guest nk.match_create
        runs match_init on a module worker thread): the task is then
        scheduled onto the given loop thread-safely."""
        if loop is None:
            loop = asyncio.get_running_loop()
        try:
            on_loop = asyncio.get_running_loop() is loop
        except RuntimeError:
            on_loop = False
        if on_loop:
            self._task = loop.create_task(self._run())
        else:
            loop.call_soon_threadsafe(
                lambda: setattr(
                    self, "_task", loop.create_task(self._run())
                )
            )

    async def _run(self):
        """The match goroutine equivalent (reference match_handler.go:179)."""
        period = 1.0 / self.tick_rate
        next_tick = time.monotonic() + period
        try:
            while not self.stopped:
                timeout = max(0.0, next_tick - time.monotonic())
                try:
                    call = await asyncio.wait_for(
                        self._calls.get(), timeout=timeout
                    )
                    await call()
                    continue
                except asyncio.TimeoutError:
                    pass
                # Calls queued before this tick (a presence's join, a
                # leave) apply before it, also while late ticks are
                # caught up back to back after a loop stall: there the
                # zero-timeout wait above never serves a call, so a
                # player's data could reach match_loop before its join.
                while not self.stopped and not self._calls.empty():
                    await self._calls.get_nowait()()
                if self.stopped:
                    break
                next_tick += period
                if not self._loop_once():
                    break
        except asyncio.CancelledError:
            pass
        except Exception as e:
            self.logger.error("match loop crashed", error=str(e))
        finally:
            self.registry.remove(self.match_id)

    def _loop_once(self) -> bool:
        # Kick expired join reservations (match_presence.go join markers).
        expired = self.join_markers.clear_expired(self.tick)
        if expired:
            leaves = [
                p
                for p in self.presences.list()
                if p.id.session_id in expired
            ]
            if leaves:
                self._apply_leaves(leaves)

        messages: list[MatchMessage] = []
        while True:
            try:
                messages.append(self._input.get_nowait())
            except asyncio.QueueEmpty:
                break

        try:
            new_state = self.core.match_loop(
                self.ctx, self.dispatcher, self.tick, self.state, messages
            )
        except Exception as e:
            self.logger.error("match_loop error, ending match", error=str(e))
            new_state = None
        self.tick += 1
        if new_state is None:
            # Still honour kicks from the final tick so match_leave and
            # stream untrack run before the match dies.
            self._drain_kicks()
            self._flush_deferred()
            self.stopped = True
            return False
        self.state = new_state
        # Kicks requested by the core during match_loop apply only now, so
        # match_leave's state return isn't clobbered by match_loop's
        # (reference defers dispatcher kicks to end of tick).
        self._drain_kicks()
        self._flush_deferred()

        # Empty-match auto-termination (match_handler.go:160).
        if self.config.max_empty_sec > 0:
            if len(self.presences) == 0 and len(self.join_markers) == 0:
                self._empty_ticks += 1
                if self._empty_ticks >= (
                    self.config.max_empty_sec * self.tick_rate
                ):
                    self.logger.debug("match empty too long, terminating")
                    self.stopped = True
                    return False
            else:
                self._empty_ticks = 0
        return True

    async def stop(self, grace_seconds: int = 0):
        """Graceful termination (reference match_handler Terminate)."""

        async def call():
            try:
                state = self.core.match_terminate(
                    self.ctx,
                    self.dispatcher,
                    self.tick,
                    self.state,
                    grace_seconds,
                )
                if state is not None:
                    self.state = state
            finally:
                self._drain_kicks()
                self._flush_deferred()
                self.stopped = True

        await self._enqueue_call(call)
        if self._task is not None:
            try:
                await asyncio.wait_for(
                    self._task, timeout=grace_seconds + 1.0
                )
            except asyncio.TimeoutError:
                self._task.cancel()

    # -------------------------------------------------------- call queueing

    async def _enqueue_call(self, call) -> bool:
        if self.stopped:
            return False
        try:
            self._calls.put_nowait(call)
            return True
        except asyncio.QueueFull:
            return False

    async def join_attempt(
        self, presence: Presence, metadata: dict, timeout_sec: float = 10.0
    ) -> tuple[bool, str]:
        """Serialized join attempt with timeout (reference
        match_registry.go:696-758)."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()

        async def call():
            if self.presences.contains(presence.id):
                _resolve(fut, (True, ""))
                return
            try:
                state, allow, reason = self.core.match_join_attempt(
                    self.ctx,
                    self.dispatcher,
                    self.tick,
                    self.state,
                    presence,
                    metadata,
                )
            except Exception as e:
                self._drain_kicks()
                self._flush_deferred()
                _resolve(fut, (False, str(e)))
                return
            if state is not None:
                self.state = state
            if allow:
                self.join_markers.add(presence.id.session_id, self.tick)
            self._drain_kicks()
            self._flush_deferred()
            _resolve(fut, (bool(allow), reason or ""))

        if not await self._enqueue_call(call):
            return False, "match call queue full"
        try:
            return await asyncio.wait_for(fut, timeout=timeout_sec)
        except asyncio.TimeoutError:
            return False, "join attempt timed out"

    async def join(self, presences: list[Presence]):
        async def call():
            joined = self.presences.join(presences)
            if not joined:
                return
            for p in joined:
                self.join_markers.mark(p.id.session_id)
            try:
                state = self.core.match_join(
                    self.ctx, self.dispatcher, self.tick, self.state, joined
                )
                if state is not None:
                    self.state = state
            except Exception as e:
                self.logger.error("match_join error", error=str(e))
            self._drain_kicks()
            self._flush_deferred()

        await self._enqueue_call(call)

    async def leave(self, presences: list[Presence]):
        async def call():
            self._apply_leaves(presences)

        await self._enqueue_call(call)

    def _apply_leaves(self, presences: list[Presence]):
        left = self.presences.leave(presences)
        if not left:
            return
        if self.tracker is not None:
            # Kicked/expired presences must also leave the match stream or
            # the session can still send data and can never cleanly rejoin.
            for p in left:
                self.tracker.untrack(p.id.session_id, self.stream)
        try:
            state = self.core.match_leave(
                self.ctx, self.dispatcher, self.tick, self.state, left
            )
            if state is not None:
                self.state = state
        except Exception as e:
            self.logger.error("match_leave error", error=str(e))
        self._flush_deferred()

    async def signal(self, data: str, timeout_sec: float = 10.0) -> str:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()

        async def call():
            try:
                state, reply = self.core.match_signal(
                    self.ctx, self.dispatcher, self.tick, self.state, data
                )
                if state is not None:
                    self.state = state
                _resolve(fut, reply or "")
            except Exception as e:
                if not fut.done():
                    fut.set_exception(e)
                else:
                    # Waiter already timed out — don't lose the core error.
                    self.logger.error(
                        "match signal error after timeout",
                        match_id=self.match_id,
                        error=str(e),
                    )
            self._drain_kicks()
            self._flush_deferred()

        if not await self._enqueue_call(call):
            raise RuntimeError("match signal queue full")
        return await asyncio.wait_for(fut, timeout=timeout_sec)

    def queue_data(self, message: MatchMessage) -> bool:
        """Client → match data (reference inputCh, match_handler.go:101)."""
        if self.stopped:
            return False
        try:
            self._input.put_nowait(message)
            return True
        except asyncio.QueueFull:
            self.logger.warn("match input queue full, dropping data")
            return False

    # ----------------------------------------------------------- dispatch

    def broadcast(
        self,
        op_code: int,
        data: bytes | str,
        presences: list[Presence] | None,
        sender: Presence | None,
        reliable: bool,
    ):
        # Bytes fields ride the JSON envelope as base64 text (proto3
        # JSON mapping of rtapi MatchData.data) — the protobuf-mode
        # socket bridge base64-decodes this back to raw bytes.
        if isinstance(data, str):
            raw = data.encode("utf-8")
        elif isinstance(data, (bytes, bytearray)):
            raw = bytes(data)
        else:
            raise TypeError(
                "broadcast data must be bytes or str, got"
                f" {type(data).__name__}"
            )
        payload = base64.b64encode(raw).decode("ascii")
        envelope: dict = {
            "match_data": {
                "match_id": self.match_id,
                "op_code": op_code,
                "data": payload,
                "reliable": reliable,
            }
        }
        if sender is not None:
            envelope["match_data"]["presence"] = sender.as_dict()
        targets = (
            [p.id for p in presences] if presences is not None else None
        )
        self._deferred.append((targets, envelope))

    def kick(self, presences: list[Presence]):
        # Deferred until the in-flight core callback returns and its state is
        # committed; applying immediately would run match_leave re-entrantly
        # with stale state.
        self._pending_kicks.extend(presences)

    def _drain_kicks(self):
        while self._pending_kicks:
            batch, self._pending_kicks = self._pending_kicks, []
            self._apply_leaves(batch)

    def update_label(self, label: str):
        self.label = label
        if self._label_update is not None:
            self._label_update(self.match_id, label)

    def _flush_deferred(self):
        deferred, self._deferred = self._deferred, []
        for targets, envelope in deferred:
            if targets is None:
                targets = self.presences.presence_ids()
            self.router.send_to_presence_ids(targets, envelope)

    def get_state_json(self) -> str:
        import json

        try:
            return json.dumps(self.state, default=str)
        except TypeError:
            return str(self.state)
