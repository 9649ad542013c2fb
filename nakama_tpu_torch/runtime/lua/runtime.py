"""Lua module provider — wires guest Lua code into the hook registry.

Mirrors the reference's Lua provider shape (reference
server/runtime_lua.go: modules run at startup and register hooks through
the `nakama` module): a ``*.lua`` file under ``config.runtime.path``
executes at load with a global ``nk`` table; registrations adapt guest
functions onto the SAME Initializer the Python provider uses, so the
pipeline/server sees one hook registry regardless of language.

Threading model: guest invocations run on ONE dedicated worker thread
per module (the reference sizes a VM pool; one VM is the subset here) —
async `nk` calls bridge back to the server's event loop with
run_coroutine_threadsafe and block only the worker. At module LOAD time
the chunk runs on the caller's thread; async `nk` calls there would
deadlock the loop and instead raise a clear error (register in the
chunk, do I/O in handlers — the reference's own guidance).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
import uuid

from .interp import Interp, LuaError, LuaRuntimeError, LuaTable
from .stdlib import from_lua, new_globals, to_lua

INVOKE_TIMEOUT_SEC = 30.0
FUEL_PER_INVOCATION = 2_000_000

# nk facade methods exposed to Lua (reference runtime_lua_nakama.go
# surface, mapped onto runtime/nk.py). Async ones bridge to the event
# loop from the guest worker thread.
ASYNC_NK = (
    "authenticate_device", "authenticate_email", "authenticate_custom",
    "account_get_id", "accounts_get_id", "account_update_id",
    "account_delete_id", "users_get_id", "users_get_username",
    "link_device", "unlink_device", "link_email", "unlink_email",
    "link_custom", "unlink_custom",
    "storage_read", "storage_write", "storage_delete", "storage_list",
    "wallet_update", "wallets_update", "wallet_ledger_list",
    "multi_update",
    "notification_send", "notifications_send", "notification_send_all",
    "match_signal",
    "leaderboard_create", "leaderboard_delete",
    "leaderboard_record_write", "leaderboard_records_list",
    "leaderboard_record_delete",
    "tournament_create", "tournament_delete", "tournament_join",
    "tournament_record_write",
    "friends_list", "friends_add", "friends_delete", "friends_block",
    "group_create", "group_update", "group_delete", "groups_get_id",
    "group_users_list", "group_users_add", "group_users_kick",
    "user_groups_list", "channel_message_send",
)
SYNC_NK = (
    "authenticate_token_generate",
    "stream_user_list", "stream_user_join", "stream_user_leave",
    "stream_send", "stream_count",
    "match_create", "match_get", "match_list", "channel_id_build",
    "event", "metrics_counter_add", "metrics_gauge_set",
    "metrics_timer_record",
    "base64_encode", "base64_decode", "sha256_hash",
    "hmac_sha256_hash",
)
# Methods whose **kwargs accept an options table as the final Lua arg.
KWARGS_TAIL = frozenset(
    {
        "account_update_id", "leaderboard_create",
        "leaderboard_records_list", "tournament_create",
        "friends_list", "group_create", "group_update",
        "group_users_list", "user_groups_list", "match_list",
        "storage_list", "wallet_ledger_list",
    }
)


class LuaModule:
    """One loaded .lua module: interpreter + worker thread + nk bridge."""

    def __init__(self, name: str, source: str, logger, nk, initializer):
        self.name = name
        self.logger = logger.with_fields(lua_module=name)
        self.nk = nk
        self.initializer = initializer
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"lua-{name}"
        )
        self._lock = threading.RLock()  # guest code can re-enter (an
        # rpc calling nk.matchCreate runs the guest matchInit)
        self._depth = threading.local()
        self._no_async = threading.local()
        self._loop: asyncio.AbstractEventLoop | None = None
        self.globals = new_globals(
            print_fn=lambda text: self.logger.info("lua print", text=text)
        )
        self.interp = Interp(self.globals)
        self.globals.set("nk", self._build_nk_table())
        from .parser import parse

        chunk = parse(source, chunk=name)
        self.interp.fuel = FUEL_PER_INVOCATION
        self.interp.run_chunk(chunk)

    # ----------------------------------------------------------- invoking

    def _invoke(self, fn, args: tuple, no_async: bool = False):
        """Call a guest function with a fresh fuel budget (serialized:
        one interpreter state). `no_async`: this invocation runs on (or
        blocks) the event-loop thread, so the async nk bridge must fail
        fast with a truthful error instead of deadlocking toward its
        timeout. The lock acquire is bounded for the same reason."""
        if not self._lock.acquire(timeout=INVOKE_TIMEOUT_SEC):
            raise LuaRuntimeError(
                f"lua module {self.name} busy for >"
                f"{INVOKE_TIMEOUT_SEC:.0f}s (a guest hook is likely"
                " blocked on an async nakama call from a sync context)"
            )
        depth = getattr(self._depth, "n", 0)
        self._depth.n = depth + 1
        prev_no_async = getattr(self._no_async, "flag", False)
        try:
            self._no_async.flag = no_async or prev_no_async
            if depth == 0:  # nested invocations share the outer budget
                self.interp.fuel = FUEL_PER_INVOCATION
            return self.interp.call(fn, args)
        finally:
            self._no_async.flag = prev_no_async
            self._depth.n = depth
            self._lock.release()

    def _call_sync(self, name, py_args, kwargs):
        """Sync nk calls are loop-affine (match_create spawns tasks,
        stream ops mutate loop-owned registries): from the module worker
        thread they hop onto the event loop; on the loop (module load,
        sync hooks) they run inline."""
        fn = getattr(self.nk, name)
        if name.startswith("match_"):
            # Match ops are thread-agnostic (create_match runs
            # match_init inline and schedules its task thread-safely) —
            # and MUST stay on this thread: hopping to the loop while a
            # guest invocation holds the module lock would deadlock a
            # guest-registered match core's match_init.
            return fn(*py_args, **kwargs)
        try:
            asyncio.get_running_loop()
            on_loop = True
        except RuntimeError:
            on_loop = False
        if on_loop or self._loop is None or not self._loop.is_running():
            return fn(*py_args, **kwargs)

        async def run():
            return fn(*py_args, **kwargs)

        return asyncio.run_coroutine_threadsafe(
            run(), self._loop
        ).result(INVOKE_TIMEOUT_SEC)

    def _await(self, coro):
        """Bridge an async nk call from the Lua worker thread."""
        if getattr(self._no_async, "flag", False):
            # Synchronous hook contexts (matchmaker_matched, scheduler
            # callbacks) run guest code while the event loop waits on
            # the result; bridging back to the loop here would deadlock
            # toward the timeout. Fail fast and truthfully.
            coro.close()
            raise LuaRuntimeError(
                "async nakama calls are not available in synchronous"
                " hooks (matchmaker_matched/scheduler); use an rpc or"
                " rt hook"
            )
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            pass
        else:
            # On a loop thread (module load time): blocking here would
            # deadlock the loop.
            coro.close()
            raise LuaRuntimeError(
                "async nakama calls are only available inside handlers,"
                " not at module load time"
            )
        if self._loop is not None and self._loop.is_running():
            return asyncio.run_coroutine_threadsafe(
                coro, self._loop
            ).result(INVOKE_TIMEOUT_SEC)
        return asyncio.run(coro)

    def _ctx_table(self, ctx) -> LuaTable:
        t = LuaTable()
        for attr in (
            "user_id", "username", "session_id", "mode", "node",
        ):
            value = getattr(ctx, attr, None)
            if value:
                t.set(attr, to_lua(value))
        vars_ = getattr(ctx, "vars", None)
        if vars_:
            t.set("vars", to_lua(dict(vars_)))
        return t

    def _session_ctx(self, ctx) -> LuaTable:
        # rt hooks receive a RuntimeContext (registry.before_rt wraps the
        # session), whose session id attribute is session_id.
        t = LuaTable()
        t.set("user_id", getattr(ctx, "user_id", ""))
        t.set("username", getattr(ctx, "username", ""))
        t.set(
            "session_id",
            getattr(ctx, "session_id", "") or getattr(ctx, "id", ""),
        )
        return t

    # --------------------------------------------------------- nk bridge

    def _build_nk_table(self) -> LuaTable:
        nk_t = LuaTable()
        module = self

        def reg(name, fn):
            nk_t.set(name, fn)

        # ---- registrations (guest fn first, like the reference Lua API)
        def _register(kind):
            def do_register(interp, fn=None, key=None):
                if fn is None:
                    raise LuaRuntimeError(f"register_{kind}: function required")
                module._register_hook(kind, fn, key)

            return do_register

        for kind in (
            "rpc", "rt_before", "rt_after", "req_before", "req_after",
            "matchmaker_matched", "tournament_end", "tournament_reset",
            "leaderboard_reset", "shutdown", "event",
            "event_session_start", "event_session_end",
        ):
            reg(f"register_{kind}", _register(kind))

        # ---- logger
        for level in ("debug", "info", "warn", "error"):
            def make_log(level=level):
                def log(interp, msg=None, *rest):
                    getattr(module.logger, level)(
                        str(msg) if msg is not None else ""
                    )

                return log

            reg(f"logger_{level}", make_log())

        # ---- pure helpers
        reg("uuid_v4", lambda interp: str(uuid.uuid4()))
        reg("time", lambda interp: float(time.time() * 1000))

        # ---- nk facade calls, generically bridged. Positional Lua args
        # convert via from_lua; for **kwargs-style facade methods
        # (KWARGS_TAIL) a trailing table splats into keyword arguments —
        # mirroring the reference Lua API's options-table convention.
        def _convert_args(name, args):
            py_args = [from_lua(a) for a in args]
            kwargs = {}
            if name in KWARGS_TAIL and py_args and isinstance(
                py_args[-1], dict
            ):
                kwargs = py_args.pop()
            return py_args, kwargs

        def _convert_out(out):
            # A Python tuple is Lua MULTIPLE RETURNS (e.g. authenticate_*
            # returning (user_id, username, created)), not one table.
            if isinstance(out, tuple):
                return tuple(to_lua(v) for v in out)
            return to_lua(out)

        def async_fn(name):
            def call(interp, *args):
                py_args, kwargs = _convert_args(name, args)
                coro = getattr(module.nk, name)(*py_args, **kwargs)
                return _convert_out(module._await(coro))

            return call

        def sync_fn(name):
            def call(interp, *args):
                py_args, kwargs = _convert_args(name, args)
                return _convert_out(
                    module._call_sync(name, py_args, kwargs)
                )

            return call

        for name in ASYNC_NK:
            reg(name, async_fn(name))
        for name in SYNC_NK:
            reg(name, sync_fn(name))

        # Byte-oriented helpers: guest strings are BYTE strings (latin-1
        # on the boundary, matching to_lua's bytes mapping) — without
        # this, binary data decoded from base64 would re-encode via the
        # facade's UTF-8 default and corrupt round-trips/digests.
        def bytes_fn(name):
            def call(interp, *args):
                py_args = [
                    a.encode("latin-1") if isinstance(a, str) else
                    from_lua(a)
                    for a in args
                ]
                return _convert_out(getattr(module.nk, name)(*py_args))

            return call

        for name in (
            "base64_encode", "base64_decode", "sha256_hash",
            "hmac_sha256_hash",
        ):
            reg(name, bytes_fn(name))

        # nil-tolerant stream helpers (guest convention: nil stream/data
        # mean empty — the pre-generic wrappers coerced and modules rely
        # on it).
        def _stream_send(interp, stream=None, data=None, reliable=True):
            module.nk.stream_send(
                from_lua(stream) or {},
                str(data) if data is not None else "",
                bool(reliable),
            )

        reg("stream_send", _stream_send)
        reg(
            "stream_count",
            lambda interp, stream=None: float(
                module.nk.stream_count(from_lua(stream) or {})
            ),
        )

        return nk_t

    # ------------------------------------------------------ hook adapters

    def _register_hook(self, kind: str, fn, key):
        init = self.initializer
        key_str = str(key).lower() if key is not None else None

        if kind == "rpc":
            if not key_str:
                raise LuaRuntimeError("register_rpc: id required")

            async def rpc_wrapper(ctx, payload, _fn=fn):
                loop = asyncio.get_running_loop()
                self._loop = loop
                out = await loop.run_in_executor(
                    self._pool,
                    self._invoke,
                    _fn,
                    (self._ctx_table(ctx), payload),
                )
                result = out[0] if out else None
                if result is None:
                    return ""
                if not isinstance(result, str):
                    raise LuaError(
                        "lua rpc must return a string (use json.encode)"
                    )
                return result

            init.register_rpc(key_str, rpc_wrapper)
        elif kind in ("rt_before", "rt_after"):
            if not key_str:
                raise LuaRuntimeError(f"register_{kind}: message required")

            if kind == "rt_before":

                async def before_wrapper(session, key2, body, _fn=fn):
                    loop = asyncio.get_running_loop()
                    self._loop = loop
                    out = await loop.run_in_executor(
                        self._pool,
                        self._invoke,
                        _fn,
                        (self._session_ctx(session), to_lua(body)),
                    )
                    result = out[0] if out else None
                    if result is None:
                        return None  # rejection, like the reference
                    return from_lua(result)

                init.register_before_rt(key_str, before_wrapper)
            else:

                async def after_wrapper(session, key2, body, _fn=fn):
                    loop = asyncio.get_running_loop()
                    self._loop = loop
                    await loop.run_in_executor(
                        self._pool,
                        self._invoke,
                        _fn,
                        (self._session_ctx(session), to_lua(body)),
                    )

                init.register_after_rt(key_str, after_wrapper)
        elif kind in ("req_before", "req_after"):
            if not key_str:
                raise LuaRuntimeError(f"register_{kind}: method required")

            if kind == "req_before":

                async def req_before(ctx, body, _fn=fn):
                    loop = asyncio.get_running_loop()
                    self._loop = loop
                    out = await loop.run_in_executor(
                        self._pool,
                        self._invoke,
                        _fn,
                        (self._ctx_table(ctx), to_lua(body)),
                    )
                    result = out[0] if out else None
                    return None if result is None else from_lua(result)

                init.register_before_req(key_str, req_before)
            else:

                async def req_after(ctx, body, result, _fn=fn):
                    loop = asyncio.get_running_loop()
                    self._loop = loop
                    await loop.run_in_executor(
                        self._pool,
                        self._invoke,
                        _fn,
                        (
                            self._ctx_table(ctx),
                            to_lua(body),
                            to_lua(result),
                        ),
                    )

                init.register_after_req(key_str, req_after)
        elif kind == "matchmaker_matched":

            # Registry adapter calls user code as (ctx, entries)
            # (registry.matchmaker_matched).
            def matched_wrapper(ctx, entries, _fn=fn):
                # Called synchronously from the matchmaker tail, which
                # may be the event-loop thread: run inline with the
                # no-async flag (the bridge fails fast instead of
                # deadlocking) and a bounded lock acquire. Guest time
                # here blocks the interval — bounded by the fuel budget,
                # and matched hooks are return-an-id lookups by design.
                lua_entries = to_lua(
                    [
                        {
                            "presence": e.presence.as_dict(),
                            "party_id": e.party_id,
                            "string_properties": e.string_properties,
                            "numeric_properties": e.numeric_properties,
                        }
                        for e in entries
                    ]
                )
                # Guest signature (ctx, entries) — reference Lua API
                # (runtime_lua_nakama.go matchmaker_matched).
                out = self._invoke(
                    _fn, (self._ctx_table(ctx), lua_entries), no_async=True
                )
                result = out[0] if out else None
                return str(result) if result else ""

            init.register_matchmaker_matched(matched_wrapper)
        elif kind in (
            "tournament_end", "tournament_reset", "leaderboard_reset",
            "event", "event_session_start", "event_session_end",
            "shutdown",
        ):

            def generic_wrapper(*args, _fn=fn):
                lua_args = tuple(
                    to_lua(a) if isinstance(a, (dict, list, str, int, float,
                                                bool, type(None)))
                    else self._ctx_table(a)
                    for a in args
                )
                # Scheduler/event callers may be sync on the loop
                # thread — same no-async posture as matched_wrapper.
                return self._invoke(_fn, lua_args, no_async=True)

            getattr(init, {
                "tournament_end": "register_tournament_end",
                "tournament_reset": "register_tournament_reset",
                "leaderboard_reset": "register_leaderboard_reset",
                "event": "register_event",
                "event_session_start": "register_event_session_start",
                "event_session_end": "register_event_session_end",
                "shutdown": "register_shutdown",
            }[kind])(generic_wrapper)
        else:  # pragma: no cover
            raise LuaRuntimeError(f"unknown registration {kind}")


def load_lua_module(name, source, logger, nk, initializer) -> LuaModule:
    from .lexer import LuaSyntaxError

    try:
        return LuaModule(name, source, logger, nk, initializer)
    except (LuaError, LuaSyntaxError) as e:
        from ..loader import ModuleLoadError

        raise ModuleLoadError(f"lua module {name}: {e}") from e
