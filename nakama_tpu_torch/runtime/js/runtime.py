"""JS module provider — guest language #3, wired into the same hook
registry as the Python and Lua providers.

Mirrors the reference's JS provider shape (reference
server/runtime_javascript.go: a goja VM evaluates the bundle, then calls
the module's ``InitModule(ctx, logger, nk, initializer)``): a ``*.js``
file under ``config.runtime.path`` is evaluated at load, its
``InitModule`` runs with reference-style camelCase API objects
(``initializer.registerRpc``, ``nk.storageWrite``...), and every
registration adapts the guest function onto the SAME Initializer the
Python/Lua providers use.

Threading model matches the Lua provider (runtime/lua/runtime.py): one
dedicated worker thread per module; async nk calls bridge to the event
loop with run_coroutine_threadsafe; sync hook contexts set a no-async
flag so the bridge fails fast instead of deadlocking.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import re
import threading
import time
import uuid

from .interp import (
    UNDEFINED,
    Env,
    Interp,
    JsAbortError,
    JsError,
    JsRuntimeError,
    JsThrow,
    JSObject,
)
from .stdlib import from_js, js_to_string, new_globals, to_js

INVOKE_TIMEOUT_SEC = 30.0
FUEL_PER_INVOCATION = 2_000_000

# Same facade surface as the Lua bridge (runtime/lua/runtime.py), plus
# the nk methods it lacks; exposed to JS in camelCase like the
# reference's runtime_javascript_nakama.go.
ASYNC_NK = (
    "authenticate_device", "authenticate_email", "authenticate_custom",
    "account_get_id", "accounts_get_id", "account_update_id",
    "account_delete_id", "account_export_id",
    "users_get_id", "users_get_username", "users_get_random",
    "users_ban_id", "users_unban_id",
    "link_device", "unlink_device", "link_email", "unlink_email",
    "link_custom", "unlink_custom",
    "storage_read", "storage_write", "storage_delete", "storage_list",
    "wallet_update", "wallets_update", "wallet_ledger_list",
    "wallet_ledger_update", "multi_update",
    "notification_send", "notifications_send", "notification_send_all",
    "notifications_delete", "match_signal",
    "leaderboard_create", "leaderboard_delete",
    "leaderboard_record_write", "leaderboard_records_list",
    "leaderboard_record_delete", "leaderboard_records_haystack",
    "tournament_create", "tournament_delete", "tournament_join",
    "tournament_record_write", "tournament_records_list",
    "tournament_record_delete", "tournament_add_attempt",
    "tournament_records_haystack",
    "friends_list", "friends_add", "friends_delete", "friends_block",
    "group_create", "group_update", "group_delete", "groups_get_id",
    "groups_list", "groups_get_random", "group_users_list",
    "group_users_add", "group_users_kick", "group_users_ban",
    "group_users_promote", "group_users_demote", "group_user_join",
    "group_user_leave", "user_groups_list",
    "channel_message_send", "channel_messages_list",
    "channel_message_update", "channel_message_remove",
    "purchase_get_by_transaction_id", "purchases_list",
    "subscription_get_by_product_id", "subscriptions_list",
    "session_disconnect",
)
SYNC_NK = (
    "authenticate_token_generate", "session_logout",
    "stream_user_list", "stream_user_join", "stream_user_leave",
    "stream_user_get", "stream_user_update", "stream_user_kick",
    "stream_close", "stream_count",
    "match_create", "match_get", "match_list", "channel_id_build",
    "event", "metrics_counter_add", "metrics_gauge_set",
    "metrics_timer_record",
    "base64_encode", "base64_decode", "sha256_hash",
    "hmac_sha256_hash", "uuid_v4", "time_ms", "read_file",
)
KWARGS_TAIL = frozenset(
    {
        "account_update_id", "leaderboard_create",
        "leaderboard_records_list", "tournament_create",
        "friends_list", "group_create", "group_update",
        "group_users_list", "user_groups_list", "match_list",
        "storage_list", "wallet_ledger_list", "groups_list",
        "channel_messages_list", "tournament_records_list",
    }
)

_REGISTRATIONS = {
    "registerRpc": "rpc",
    "registerRtBefore": "rt_before",
    "registerRtAfter": "rt_after",
    "registerReqBefore": "req_before",
    "registerReqAfter": "req_after",
    "registerMatchmakerMatched": "matchmaker_matched",
    "registerTournamentEnd": "tournament_end",
    "registerTournamentReset": "tournament_reset",
    "registerLeaderboardReset": "leaderboard_reset",
    "registerShutdown": "shutdown",
    "registerEvent": "event",
    "registerEventSessionStart": "event_session_start",
    "registerEventSessionEnd": "event_session_end",
}


def _camel(name: str) -> str:
    return re.sub(r"_([a-z0-9])", lambda m: m.group(1).upper(), name)


class JsModule:
    """One loaded .js module: interpreter + worker thread + nk bridge."""

    def __init__(self, name: str, source: str, logger, nk, initializer):
        self.name = name
        self.logger = logger.with_fields(js_module=name)
        self.nk = nk
        self.initializer = initializer
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"js-{name}"
        )
        self._lock = threading.RLock()  # guest code can re-enter (an
        # rpc calling nk.matchCreate runs the guest matchInit)
        self._depth = threading.local()
        self._no_async = threading.local()
        self._loop: asyncio.AbstractEventLoop | None = None
        self.globals = new_globals(
            print_fn=lambda text: self.logger.info("js console", text=text)
        )
        self.interp = Interp(self.globals)
        from .parser import parse

        chunk = parse(source, chunk=name)
        self.interp.fuel = FUEL_PER_INVOCATION
        module_env = Env(self.globals)
        self.interp.exec_block(chunk, module_env)
        init = module_env.vars.get("InitModule")
        if init is None:
            raise JsError(
                "js module must define"
                " InitModule(ctx, logger, nk, initializer)"
            )
        self.interp.call(
            init,
            (
                self._ctx_obj(None),
                self._logger_obj(),
                self._nk_obj(),
                self._initializer_obj(),
            ),
        )

    # ----------------------------------------------------------- invoking

    def _invoke(self, fn, args: tuple, no_async: bool = False):
        if not self._lock.acquire(timeout=INVOKE_TIMEOUT_SEC):
            raise JsRuntimeError(
                f"js module {self.name} busy for >"
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
            try:
                return self.interp.call(fn, args)
            except JsThrow as e:
                raise JsError(
                    f"uncaught js exception: {_throw_text(e.value)}",
                    e.value,
                )
        finally:
            self._no_async.flag = prev_no_async
            self._depth.n = depth
            lost = getattr(self._depth, "lost", 0)
            if lost > 0:
                # _unlocked_wait failed to reacquire: this frame's
                # acquisition is already gone — don't release what the
                # thread no longer owns.
                self._depth.lost = lost - 1
            else:
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

        return self._unlocked_wait(
            asyncio.run_coroutine_threadsafe(run(), self._loop)
        )

    def _unlocked_wait(self, future):
        """Block on a cross-thread future with the module lock released.
        The awaited loop-side work may re-enter guest code (e.g.
        nk.matchSignal fires the match core's matchSignal callback,
        which needs the interpreter); holding the lock across the wait
        would deadlock until the invoke timeout. Semantically this is
        an await point — other hooks may interleave, matching the
        reference's per-concern goja VM pool (runtime_javascript.go),
        where rpc and match code never share a VM at all."""
        held = getattr(self._depth, "n", 0)
        # Snapshot this invocation's fuel: an interleaved hook entering
        # _invoke at thread-local depth 0 resets the shared interp.fuel,
        # which would hand the suspended outer invocation a refill (or a
        # deficit) when it resumes.
        saved_fuel = self.interp.fuel if held else 0
        for _ in range(held):
            self._lock.release()
        try:
            return future.result(INVOKE_TIMEOUT_SEC)
        finally:
            # Only the first reacquire can block (RLock reacquisition by
            # the owner always succeeds). If it times out, record the
            # unowned acquisitions so the enclosing _invoke finallys skip
            # their release() instead of masking this diagnostic with
            # "cannot release un-acquired lock".
            if held:
                if self._lock.acquire(timeout=INVOKE_TIMEOUT_SEC):
                    for _ in range(held - 1):
                        self._lock.acquire()
                    self.interp.fuel = saved_fuel
                else:
                    self._depth.lost = held
                    # JsAbortError: guest catch/finally must NOT run —
                    # this thread no longer owns the module lock, so
                    # executing any further guest code would race the
                    # invocation that does.
                    raise JsAbortError(
                        f"js module {self.name} wedged: could not"
                        " reacquire the module lock after an async"
                        " nakama call"
                    )

    def _await(self, coro):
        if getattr(self._no_async, "flag", False):
            coro.close()
            raise JsRuntimeError(
                "async nakama calls are not available in synchronous"
                " hooks (matchmakerMatched/scheduler); use an rpc or"
                " rt hook"
            )
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            pass
        else:
            coro.close()
            raise JsRuntimeError(
                "async nakama calls are only available inside handlers,"
                " not at module load time"
            )
        if self._loop is not None and self._loop.is_running():
            return self._unlocked_wait(
                asyncio.run_coroutine_threadsafe(coro, self._loop)
            )
        return asyncio.run(coro)

    def _ctx_obj(self, ctx) -> JSObject:
        o = JSObject()
        if ctx is None:
            o.set("mode", "run_once")
            return o
        for attr, key in (
            ("user_id", "userId"), ("username", "username"),
            ("session_id", "sessionId"), ("mode", "mode"),
            ("node", "node"),
        ):
            value = getattr(ctx, attr, None)
            if value:
                o.set(key, to_js(value))
        vars_ = getattr(ctx, "vars", None)
        if vars_:
            o.set("vars", to_js(dict(vars_)))
        return o

    def _session_ctx(self, ctx) -> JSObject:
        # rt hooks receive a RuntimeContext (registry.before_rt wraps the
        # session), whose session id attribute is session_id.
        o = JSObject()
        o.set("userId", getattr(ctx, "user_id", ""))
        o.set("username", getattr(ctx, "username", ""))
        o.set(
            "sessionId",
            getattr(ctx, "session_id", "") or getattr(ctx, "id", ""),
        )
        return o

    def _ctx_obj_dict(self, ctx) -> JSObject:
        """Match-handler contexts are plain dicts ({match_id, node,
        match_params}); camelCase them for the guest."""
        if isinstance(ctx, dict):
            o = JSObject()
            for k, v in ctx.items():
                o.set(_camel(k), to_js(v))
            return o
        return self._ctx_obj(ctx)

    def _dispatcher_obj(self, dispatcher) -> JSObject:
        o = getattr(dispatcher, "_js_obj", None)
        if o is not None:
            return o
        from .stdlib import from_js as _from

        def _resolve(presences):
            """Guest presence dicts -> the handler's LIVE Presence
            objects, matched by session id (guest values never carry
            host references back)."""
            wanted = {
                p.get("session_id", "")
                for p in (_from(presences) or [])
                if isinstance(p, dict)
            }
            live = dispatcher._handler.presences.list()
            return [p for p in live if p.id.session_id in wanted]

        def broadcast(interp, this, op_code=UNDEFINED, data=UNDEFINED,
                      presences=UNDEFINED, sender=UNDEFINED,
                      reliable=True):
            raw = (
                js_to_string(data).encode("latin-1")
                if data is not UNDEFINED
                else b""
            )
            target = None
            if presences is not UNDEFINED and presences is not None:
                target = _resolve(presences)
            dispatcher.broadcast_message(
                int(_from(op_code) or 0), raw, target, None,
                bool(reliable),
            )
            return UNDEFINED

        def kick(interp, this, presences=UNDEFINED):
            if presences is not UNDEFINED and presences is not None:
                dispatcher.match_kick(_resolve(presences))
            return UNDEFINED

        def label_update(interp, this, label=UNDEFINED):
            dispatcher.match_label_update(js_to_string(label))
            return UNDEFINED

        o = JSObject(
            {
                "broadcastMessage": broadcast,
                "matchKick": kick,
                "matchLabelUpdate": label_update,
            }
        )
        dispatcher._js_obj = o
        return o

    def _logger_obj(self) -> JSObject:
        o = JSObject()
        for level in ("debug", "info", "warn", "error"):
            def make(level=level):
                def log(interp, this, msg=UNDEFINED, *rest):
                    getattr(self.logger, level)(js_to_string(msg))
                    return UNDEFINED

                return log

            o.set(level, make())
        return o

    # --------------------------------------------------------- nk bridge

    def _nk_obj(self) -> JSObject:
        nk_o = JSObject()
        module = self

        def _convert_args(name, args):
            py_args = [from_js(a) for a in args]
            kwargs = {}
            if name in KWARGS_TAIL and py_args and isinstance(
                py_args[-1], dict
            ):
                kwargs = py_args.pop()
            return py_args, kwargs

        def _convert_out(out):
            if isinstance(out, tuple):
                return to_js(list(out))  # JS: multiple returns -> array
            return to_js(out)

        def async_fn(name):
            def call(interp, this, *args):
                py_args, kwargs = _convert_args(name, args)
                coro = getattr(module.nk, name)(*py_args, **kwargs)
                try:
                    return _convert_out(module._await(coro))
                except JsError:
                    raise
                except Exception as e:
                    raise JsThrow(JSObject({"message": str(e)}))

            return call

        def sync_fn(name):
            def call(interp, this, *args):
                py_args, kwargs = _convert_args(name, args)
                try:
                    return _convert_out(
                        module._call_sync(name, py_args, kwargs)
                    )
                except JsError:
                    raise
                except Exception as e:
                    raise JsThrow(JSObject({"message": str(e)}))

            return call

        for name in ASYNC_NK:
            nk_o.set(_camel(name), async_fn(name))
        for name in SYNC_NK:
            nk_o.set(_camel(name), sync_fn(name))

        # Byte-boundary helpers (latin-1, like the Lua bridge).
        def bytes_fn(name):
            def call(interp, this, *args):
                py_args = [
                    a.encode("latin-1") if isinstance(a, str) else
                    from_js(a)
                    for a in args
                ]
                try:
                    return _convert_out(getattr(module.nk, name)(*py_args))
                except Exception as e:
                    raise JsThrow(JSObject({"message": str(e)}))

            return call

        for name in (
            "base64_encode", "base64_decode", "sha256_hash",
            "hmac_sha256_hash",
        ):
            nk_o.set(_camel(name), bytes_fn(name))

        def _stream_send(interp, this, stream=UNDEFINED, data=UNDEFINED,
                         reliable=True):
            module.nk.stream_send(
                from_js(stream) or {},
                js_to_string(data) if data is not UNDEFINED else "",
                bool(reliable),
            )
            return UNDEFINED

        nk_o.set("streamSend", _stream_send)
        nk_o.set("uuidv4", lambda interp, this: str(uuid.uuid4()))
        nk_o.set(
            "time", lambda interp, this: float(time.time() * 1000)
        )
        return nk_o

    # ------------------------------------------------------ registrations

    def _initializer_obj(self) -> JSObject:
        o = JSObject()
        for js_name, kind in _REGISTRATIONS.items():
            def make(kind=kind, js_name=js_name):
                def register(interp, this, *args):
                    # registerRpc(id, fn) / registerRtBefore(msg, fn)
                    # take a key first (reference JS API); the rest take
                    # only the function.
                    if kind in (
                        "rpc", "rt_before", "rt_after", "req_before",
                        "req_after",
                    ):
                        if len(args) != 2:
                            raise JsThrow(JSObject({
                                "message": f"{js_name}(id, fn) expected"
                            }))
                        key, fn = args
                    else:
                        if len(args) != 1:
                            raise JsThrow(JSObject({
                                "message": f"{js_name}(fn) expected"
                            }))
                        key, fn = None, args[0]
                    self._register_hook(kind, fn, key)
                    return UNDEFINED

                return register

            o.set(js_name, make())

        def register_match(interp, this, name=UNDEFINED, handler=UNDEFINED):
            """registerMatch(name, {matchInit, matchJoinAttempt, ...}) —
            reference JS match handlers (runtime_javascript.go). Accepts
            the callback object directly or a factory function returning
            one."""
            if name is UNDEFINED or handler is UNDEFINED:
                raise JsThrow(JSObject({
                    "message": "registerMatch(name, handlers) expected"
                }))
            match_name = js_to_string(name)

            def factory(_handler=handler):
                obj = _handler
                if not isinstance(obj, JSObject):
                    obj = self._invoke(_handler, (), no_async=True)
                if not isinstance(obj, JSObject):
                    raise JsError(
                        "registerMatch factory must yield a handler object"
                    )
                return GuestMatchCore(self, obj)

            self.initializer.register_match(match_name, factory)
            return UNDEFINED

        o.set("registerMatch", register_match)
        return o

    def _register_hook(self, kind: str, fn, key):
        init = self.initializer
        # rt/req keys pass through RAW: the registry's _rt_key/_req_key
        # already normalize camelCase ("MatchmakerAdd") and snake_case
        # alike. Only rpc ids are plain lowercase identifiers.
        key_str = None
        if key is not None:
            key_str = (
                js_to_string(key).lower()
                if kind == "rpc"
                else js_to_string(key)
            )

        if kind == "rpc":
            if not key_str:
                raise JsRuntimeError("registerRpc: id required")

            async def rpc_wrapper(ctx, payload, _fn=fn):
                loop = asyncio.get_running_loop()
                self._loop = loop
                out = await loop.run_in_executor(
                    self._pool,
                    self._invoke,
                    _fn,
                    (self._ctx_obj(ctx), payload),
                )
                if out is None or out is UNDEFINED:
                    return ""
                if not isinstance(out, str):
                    raise JsError(
                        "js rpc must return a string"
                        " (use JSON.stringify)"
                    )
                return out

            init.register_rpc(key_str, rpc_wrapper)
        elif kind in ("rt_before", "rt_after"):
            if not key_str:
                raise JsRuntimeError(f"{kind}: message required")
            if kind == "rt_before":

                async def before_wrapper(session, key2, body, _fn=fn):
                    loop = asyncio.get_running_loop()
                    self._loop = loop
                    out = await loop.run_in_executor(
                        self._pool,
                        self._invoke,
                        _fn,
                        (self._session_ctx(session), to_js(body)),
                    )
                    if out is None or out is UNDEFINED:
                        return None
                    return from_js(out)

                init.register_before_rt(key_str, before_wrapper)
            else:

                async def after_wrapper(session, key2, body, _fn=fn):
                    loop = asyncio.get_running_loop()
                    self._loop = loop
                    await loop.run_in_executor(
                        self._pool,
                        self._invoke,
                        _fn,
                        (self._session_ctx(session), to_js(body)),
                    )

                init.register_after_rt(key_str, after_wrapper)
        elif kind in ("req_before", "req_after"):
            if not key_str:
                raise JsRuntimeError(f"{kind}: method required")
            if kind == "req_before":

                async def req_before(ctx, body, _fn=fn):
                    loop = asyncio.get_running_loop()
                    self._loop = loop
                    out = await loop.run_in_executor(
                        self._pool,
                        self._invoke,
                        _fn,
                        (self._ctx_obj(ctx), to_js(body)),
                    )
                    if out is None or out is UNDEFINED:
                        return None
                    return from_js(out)

                init.register_before_req(key_str, req_before)
            else:

                async def req_after(ctx, body, result, _fn=fn):
                    loop = asyncio.get_running_loop()
                    self._loop = loop
                    await loop.run_in_executor(
                        self._pool,
                        self._invoke,
                        _fn,
                        (self._ctx_obj(ctx), to_js(body), to_js(result)),
                    )

                init.register_after_req(key_str, req_after)
        elif kind == "matchmaker_matched":

            # Registry adapter calls user code as (ctx, entries)
            # (registry.matchmaker_matched).
            def matched_wrapper(ctx, entries, _fn=fn):
                js_entries = to_js(
                    [
                        {
                            "presence": e.presence.as_dict(),
                            "partyId": e.party_id,
                            "stringProperties": e.string_properties,
                            "numericProperties": e.numeric_properties,
                        }
                        for e in entries
                    ]
                )
                out = self._invoke(
                    _fn, (self._ctx_obj(ctx), js_entries), no_async=True
                )
                if out is None or out is UNDEFINED:
                    return ""
                return js_to_string(out)

            init.register_matchmaker_matched(matched_wrapper)
        else:

            def generic_wrapper(*args, _fn=fn):
                js_args = tuple(
                    to_js(a)
                    if isinstance(
                        a, (dict, list, str, int, float, bool, type(None))
                    )
                    else self._ctx_obj(a)
                    for a in args
                )
                return self._invoke(_fn, js_args, no_async=True)

            getattr(init, {
                "tournament_end": "register_tournament_end",
                "tournament_reset": "register_tournament_reset",
                "leaderboard_reset": "register_leaderboard_reset",
                "event": "register_event",
                "event_session_start": "register_event_session_start",
                "event_session_end": "register_event_session_end",
                "shutdown": "register_shutdown",
            }[kind])(generic_wrapper)


def _throw_text(value) -> str:
    if isinstance(value, JSObject) and "message" in value.props:
        return js_to_string(value.props["message"])
    return js_to_string(value)


def load_js_module(name, source, logger, nk, initializer) -> JsModule:
    from .lexer import JsSyntaxError

    try:
        return JsModule(name, source, logger, nk, initializer)
    except JsThrow as e:
        from ..loader import ModuleLoadError

        raise ModuleLoadError(
            f"js module {name}: uncaught {_throw_text(e.value)}"
        ) from e
    except (JsError, JsSyntaxError) as e:
        from ..loader import ModuleLoadError

        raise ModuleLoadError(f"js module {name}: {e}") from e


class GuestMatchCore:
    """MatchCore adapter over a guest object of camelCase callbacks
    (reference JS match handlers: initializer.registerMatch(name,
    {matchInit, matchJoinAttempt, matchJoin, matchLeave, matchLoop,
    matchTerminate, matchSignal}) — runtime_javascript.go match cores).

    Guest state stays a RAW guest value threaded opaquely through the
    match handler — it never converts per tick, so a 30-ticks/sec match
    pays only the presences/messages conversion. Callbacks run with the
    no-async posture (the tick loop lives on the event-loop thread)."""

    def __init__(self, module: JsModule, obj):
        self.module = module
        self.obj = obj

    def _fn(self, name):
        from .stdlib import member_of

        fn = member_of(self.module.interp, self.obj, name)
        return None if fn is UNDEFINED else fn

    def _call(self, name, args):
        fn = self._fn(name)
        if fn is None:
            raise JsError(f"js match handler missing {name}")
        return self.module._invoke(fn, args, no_async=True)

    @staticmethod
    def _presences(presences):
        return to_js([p.as_dict() for p in presences])

    def match_init(self, ctx, params):
        out = self._call(
            "matchInit", (self.module._ctx_obj_dict(ctx), to_js(params))
        )
        if not isinstance(out, JSObject):
            raise JsError("matchInit must return {state, tickRate, label}")
        tick = out.get("tickRate")
        label = out.get("label")
        return (
            out.get("state"),
            int(from_js(tick) or 1),
            js_to_string(label) if label is not UNDEFINED else "",
        )

    def match_join_attempt(
        self, ctx, dispatcher, tick, state, presence, metadata
    ):
        out = self._call(
            "matchJoinAttempt",
            (
                self.module._ctx_obj_dict(ctx),
                self.module._dispatcher_obj(dispatcher),
                float(tick),
                state,
                to_js(presence.as_dict()),
                to_js(metadata or {}),
            ),
        )
        if out is None or out is UNDEFINED:
            return state, False, ""
        accept = out.get("accept")
        reason = out.get("rejectMessage")
        return (
            out.get("state"),
            bool(from_js(accept)),
            js_to_string(reason) if reason is not UNDEFINED else "",
        )

    def _presence_cb(self, name, ctx, dispatcher, tick, state, presences):
        out = self._call(
            name,
            (
                self.module._ctx_obj_dict(ctx),
                self.module._dispatcher_obj(dispatcher),
                float(tick),
                state,
                self._presences(presences),
            ),
        )
        if out is None or out is UNDEFINED:
            return None
        return out.get("state")

    def match_join(self, ctx, dispatcher, tick, state, presences):
        return self._presence_cb(
            "matchJoin", ctx, dispatcher, tick, state, presences
        )

    def match_leave(self, ctx, dispatcher, tick, state, presences):
        return self._presence_cb(
            "matchLeave", ctx, dispatcher, tick, state, presences
        )

    def match_loop(self, ctx, dispatcher, tick, state, messages):
        js_msgs = to_js(
            [
                {
                    "sender": m.sender.as_dict(),
                    "opCode": float(m.op_code),
                    "data": m.data.decode("latin-1"),
                    "reliable": m.reliable,
                }
                for m in messages
            ]
        )
        out = self._call(
            "matchLoop",
            (
                self.module._ctx_obj_dict(ctx),
                self.module._dispatcher_obj(dispatcher),
                float(tick),
                state,
                js_msgs,
            ),
        )
        if out is None or out is UNDEFINED:
            return None
        return out.get("state")

    def match_terminate(self, ctx, dispatcher, tick, state, grace_seconds):
        out = self._call(
            "matchTerminate",
            (
                self.module._ctx_obj_dict(ctx),
                self.module._dispatcher_obj(dispatcher),
                float(tick),
                state,
                float(grace_seconds),
            ),
        )
        if out is None or out is UNDEFINED:
            return None
        return out.get("state")

    def match_signal(self, ctx, dispatcher, tick, state, data):
        out = self._call(
            "matchSignal",
            (
                self.module._ctx_obj_dict(ctx),
                self.module._dispatcher_obj(dispatcher),
                float(tick),
                state,
                data,
            ),
        )
        if out is None or out is UNDEFINED:
            return state, ""
        reply = out.get("data")
        return (
            out.get("state"),
            js_to_string(reply) if reply is not UNDEFINED else "",
        )
