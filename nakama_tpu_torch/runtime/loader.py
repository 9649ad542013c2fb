"""Runtime module loader: Python, Lua and JS modules from one directory.

Parity: the reference loads user code at startup from the runtime path —
Go `.so` plugins via plugin.Open + InitModule (reference
server/runtime_go.go:2737), Lua files into a VM pool, a JS bundle into
goja — and every module registers its hooks through an initializer.
Every ``*.py``, ``*.lua`` and ``*.js`` file directly under
``config.runtime.path`` (names starting with ``_`` skipped) is loaded in
file-name order (matching the reference's deterministic module order,
runtime.go:661): a ``.py`` module's ``init_module(ctx, logger, nk,
initializer)`` is called, a Lua chunk runs with its global ``nk``, a JS
file's ``InitModule`` runs. A Python module without ``init_module`` is
an error, matching the reference's refusal to load an invalid module.

The port's copy of the JAX package's `runtime/loader.py`; it also keeps
each loaded Lua and JS module on `Runtime.guest_modules`, so that the
runtime's shutdown stops their worker threads.
"""

from __future__ import annotations

import importlib.util
import os
import sys

from .nk import NakamaModule
from .registry import Initializer, Runtime


class ModuleLoadError(Exception):
    pass


def load_runtime(
    logger,
    config,
    *,
    nk: NakamaModule | None = None,
    modules: list | None = None,
    **components,
) -> Runtime:
    """Build the Runtime: construct nk over the supplied components, then
    initialize user modules from `config.runtime.path` (and/or directly
    passed callables, for tests/embedding).

    `modules` entries may be callables (treated as init_module) or
    (name, callable) pairs.
    """
    runtime = Runtime(logger, config, node=getattr(config, "name", ""))
    if nk is None:
        nk = NakamaModule(logger, config, runtime=runtime, **components)
    else:
        nk.runtime = runtime
    runtime.nk = nk
    initializer = Initializer(runtime)
    ctx = runtime.context(mode="run_once")
    log = logger.with_fields(subsystem="runtime")

    for entry in modules or []:
        name, fn = entry if isinstance(entry, tuple) else (
            getattr(entry, "__name__", "module"), entry
        )
        _init_one(log, name, fn, ctx, nk, initializer)
        runtime.modules.append(name)

    path = getattr(getattr(config, "runtime", None), "path", "") or ""
    if path:
        for name, fn in _load_path(path):
            _init_one(log, name, fn, ctx, nk, initializer)
            runtime.modules.append(name)

    log.info(
        "runtime modules loaded",
        modules=len(runtime.modules),
        rpcs=len(runtime.rpc_ids()),
    )
    return runtime


def _load_path(path: str):
    if not os.path.isdir(path):
        raise ModuleLoadError(f"runtime path not a directory: {path}")
    out = []
    for fname in sorted(os.listdir(path)):
        if fname.startswith("_"):
            continue
        if fname.endswith(".lua"):
            # Guest-language provider (runtime/lua): the chunk registers
            # its hooks at load via the global `nk`, so its "init" only
            # needs to construct the module.
            with open(os.path.join(path, fname)) as fh:
                source = fh.read()

            def lua_init(
                ctx, log, nk, initializer, _src=source, _name=fname
            ):
                from .lua import load_lua_module

                initializer._r.guest_modules.append(
                    load_lua_module(_name, _src, log, nk, initializer)
                )

            out.append((fname, lua_init))
            continue
        if fname.endswith(".js"):
            # Guest-language provider #3 (runtime/js): evaluation defines
            # InitModule, which registers hooks via the camelCase API.
            with open(os.path.join(path, fname)) as fh:
                source = fh.read()

            def js_init(
                ctx, log, nk, initializer, _src=source, _name=fname
            ):
                from .js import load_js_module

                initializer._r.guest_modules.append(
                    load_js_module(_name, _src, log, nk, initializer)
                )

            out.append((fname, js_init))
            continue
        if not fname.endswith(".py"):
            continue
        mod_name = f"nakama_runtime_{fname[:-3]}"
        spec = importlib.util.spec_from_file_location(
            mod_name, os.path.join(path, fname)
        )
        if spec is None or spec.loader is None:
            raise ModuleLoadError(f"cannot load module: {fname}")
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = module
        try:
            spec.loader.exec_module(module)
        except Exception as e:
            raise ModuleLoadError(f"module {fname} failed to import: {e}")
        init = getattr(module, "init_module", None)
        if init is None:
            raise ModuleLoadError(
                f"module {fname} has no init_module(ctx, logger, nk, "
                "initializer)"
            )
        out.append((fname, init))
    return out


def _init_one(log, name, fn, ctx, nk, initializer):
    try:
        fn(ctx, log.with_fields(module=name), nk, initializer)
    except Exception as e:
        raise ModuleLoadError(f"init_module failed in {name}: {e}") from e
