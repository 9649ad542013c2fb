"""Sandboxed JavaScript runtime for operator modules (guest language #3).

The reference embeds goja, a full ES5 engine (reference
server/runtime_javascript.go + runtime_javascript_nakama.go), so
operators extend the server in JS. This package is the PyTorch/CUDA
port's copy of the JAX package's `runtime/js`, unchanged but for its
docstrings: an original tree-walking interpreter for a documented JS
subset built for the hook/rpc workload — not a port of any engine.

Sandbox model (same discipline as the Lua guest, runtime/lua):
  - no ambient capabilities: no filesystem/network/process/import/
    timers/Date/Math.random — the ONLY capabilities are the `nk` bridge
    and the pure stdlib subset;
  - an instruction-fuel budget aborts runaway loops deterministically
    (not catchable by guest try/catch);
  - a call-depth cap stops unbounded recursion;
  - guest values cross the boundary by conversion (JSObject/JSArray <->
    dict/list), never by reference to host internals.

Module contract (reference server/runtime_javascript.go): the file is
evaluated, then its `InitModule(ctx, logger, nk, initializer)` runs;
`initializer.registerRpc(id, fn)` etc. adapt guest functions onto the
shared hook registry; `nk` exposes the full facade in camelCase
(`nk.storageWrite`, `nk.accountGetId`, ...).

Subset (documented contract, tests in tests/test_js_runtime.py):
  statements  var/let/const (incl. multi-declarators), function decls,
              if/else, while, do-while, for (classic/in/of), return,
              break/continue, throw, try/catch/finally, switch, blocks
  expressions closures, function expressions + arrow functions,
              ternary, && || !, all arithmetic/comparison/bitwise
              operators (=== and == with standard coercions), ++/--,
              compound assignment, member/index access, object & array
              literals (incl. computed keys and shorthand), typeof,
              delete, `in`, comma; restricted ASI (newline-terminated
              statements)
  stdlib      console.*, JSON.stringify/parse, Math.(floor ceil round
              trunc abs sqrt log exp sign min max pow PI E),
              Object.(keys values entries assign), Array.isArray,
              String/Number/Boolean/Error, parseInt, parseFloat,
              isNaN, isFinite, string methods (slice substring indexOf
              lastIndexOf includes startsWith endsWith toUpperCase
              toLowerCase trim split replace replaceAll charAt
              charCodeAt repeat padStart), array methods (push pop
              shift unshift slice splice concat indexOf includes join
              reverse map filter forEach find some every reduce sort),
              fn.call/fn.apply
  omitted     classes/new/prototypes, generators/async, regex literals,
              template literals, spread/rest, destructuring,
              Date/Math.random (determinism) — omissions raise clear
              syntax/runtime errors, never misbehave silently.
"""

from .interp import JsError, JsRuntimeError, JSArray, JSObject, UNDEFINED
from .runtime import JsModule, load_js_module

__all__ = [
    "JsError",
    "JsRuntimeError",
    "JSArray",
    "JSObject",
    "UNDEFINED",
    "JsModule",
    "load_js_module",
]
