"""Sandboxed Lua runtime for operator modules (guest language #2).

The reference embeds a full Lua 5.1 VM (reference
server/runtime_lua_nakama.go + internal/gopher-lua) so operators extend
the server without trusted in-process code. This package is the
PyTorch/CUDA port's copy of the JAX package's `runtime/lua`, unchanged
but for its docstrings: an original tree-walking interpreter for a
documented Lua 5.1 subset, built for the hook/rpc workload — not a port
of any existing VM.

Sandbox model (stronger than "trusted Python modules"):
  - no io/os/require/load/dofile — the ONLY capabilities are the `nk`
    bridge and the pure stdlib subset (string/table/math/json);
  - an instruction-fuel budget aborts runaway loops deterministically;
  - a call-depth cap stops unbounded recursion;
  - guest values cross the boundary by conversion (LuaTable <-> dict/
    list), never by reference to host internals.

Subset (documented contract, tests in tests/test_lua_runtime.py;
the port's held against it in tests/test_torch_runtime.py):
  statements  local, multi-assignment, function/local function (incl.
              a.b.c and a:m sugar), calls, if/elseif/else, while,
              repeat/until, numeric and generic for, do, return, break
  expressions closures + upvalues, varargs (...), and/or/not, all
              arithmetic/comparison/concat operators, #, table
              constructors (array, record, [k]=v), method calls
  stdlib      print, type, tostring, tonumber, pairs, ipairs, select,
              unpack, pcall, error, assert, rawget/rawset,
              string.(len sub upper lower rep format find gmatch gsub
              byte char), table.(insert remove concat sort),
              math.(floor ceil abs min max huge sqrt fmod pow),
              json.(encode decode)
  omitted     metatables, coroutines, goto, string pattern classes
              beyond the common set — omissions raise clear errors.
"""

from .interp import LuaError, LuaRuntimeError, LuaTable, lua_call
from .runtime import LuaModule, load_lua_module

__all__ = [
    "LuaError",
    "LuaRuntimeError",
    "LuaTable",
    "LuaModule",
    "load_lua_module",
    "lua_call",
]
