"""Extensibility runtime: hook registry, the Python, Lua and JS module
providers, and the `nk` server-function module (reference
server/runtime.go:493, runtime_go.go InitModule contract,
runtime_go_nakama.go module API). The port's copy of the JAX package's
`runtime/`, over the port's own components; it imports neither torch
nor anything outside the standard library."""

from .loader import ModuleLoadError, load_runtime
from .nk import NakamaModule
from .registry import Initializer, Runtime, RuntimeContext

__all__ = [
    "Initializer",
    "ModuleLoadError",
    "NakamaModule",
    "Runtime",
    "RuntimeContext",
    "load_runtime",
]
