"""Internal utility libraries (reference internal/: cronexpr)."""

from . import cronexpr

__all__ = ["cronexpr"]
