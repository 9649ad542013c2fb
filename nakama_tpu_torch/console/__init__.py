"""Admin console: the operator listener (console/server.py) and its
static page (console/ui.py)."""

from .server import ConsoleServer

__all__ = ["ConsoleServer"]
