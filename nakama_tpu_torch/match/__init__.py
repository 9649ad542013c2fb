"""Authoritative match engine + parties (reference L2 match components,
SURVEY.md §2.3): per-match tick loops driving user match logic, the match
registry/directory with label search, presence lists with join deadlines,
and party lifecycle with leader election and party matchmaking."""

from .core import MatchCore, MatchDispatcher
from .handler import MatchHandler
from .presence import JoinMarkerList, MatchPresenceList
from .registry import LocalMatchRegistry, MatchError
from .party import LocalPartyRegistry, PartyHandler

__all__ = [
    "MatchCore",
    "MatchDispatcher",
    "MatchHandler",
    "MatchPresenceList",
    "JoinMarkerList",
    "LocalMatchRegistry",
    "MatchError",
    "LocalPartyRegistry",
    "PartyHandler",
]
