"""Leaderboards, tournaments, rank cache, device rank engine, reset
scheduler (reference server/leaderboard_cache.go, core_leaderboard.go,
core_tournament.go, leaderboard_rank_cache.go, leaderboard_scheduler.go;
the device engine is the port's second device workload — see
device.py). Copies of the JAX package's `leaderboard/` modules; the
device programs are `cuda.py`."""

from .core import Leaderboard, LeaderboardError, Leaderboards
from .device import DeviceRankEngine
from .rank_cache import LeaderboardRankCache, rank_cache_from_config
from .scheduler import LeaderboardScheduler
from .tournament import TournamentError, Tournaments

__all__ = [
    "DeviceRankEngine",
    "Leaderboard",
    "LeaderboardError",
    "LeaderboardRankCache",
    "LeaderboardScheduler",
    "Leaderboards",
    "TournamentError",
    "Tournaments",
    "rank_cache_from_config",
]
