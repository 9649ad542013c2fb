"""Live rank cache — the host oracle.

The reference keeps one skiplist per (leaderboard, expiry) for O(log n)
rank lookups (reference server/leaderboard_rank_cache.go:25-121,
internal/skiplist). This structure is a flat sorted array with C-speed
bisect/insort: the skiplist's O(log n) read with better constants and an
O(n)-memmove write that stays cheap well past 100k records. Batched
windows (haystack, around-rank) are array slices.

Every record write lands here first and wants its new rank back, which
a lazily re-sorted device tensor would pay a full sort for. At read
scale N host bisects lose to one batched device search, so large boards
are also mirrored onto the card by `device.DeviceRankEngine`; this cache
stays the oracle and the breaker-routed fallback. A copy of the JAX
package's `leaderboard/rank_cache.py`.
"""

from __future__ import annotations

from bisect import bisect_left, insort


class _Board:
    __slots__ = ("sort_order", "keys", "key_of", "_seq")

    def __init__(self, sort_order: int):
        self.sort_order = sort_order  # 0 asc, 1 desc
        # Sorted ascending by (adj_score, adj_subscore, seq, owner);
        # desc boards negate scores so better is always first.
        self.keys: list[tuple] = []
        self.key_of: dict[str, tuple] = {}
        self._seq = 0

    def _key(self, owner: str, score: int, subscore: int) -> tuple:
        self._seq += 1
        if self.sort_order:  # desc
            return (-score, -subscore, self._seq, owner)
        return (score, subscore, self._seq, owner)

    def upsert(self, owner: str, score: int, subscore: int) -> int:
        old = self.key_of.get(owner)
        if old is not None:
            if self.sort_order:
                adj = (-score, -subscore)
            else:
                adj = (score, subscore)
            if (old[0], old[1]) == adj:
                # Identical (score, subscore) re-submit: keep the
                # original seq — a fresh one would demote the owner
                # behind every peer they previously tied ahead of
                # (reference tie-break: earliest write wins stays won).
                return bisect_left(self.keys, old)
            del self.keys[bisect_left(self.keys, old)]
            del self.key_of[owner]
        key = self._key(owner, score, subscore)
        self.key_of[owner] = key
        insort(self.keys, key)
        return bisect_left(self.keys, key)

    def delete(self, owner: str):
        old = self.key_of.pop(owner, None)
        if old is not None:
            del self.keys[bisect_left(self.keys, old)]

    def rank(self, owner: str) -> int:
        key = self.key_of.get(owner)
        if key is None:
            return -1
        return bisect_left(self.keys, key)

    def count(self) -> int:
        return len(self.keys)

    def owners_at(self, start: int, limit: int) -> list[tuple[str, int]]:
        """Batched rank window [start, start+limit): one slice."""
        return [
            (key[3], start + i)
            for i, key in enumerate(self.keys[start : start + limit])
        ]

    def standings(self) -> list[dict]:
        """Full final standings (reward sweeps): every entry with its
        1-based rank and de-adjusted score — one pass over the sorted
        array (the host half of DeviceRankEngine.sweep_many)."""
        neg = -1 if self.sort_order else 1
        return [
            {
                "owner_id": key[3],
                "rank": i + 1,
                "score": neg * key[0],
                "subscore": neg * key[1],
            }
            for i, key in enumerate(self.keys)
        ]


class LeaderboardRankCache:
    """Owner ranks per (leaderboard id, expiry bucket); trimmed when a
    reset rolls expiry forward (reference TrimExpired,
    leaderboard_rank_cache.go:29-36)."""

    def __init__(self, blacklist: list[str] | None = None):
        self._boards: dict[tuple[str, float], _Board] = {}
        # "*" blacklists all boards (reference blacklist opt-out :106-115).
        self._blacklist = set(blacklist or [])
        self._all = "*" in self._blacklist

    def clear_all(self):
        """Drop every board (console DeleteAllData)."""
        self._boards.clear()

    def _board(
        self, leaderboard_id: str, expiry: float, sort_order: int
    ) -> _Board | None:
        if self._all or leaderboard_id in self._blacklist:
            return None
        key = (leaderboard_id, expiry)
        board = self._boards.get(key)
        if board is None:
            board = self._boards[key] = _Board(sort_order)
        return board

    def insert(
        self, leaderboard_id: str, expiry: float, sort_order: int,
        owner_id: str, score: int, subscore: int,
    ) -> int:
        board = self._board(leaderboard_id, expiry, sort_order)
        if board is None:
            return -1
        return board.upsert(owner_id, score, subscore)

    def get(
        self, leaderboard_id: str, expiry: float, owner_id: str
    ) -> int:
        board = self._boards.get((leaderboard_id, expiry))
        if board is None:
            return -1
        return board.rank(owner_id)

    def get_many(
        self, leaderboard_id: str, expiry: float, owner_ids: list[str]
    ) -> list[int]:
        board = self._boards.get((leaderboard_id, expiry))
        if board is None:
            return [-1] * len(owner_ids)
        return [board.rank(o) for o in owner_ids]

    def key_for(
        self, leaderboard_id: str, expiry: float, owner_id: str
    ) -> tuple | None:
        """The owner's exact lexicographic key (adj_score, adj_subscore,
        seq, owner) — the DeviceRankEngine stages and queries with this
        same key so device and host tie-breaks agree bit-for-bit."""
        board = self._boards.get((leaderboard_id, expiry))
        if board is None:
            return None
        return board.key_of.get(owner_id)

    def keys_for(
        self, leaderboard_id: str, expiry: float, owner_ids: list[str]
    ) -> list[tuple | None] | None:
        """Batched `key_for`: one bound-method walk instead of a dict
        probe chain per owner — the device read path stages thousands
        of query keys per call, and the per-call overhead was measurable
        against the kernel itself. None when the bucket is absent."""
        board = self._boards.get((leaderboard_id, expiry))
        if board is None:
            return None
        get = board.key_of.get
        return [get(o) for o in owner_ids]

    def items(
        self, leaderboard_id: str, expiry: float
    ) -> list[tuple[str, tuple]] | None:
        """(owner, key) pairs for device-board adoption; None when the
        bucket does not exist (blacklisted / never written)."""
        board = self._boards.get((leaderboard_id, expiry))
        if board is None:
            return None
        return list(board.key_of.items())

    def restore_board(
        self,
        leaderboard_id: str,
        expiry: float,
        sort_order: int,
        entries: list[tuple],
    ) -> None:
        """Rebuild one bucket from checkpointed (owner, k0, k1, seq)
        rows with their original seqs, so tie-break order survives a
        warm restart; the post-restore DB reload's identical-score
        re-inserts then preserve these seqs (see _Board.upsert)."""
        board = self._board(leaderboard_id, expiry, sort_order)
        if board is None:
            return
        board.keys = []
        board.key_of = {}
        max_seq = board._seq
        for owner, k0, k1, seq in entries:
            key = (int(k0), int(k1), int(seq), owner)
            board.key_of[owner] = key
            board.keys.append(key)
            max_seq = max(max_seq, int(seq))
        board.keys.sort()
        board._seq = max_seq

    def delete(self, leaderboard_id: str, expiry: float, owner_id: str):
        board = self._boards.get((leaderboard_id, expiry))
        if board is not None:
            board.delete(owner_id)

    def delete_leaderboard(self, leaderboard_id: str):
        for key in [k for k in self._boards if k[0] == leaderboard_id]:
            del self._boards[key]

    def count(self, leaderboard_id: str, expiry: float) -> int:
        board = self._boards.get((leaderboard_id, expiry))
        return 0 if board is None else board.count()

    def rank_window(
        self, leaderboard_id: str, expiry: float, start: int, limit: int
    ) -> list[tuple[str, int]]:
        board = self._boards.get((leaderboard_id, expiry))
        if board is None:
            return []
        return board.owners_at(start, limit)

    def standings(
        self, leaderboard_id: str, expiry: float
    ) -> list[dict]:
        board = self._boards.get((leaderboard_id, expiry))
        if board is None:
            return []
        return board.standings()

    def trim_expired(self, now: float) -> int:
        """Drop buckets whose expiry passed (0 = never expires)."""
        gone = [k for k in self._boards if k[1] != 0 and k[1] <= now]
        for k in gone:
            del self._boards[k]
        return len(gone)


def rank_cache_from_config(leaderboard_config) -> LeaderboardRankCache:
    """The one place config becomes a rank cache, so every builder of
    one honours `blacklist_rank_cache`."""
    return LeaderboardRankCache(
        list(getattr(leaderboard_config, "blacklist_rank_cache", []) or [])
    )
