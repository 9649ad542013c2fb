"""Session token validity cache.

Parity with the reference SessionCache (reference server/session_cache.go):
an in-memory validity set for session and refresh token ids per user, with
expiry-based GC, ban/unban, and whole-user invalidation. Tokens are tracked
by their JWT `sid` claim, not the raw token string.
"""

from __future__ import annotations

import time


class LocalSessionCache:
    def __init__(self, token_expiry_sec: int, refresh_expiry_sec: int):
        self.token_expiry_sec = token_expiry_sec
        self.refresh_expiry_sec = refresh_expiry_sec
        # user_id -> {token_id: exp}
        self._session_tokens: dict[str, dict[str, float]] = {}
        self._refresh_tokens: dict[str, dict[str, float]] = {}
        self._banned: set[str] = set()

    def _gc(self, bucket: dict[str, dict[str, float]], user_id: str):
        tokens = bucket.get(user_id)
        if not tokens:
            return
        now = time.time()
        stale = [t for t, exp in tokens.items() if exp < now]
        for t in stale:
            del tokens[t]
        if not tokens:
            bucket.pop(user_id, None)

    def is_valid_session(self, user_id: str, token_id: str) -> bool:
        if user_id in self._banned:
            return False
        self._gc(self._session_tokens, user_id)
        return token_id in self._session_tokens.get(user_id, ())

    def is_valid_refresh(self, user_id: str, token_id: str) -> bool:
        if user_id in self._banned:
            return False
        self._gc(self._refresh_tokens, user_id)
        return token_id in self._refresh_tokens.get(user_id, ())

    def add(
        self,
        user_id: str,
        session_exp: float,
        session_token_id: str,
        refresh_exp: float = 0,
        refresh_token_id: str = "",
    ):
        if session_token_id:
            self._session_tokens.setdefault(user_id, {})[
                session_token_id
            ] = session_exp
        if refresh_token_id:
            self._refresh_tokens.setdefault(user_id, {})[
                refresh_token_id
            ] = refresh_exp

    def remove_session(self, user_id: str, session_token_id: str):
        self._session_tokens.get(user_id, {}).pop(session_token_id, None)

    def remove_refresh(self, user_id: str, refresh_token_id: str):
        self._refresh_tokens.get(user_id, {}).pop(refresh_token_id, None)

    def remove_all(self, user_id: str):
        self._session_tokens.pop(user_id, None)
        self._refresh_tokens.pop(user_id, None)

    def ban(self, user_ids: list[str]):
        for uid in user_ids:
            self._banned.add(uid)
            self.remove_all(uid)

    def unban(self, user_ids: list[str]):
        for uid in user_ids:
            self._banned.discard(uid)

    def clear(self):
        """Invalidate every cached session/refresh token (console
        DeleteAllData: deleted users' bearer tokens must stop working)."""
        self._session_tokens.clear()
        self._refresh_tokens.clear()
