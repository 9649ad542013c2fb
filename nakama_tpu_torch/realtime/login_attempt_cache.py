"""Login attempt lockouts.

Parity with the reference LoginAttemptCache (reference
server/login_attempt_cache.go:39-174): sliding-window failure counts per
account and per client IP with tiered lockout durations.
"""

from __future__ import annotations

import time

# (max attempts within window_sec) -> lockout_sec, mirroring the tiers the
# reference applies for accounts and IPs.
ACCOUNT_RULES = [(5, 60, 60), (10, 600, 600)]  # attempts, window, lockout
IP_RULES = [(10, 60, 60), (20, 600, 900)]


class LocalLoginAttemptCache:
    def __init__(self):
        self._account_attempts: dict[str, list[float]] = {}
        self._ip_attempts: dict[str, list[float]] = {}
        self._account_locks: dict[str, float] = {}
        self._ip_locks: dict[str, float] = {}

    def _locked(self, locks: dict[str, float], key: str) -> bool:
        until = locks.get(key)
        if until is None:
            return False
        if until < time.time():
            del locks[key]
            return False
        return True

    def allow(self, account: str, ip: str = "") -> bool:
        if self._locked(self._account_locks, account):
            return False
        if ip and self._locked(self._ip_locks, ip):
            return False
        return True

    def _add(self, attempts: dict, locks: dict, rules, key: str):
        now = time.time()
        lst = attempts.setdefault(key, [])
        lst.append(now)
        max_window = max(w for _, w, _ in rules)
        attempts[key] = lst = [t for t in lst if t > now - max_window]
        for max_attempts, window, lockout in rules:
            if sum(1 for t in lst if t > now - window) >= max_attempts:
                locks[key] = max(locks.get(key, 0), now + lockout)

    def add_failure(self, account: str, ip: str = "") -> bool:
        """Record a failed login; returns whether further attempts are
        still allowed."""
        self._add(
            self._account_attempts, self._account_locks, ACCOUNT_RULES, account
        )
        if ip:
            self._add(self._ip_attempts, self._ip_locks, IP_RULES, ip)
        return self.allow(account, ip)

    def reset(self, account: str):
        self._account_attempts.pop(account, None)
        self._account_locks.pop(account, None)
