"""Social identity providers (reference social/social.go:225-776).

One verifier interface covering the 7 external providers the reference
talks to over HTTPS (Facebook, Facebook Instant Game, Google, GameCenter,
Steam, Apple) — here defined as an async protocol so the auth core is
testable offline. `HttpSocialClient` verifies over the network (its
fetcher injectable); `StubSocialClient` returns deterministic profiles
for tests and development, mirroring the reference's test seams. The
port's copy of the JAX package's `social/`.
"""

from .client import (
    SocialClient,
    SocialProfile,
    SocialError,
    StubSocialClient,
)

__all__ = [
    "SocialClient",
    "SocialProfile",
    "SocialError",
    "StubSocialClient",
]
