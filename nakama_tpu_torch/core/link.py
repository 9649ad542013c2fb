"""Link/unlink auth methods on an existing account.

Reference server/core_link.go (433 LoC) / core_unlink.go (363 LoC): each of
the 9 providers can be attached to a signed-in account if not already owned
by another account, and detached only while at least one other auth method
remains (the reference enforces this with a guarded conditional UPDATE; we
count methods in the same transaction).

The port's copy of the JAX package's `core/link.py`: device, email and
custom ids, and the social providers' links (verified with the social
client) and unlinks."""

from __future__ import annotations

import time

from ..social import SocialClient
from ..storage.db import Database, UniqueViolationError
from .authenticate import (
    AuthError,
    _EMAIL_RE,
    hash_password,
)

_PROVIDER_COLUMNS = (
    "email",
    "custom_id",
    "facebook_id",
    "facebook_instant_game_id",
    "google_id",
    "gamecenter_id",
    "steam_id",
    "apple_id",
)


async def _link_column(
    db: Database, user_id: str, column: str, value: str, extra: dict | None = None
) -> None:
    row = await db.fetch_one(
        f"SELECT id FROM users WHERE {column} = ?", (value,)
    )
    if row is not None and row["id"] != user_id:
        raise AuthError(
            f"{column} already linked to another account", "already_exists"
        )
    sets = [f"{column} = ?", "update_time = ?"]
    params: list = [value, time.time()]
    for k, v in (extra or {}).items():
        sets.append(f"{k} = ?")
        params.append(v)
    params.append(user_id)
    try:
        n = await db.execute(
            f"UPDATE users SET {', '.join(sets)} WHERE id = ?", params
        )
    except UniqueViolationError as e:
        raise AuthError(
            f"{column} already linked to another account", "already_exists"
        ) from e
    if n == 0:
        raise AuthError("account not found", "not_found")


async def _count_auth_methods(db: Database, user_id: str) -> int:
    row = await db.fetch_one(
        "SELECT "
        + " + ".join(
            f"(CASE WHEN {c} IS NOT NULL THEN 1 ELSE 0 END)"
            for c in _PROVIDER_COLUMNS
        )
        + " AS methods FROM users WHERE id = ?",
        (user_id,),
    )
    if row is None:
        raise AuthError("account not found", "not_found")
    devices = await db.fetch_one(
        "SELECT COUNT(*) AS n FROM user_device WHERE user_id = ?", (user_id,)
    )
    return row["methods"] + (devices["n"] if devices else 0)


async def _unlink_column(
    db: Database, user_id: str, column: str, also_null: tuple[str, ...] = ()
) -> None:
    """Refuse to remove the last remaining auth method. The count and the
    UPDATE run in one transaction so two concurrent unlinks cannot both
    observe 2 remaining methods (reference core_unlink.go:160-169 does this
    with a single guarded conditional UPDATE)."""
    extra = "".join(f", {c} = NULL" for c in also_null)
    async with db.tx():
        if await _count_auth_methods(db, user_id) <= 1:
            raise AuthError(
                "cannot unlink last auth method", "failed_precondition"
            )
        n = await db.execute(
            f"UPDATE users SET {column} = NULL{extra}, update_time = ?"
            f" WHERE id = ? AND {column} IS NOT NULL",
            (time.time(), user_id),
        )
        if n == 0:
            raise AuthError(f"{column} not linked", "not_found")


# ----------------------------------------------------------------- device


async def link_device(db: Database, user_id: str, device_id: str) -> None:
    if not device_id or not (10 <= len(device_id) <= 128):
        raise AuthError("device id must be 10-128 characters")
    row = await db.fetch_one(
        "SELECT user_id FROM user_device WHERE id = ?", (device_id,)
    )
    if row is not None:
        if row["user_id"] != user_id:
            raise AuthError(
                "device already linked to another account", "already_exists"
            )
        return
    try:
        await db.execute(
            "INSERT INTO user_device (id, user_id) VALUES (?, ?)",
            (device_id, user_id),
        )
    except UniqueViolationError as e:
        # Lost an insert race; relinking one's own device stays idempotent.
        row = await db.fetch_one(
            "SELECT user_id FROM user_device WHERE id = ?", (device_id,)
        )
        if row is not None and row["user_id"] == user_id:
            return
        raise AuthError(
            "device already linked to another account", "already_exists"
        ) from e


async def unlink_device(db: Database, user_id: str, device_id: str) -> None:
    async with db.tx():
        if await _count_auth_methods(db, user_id) <= 1:
            raise AuthError(
                "cannot unlink last auth method", "failed_precondition"
            )
        n = await db.execute(
            "DELETE FROM user_device WHERE id = ? AND user_id = ?",
            (device_id, user_id),
        )
        if n == 0:
            raise AuthError("device not linked", "not_found")


# ------------------------------------------------------------ email/custom


async def link_email(
    db: Database, user_id: str, email: str, password: str
) -> None:
    email = (email or "").lower()
    # Same rule as authenticate_email (reference core_link.go:174 /
    # api_authenticate.go:292: 10-255 chars) so a linked email can always
    # authenticate.
    if not _EMAIL_RE.match(email) or not (10 <= len(email) <= 255):
        raise AuthError("invalid email address")
    if not password or len(password) < 8:
        raise AuthError("password must be at least 8 characters")
    await _link_column(
        db, user_id, "email", email, {"password": hash_password(password)}
    )


async def unlink_email(db: Database, user_id: str) -> None:
    # Reference core_unlink.go:152 clears the password with the email so the
    # stale hash cannot authenticate via username.
    await _unlink_column(db, user_id, "email", also_null=("password",))


async def link_custom(db: Database, user_id: str, custom_id: str) -> None:
    if not custom_id or not (6 <= len(custom_id) <= 128):
        raise AuthError("custom id must be 6-128 characters")
    await _link_column(db, user_id, "custom_id", custom_id)


async def unlink_custom(db: Database, user_id: str) -> None:
    await _unlink_column(db, user_id, "custom_id")


# ------------------------------------------------------------------ social


async def link_facebook(
    db: Database, social: SocialClient, user_id: str, token: str
) -> None:
    profile = await social.verify_facebook(token)
    await _link_column(db, user_id, "facebook_id", profile.id)


async def unlink_facebook(db: Database, user_id: str) -> None:
    await _unlink_column(db, user_id, "facebook_id")


async def link_facebook_instant(
    db: Database,
    social: SocialClient,
    user_id: str,
    app_secret: str,
    signed_player_info: str,
) -> None:
    profile = await social.verify_facebook_instant(app_secret, signed_player_info)
    await _link_column(db, user_id, "facebook_instant_game_id", profile.id)


async def unlink_facebook_instant(db: Database, user_id: str) -> None:
    await _unlink_column(db, user_id, "facebook_instant_game_id")


async def link_google(
    db: Database, social: SocialClient, user_id: str, token: str
) -> None:
    profile = await social.verify_google(token)
    await _link_column(db, user_id, "google_id", profile.id)


async def unlink_google(db: Database, user_id: str) -> None:
    await _unlink_column(db, user_id, "google_id")


async def link_apple(
    db: Database, social: SocialClient, user_id: str, bundle_id: str, token: str
) -> None:
    profile = await social.verify_apple(bundle_id, token)
    await _link_column(db, user_id, "apple_id", profile.id)


async def unlink_apple(db: Database, user_id: str) -> None:
    await _unlink_column(db, user_id, "apple_id")


async def link_steam(
    db: Database,
    social: SocialClient,
    user_id: str,
    app_id: int,
    publisher_key: str,
    token: str,
) -> None:
    profile = await social.verify_steam(app_id, publisher_key, token)
    await _link_column(db, user_id, "steam_id", profile.id)


async def unlink_steam(db: Database, user_id: str) -> None:
    await _unlink_column(db, user_id, "steam_id")


async def link_gamecenter(
    db: Database,
    social: SocialClient,
    user_id: str,
    player_id: str,
    bundle_id: str,
    timestamp: int,
    salt: str,
    signature: str,
    public_key_url: str,
) -> None:
    profile = await social.verify_gamecenter(
        player_id, bundle_id, timestamp, salt, signature, public_key_url
    )
    await _link_column(db, user_id, "gamecenter_id", profile.id)


async def unlink_gamecenter(db: Database, user_id: str) -> None:
    await _unlink_column(db, user_id, "gamecenter_id")
