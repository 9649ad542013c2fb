"""Authentication core: all 9 auth flows of the reference.

The port's copy of the JAX package's `core/authenticate.py` (reference
server/core_authenticate.go): device (:183), email, custom, Apple,
Facebook, Facebook Instant Game, GameCenter, Google, Steam — each a
lookup-or-create against its identity column on `users` over the
port's storage engines and the shared schema, with username-conflict
handling, disabled-account rejection, and profile import for social
providers. Passwords use stdlib scrypt (salted adaptive KDF), so either
package checks the other's hashes.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import re
import secrets
import time
import uuid

from ..social import SocialClient, SocialError, SocialProfile
from ..storage.db import Database, UniqueViolationError


class AuthError(Exception):
    def __init__(self, message: str, code: str = "invalid_argument"):
        super().__init__(message)
        self.code = code  # invalid_argument | not_found | already_exists | unauthenticated | permission_denied


_USERNAME_RE = re.compile(r"^[A-Za-z0-9_.-]{1,128}$")
_EMAIL_RE = re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$")


def generate_username() -> str:
    """Random username for created accounts (reference
    generateUsername, core_authenticate.go)."""
    return "".join(
        secrets.choice("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789")
        for _ in range(10)
    )


def _validate_username(username: str | None) -> str:
    if not username:
        return generate_username()
    if not _USERNAME_RE.match(username):
        raise AuthError("invalid username")
    return username


# ------------------------------------------------------------- passwords


def hash_password(password: str) -> bytes:
    salt = os.urandom(16)
    digest = hashlib.scrypt(
        password.encode(), salt=salt, n=2**14, r=8, p=1, dklen=32
    )
    return b"scrypt$" + salt.hex().encode() + b"$" + digest.hex().encode()


def check_password(stored: bytes | None, password: str) -> bool:
    if not stored:
        return False
    try:
        scheme, salt_hex, digest_hex = bytes(stored).split(b"$")
        if scheme != b"scrypt":
            return False
        digest = hashlib.scrypt(
            password.encode(),
            salt=bytes.fromhex(salt_hex.decode()),
            n=2**14,
            r=8,
            p=1,
            dklen=32,
        )
        return hmac.compare_digest(digest, bytes.fromhex(digest_hex.decode()))
    except (ValueError, AttributeError):
        return False


# ------------------------------------------------------ lookup-or-create


async def _create_user(
    db: Database,
    username: str,
    column: str | None,
    provider_id: str | None,
    extra: dict | None = None,
) -> str:
    user_id = str(uuid.uuid4())
    now = time.time()
    cols = ["id", "username", "create_time", "update_time"]
    vals: list = [user_id, username, now, now]
    if column is not None:
        cols.append(column)
        vals.append(provider_id)
    for k, v in (extra or {}).items():
        cols.append(k)
        vals.append(v)
    placeholders = ", ".join("?" for _ in cols)
    try:
        await db.execute(
            f"INSERT INTO users ({', '.join(cols)}) VALUES ({placeholders})",
            vals,
        )
    except UniqueViolationError as e:
        msg = str(e)
        if "username" in msg:
            raise AuthError("username already in use", "already_exists") from e
        raise AuthError("account already exists", "already_exists") from e
    return user_id


def _check_not_disabled(row: dict) -> None:
    if row.get("disable_time"):
        raise AuthError("account disabled", "permission_denied")


async def _lookup_or_create(
    db: Database,
    column: str,
    provider_id: str,
    username: str | None,
    create: bool,
    extra: dict | None = None,
) -> tuple[str, str, bool]:
    """Shared provider-column flow: returns (user_id, username, created)."""
    row = await db.fetch_one(
        f"SELECT id, username, disable_time FROM users WHERE {column} = ?",
        (provider_id,),
    )
    if row is not None:
        _check_not_disabled(row)
        return row["id"], row["username"], False
    if not create:
        raise AuthError("user account not found", "not_found")
    uname = _validate_username(username)
    user_id = await _create_user(db, uname, column, provider_id, extra)
    return user_id, uname, True


async def _verify(coro):
    """Map provider rejection to the Unauthenticated error code the way the
    reference maps social verification failures (core_authenticate.go)."""
    try:
        return await coro
    except SocialError as e:
        raise AuthError(str(e), "unauthenticated") from e


# ------------------------------------------------------------- the flows


async def authenticate_device(
    db: Database, device_id: str, username: str | None, create: bool
) -> tuple[str, str, bool]:
    """Reference AuthenticateDevice core_authenticate.go:183: device ids are
    their own table so one account can hold many devices."""
    if not device_id or not (10 <= len(device_id) <= 128):
        raise AuthError("device id must be 10-128 characters")
    row = await db.fetch_one(
        "SELECT u.id, u.username, u.disable_time FROM user_device d"
        " JOIN users u ON u.id = d.user_id WHERE d.id = ?",
        (device_id,),
    )
    if row is not None:
        _check_not_disabled(row)
        return row["id"], row["username"], False
    if not create:
        raise AuthError("user account not found", "not_found")
    uname = _validate_username(username)
    async with db.tx() as tx:
        user_id = str(uuid.uuid4())
        now = time.time()
        try:
            await tx.execute(
                "INSERT INTO users (id, username, create_time, update_time)"
                " VALUES (?, ?, ?, ?)",
                (user_id, uname, now, now),
            )
            await tx.execute(
                "INSERT INTO user_device (id, user_id) VALUES (?, ?)",
                (device_id, user_id),
            )
        except UniqueViolationError as e:
            raise AuthError("username already in use", "already_exists") from e
    return user_id, uname, True


async def authenticate_email(
    db: Database, email: str, password: str, username: str | None, create: bool
) -> tuple[str, str, bool]:
    email = (email or "").lower()
    if not _EMAIL_RE.match(email) or not (10 <= len(email) <= 255):
        raise AuthError("invalid email address")
    if not password or len(password) < 8:
        raise AuthError("password must be at least 8 characters")
    row = await db.fetch_one(
        "SELECT id, username, password, disable_time FROM users WHERE email = ?",
        (email,),
    )
    if row is not None:
        _check_not_disabled(row)
        if not check_password(row["password"], password):
            raise AuthError("invalid credentials", "unauthenticated")
        return row["id"], row["username"], False
    if not create:
        raise AuthError("user account not found", "not_found")
    uname = _validate_username(username)
    user_id = await _create_user(
        db, uname, "email", email, {"password": hash_password(password)}
    )
    return user_id, uname, True


async def authenticate_custom(
    db: Database, custom_id: str, username: str | None, create: bool
) -> tuple[str, str, bool]:
    if not custom_id or not (6 <= len(custom_id) <= 128):
        raise AuthError("custom id must be 6-128 characters")
    return await _lookup_or_create(db, "custom_id", custom_id, username, create)


def _profile_extra(profile: SocialProfile) -> dict:
    extra: dict = {}
    if profile.display_name:
        extra["display_name"] = profile.display_name
    if profile.avatar_url:
        extra["avatar_url"] = profile.avatar_url
    if profile.lang_tag:
        extra["lang_tag"] = profile.lang_tag
    return extra


async def authenticate_facebook(
    db: Database,
    social: SocialClient,
    token: str,
    username: str | None,
    create: bool,
) -> tuple[str, str, bool]:
    profile = await _verify(social.verify_facebook(token))
    return await _lookup_or_create(
        db,
        "facebook_id",
        profile.id,
        username or profile.username or None,
        create,
        _profile_extra(profile),
    )


async def authenticate_facebook_instant(
    db: Database,
    social: SocialClient,
    app_secret: str,
    signed_player_info: str,
    username: str | None,
    create: bool,
) -> tuple[str, str, bool]:
    profile = await _verify(
        social.verify_facebook_instant(app_secret, signed_player_info)
    )
    return await _lookup_or_create(
        db, "facebook_instant_game_id", profile.id, username, create
    )


async def authenticate_google(
    db: Database,
    social: SocialClient,
    token: str,
    username: str | None,
    create: bool,
) -> tuple[str, str, bool]:
    profile = await _verify(social.verify_google(token))
    return await _lookup_or_create(
        db,
        "google_id",
        profile.id,
        username or profile.username or None,
        create,
        _profile_extra(profile),
    )


async def authenticate_apple(
    db: Database,
    social: SocialClient,
    bundle_id: str,
    token: str,
    username: str | None,
    create: bool,
) -> tuple[str, str, bool]:
    profile = await _verify(social.verify_apple(bundle_id, token))
    return await _lookup_or_create(
        db, "apple_id", profile.id, username, create, _profile_extra(profile)
    )


async def authenticate_steam(
    db: Database,
    social: SocialClient,
    app_id: int,
    publisher_key: str,
    token: str,
    username: str | None,
    create: bool,
) -> tuple[str, str, bool]:
    profile = await _verify(social.verify_steam(app_id, publisher_key, token))
    return await _lookup_or_create(
        db, "steam_id", profile.id, username, create
    )


async def authenticate_gamecenter(
    db: Database,
    social: SocialClient,
    player_id: str,
    bundle_id: str,
    timestamp: int,
    salt: str,
    signature: str,
    public_key_url: str,
    username: str | None,
    create: bool,
) -> tuple[str, str, bool]:
    profile = await _verify(
        social.verify_gamecenter(
            player_id, bundle_id, timestamp, salt, signature, public_key_url
        )
    )
    return await _lookup_or_create(
        db, "gamecenter_id", profile.id, username, create
    )
