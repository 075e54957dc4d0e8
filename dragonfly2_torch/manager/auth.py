"""Users + personal access tokens for the manager REST plane
(counterpart of the reference's ``manager/auth.py``).

Role parity: upstream manager/handlers user/PAT surface with casbin
role checks (manager/service/ users.go, personal_access_tokens.go) —
reduced to the two roles the API distinguishes (admin = full access,
guest = read-only, upstream roles `root`/`guest`). Passwords are
PBKDF2-hashed with a per-user salt; tokens are random secrets returned
exactly once and stored as SHA-256 hashes, so a database leak exposes
neither. The formats are the reference's (PBKDF2-SHA256 at 100,000
iterations over a hex salt, the ``dfp_`` prefix, SHA-256 token hashes,
the ``settings.oauth_state_secret`` row), so a database written by
either package's front authenticates in the other's.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import time

TOKEN_PREFIX = "dfp_"  # personal access token (upstream PAT-style)
ROLES = ("admin", "guest")
_PBKDF2_ITERS = 100_000


def _hash_password(password: str, salt: str) -> str:
    return hashlib.pbkdf2_hmac(
        "sha256", password.encode(), bytes.fromhex(salt), _PBKDF2_ITERS
    ).hex()


def _hash_token(token: str) -> str:
    return hashlib.sha256(token.encode()).hexdigest()


def create_user(
    db, name: str, password: str, role: str = "guest", email: str = ""
) -> dict:
    if role not in ROLES:
        raise ValueError(f"role must be one of {ROLES}")
    if not name or not password:
        raise ValueError("name and password are required")
    salt = secrets.token_hex(16)
    now = time.time()
    cur = db.execute(
        "INSERT INTO users (name, email, password_salt, password_hash, role,"
        " created_at, updated_at) VALUES (?, ?, ?, ?, ?, ?, ?)",
        (name, email, salt, _hash_password(password, salt), role, now, now),
    )
    return db.query_one("SELECT * FROM users WHERE id = ?", (cur.lastrowid,))


def set_password(db, user_id: int, new_password: str) -> None:
    """Re-salt and store a new password (reset_password handler)."""
    if not new_password:
        raise ValueError("new password must not be empty")
    salt = secrets.token_hex(16)
    db.execute(
        "UPDATE users SET password_salt = ?, password_hash = ?, updated_at = ?"
        " WHERE id = ?",
        (salt, _hash_password(new_password, salt), time.time(), user_id),
    )


def revoke_pats_for_token(db, token: str) -> int:
    """Revoke the PAT row matching this plaintext token (signout).
    Returns rows revoked (0 when the token is config-file based or
    already gone — callers surface that as a client error)."""
    cur = db.execute(
        "UPDATE personal_access_tokens SET state = 'revoked' WHERE token_hash = ?",
        (_hash_token(token),),
    )
    return cur.rowcount


def verify_password(db, name: str, password: str) -> dict | None:
    """→ user row on a correct password for an enabled user, else None."""
    row = db.query_one(
        "SELECT * FROM users WHERE name = ? AND state = 'enabled'", (name,)
    )
    if row is None:
        return None
    expected = _hash_password(password, row["password_salt"])
    if not hmac.compare_digest(expected, row["password_hash"]):
        return None
    return row


def create_pat(db, user_id: int, name: str, ttl: float = 0.0) -> tuple[str, dict]:
    """Mint a token for a user; returns (plaintext_token, row). The
    plaintext is shown exactly once — only its hash is stored."""
    token = TOKEN_PREFIX + secrets.token_urlsafe(32)
    now = time.time()
    cur = db.execute(
        "INSERT INTO personal_access_tokens (user_id, name, token_hash,"
        " expires_at, created_at, updated_at) VALUES (?, ?, ?, ?, ?, ?)",
        (user_id, name, _hash_token(token), now + ttl if ttl > 0 else 0.0, now, now),
    )
    row = db.query_one(
        "SELECT * FROM personal_access_tokens WHERE id = ?", (cur.lastrowid,)
    )
    return token, row


def revoke_pat(db, pat_id: int) -> None:
    db.execute(
        "UPDATE personal_access_tokens SET state = 'revoked', updated_at = ?"
        " WHERE id = ?",
        (time.time(), pat_id),
    )


def _resolve_token_row(db, token: str) -> dict | None:
    """ONE definition of token validity (active token, not expired,
    enabled owner) shared by authentication (role) and authorization
    (owner id) — two copies of this rule set in a security path would
    inevitably drift."""
    if not token.startswith(TOKEN_PREFIX):
        return None
    row = db.query_one(
        "SELECT t.user_id, t.expires_at, u.role, u.state AS user_state FROM"
        " personal_access_tokens t JOIN users u ON u.id = t.user_id"
        " WHERE t.token_hash = ? AND t.state = 'active'",
        (_hash_token(token),),
    )
    if row is None or row["user_state"] != "enabled":
        return None
    if row["expires_at"] and row["expires_at"] < time.time():
        return None
    return row


def resolve_token(db, token: str) -> str | None:
    """Bearer token → role, or None. Valid = active token, not expired,
    owned by an enabled user."""
    row = _resolve_token_row(db, token)
    return None if row is None else row["role"]


# ---------------------------------------------------------------------------
# OAuth2 sign-in (upstream manager/auth/oauth/{oauth,google,github}.go +
# handlers/oauth.go). Providers are DB rows with generic endpoint URLs
# (auth/token/userinfo) instead of baked per-vendor SDK configs — google
# and github are both expressible as rows, and tests can point a row at
# a fake provider.
# ---------------------------------------------------------------------------


def sign_state(secret: bytes, provider: str, ttl: float = 600.0) -> str:
    """CSRF state: provider|expiry|nonce, HMAC-signed (upstream
    signs a random state into the AuthCodeURL the same way)."""
    import base64

    payload = f"{provider}|{time.time() + ttl:.0f}|{secrets.token_hex(8)}"
    sig = hmac.new(secret, payload.encode(), hashlib.sha256).hexdigest()[:32]
    return base64.urlsafe_b64encode(f"{payload}|{sig}".encode()).decode()


def verify_state(secret: bytes, state: str, provider: str) -> bool:
    import base64

    try:
        payload, _, sig = (
            base64.urlsafe_b64decode(state.encode()).decode().rpartition("|")
        )
        want = hmac.new(secret, payload.encode(), hashlib.sha256).hexdigest()[:32]
        prov, expiry, _nonce = payload.split("|", 2)
    except (ValueError, UnicodeDecodeError):
        return False
    return (
        hmac.compare_digest(sig, want)
        and prov == provider
        and float(expiry) >= time.time()
    )


def oauth_authorize_url(provider: dict, state: str) -> str:
    """The URL the browser is redirected to (upstream AuthCodeURL)."""
    import urllib.parse

    params = {
        "response_type": "code",
        "client_id": provider["client_id"],
        "state": state,
    }
    if provider.get("redirect_url"):
        params["redirect_uri"] = provider["redirect_url"]
    if provider.get("scopes"):
        params["scope"] = provider["scopes"]
    sep = "&" if "?" in provider["auth_url"] else "?"
    return provider["auth_url"] + sep + urllib.parse.urlencode(params)


def oauth_exchange(provider: dict, code: str, timeout: float = 10.0) -> str:
    """Authorization code → access token (upstream Exchange)."""
    import json as _json
    import urllib.parse
    import urllib.request

    body = urllib.parse.urlencode(
        {
            "grant_type": "authorization_code",
            "code": code,
            "client_id": provider["client_id"],
            "client_secret": provider["client_secret"],
            **(
                {"redirect_uri": provider["redirect_url"]}
                if provider.get("redirect_url")
                else {}
            ),
        }
    ).encode()
    req = urllib.request.Request(
        provider["token_url"],
        data=body,
        headers={
            "Content-Type": "application/x-www-form-urlencoded",
            "Accept": "application/json",
        },
    )
    import urllib.error

    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            data = _json.loads(resp.read())
    except urllib.error.HTTPError as e:
        # RFC 6749 token endpoints signal invalid_grant etc. as HTTP 400
        # — a routine client retry, not a server fault
        raise ValueError(f"token endpoint refused the code: {e.code}") from e
    except urllib.error.URLError as e:
        raise ValueError(f"token endpoint unreachable: {e.reason}") from e
    token = data.get("access_token", "")
    if not token:
        raise ValueError(f"token endpoint returned no access_token: {data}")
    return token


def oauth_userinfo(provider: dict, access_token: str, timeout: float = 10.0) -> dict:
    import json as _json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        provider["userinfo_url"],
        headers={"Authorization": f"Bearer {access_token}", "Accept": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return _json.loads(resp.read())
    except urllib.error.HTTPError as e:
        # insufficient scope / revoked token — an IdP refusal, not a
        # manager fault (mirrors oauth_exchange's mapping)
        raise ValueError(f"userinfo endpoint refused the token: {e.code}") from e
    except urllib.error.URLError as e:
        raise ValueError(f"userinfo endpoint unreachable: {e.reason}") from e


def oauth_signin(db, provider: dict, code: str) -> tuple[str, dict]:
    """Full callback leg: exchange the code, fetch the identity,
    find-or-provision the user (role guest, no password — OAuth is the
    credential), and mint a 24h session token. → (token, user_row).

    Users are matched by (provider, subject) — the IdP's STABLE id —
    never by display name: an attacker-controlled login/name at the IdP
    must not be able to take over an existing local account (e.g. one
    named like an admin). A taken display name gets uniquified."""
    access = oauth_exchange(provider, code)
    info = oauth_userinfo(provider, access)
    email = str(info.get("email") or "")
    # id/sub only: login handles are reassignable at most IdPs, so a
    # recycled handle must never resolve to the previous owner's account
    subject = str(info.get("id") or info.get("sub") or "")
    display = str(
        info.get("login") or info.get("name") or email.partition("@")[0] or ""
    )
    if not subject:
        raise ValueError(
            "oauth userinfo lacks a stable subject (id/sub) — refusing to"
            " link accounts by a reassignable handle"
        )
    user = db.query_one(
        "SELECT * FROM users WHERE oauth_provider = ? AND oauth_subject = ?",
        (provider["name"], subject),
    )
    if user is None:
        name = display or f"{provider['name']}-{subject}"
        for suffix in ("", *(f"-{i}" for i in range(2, 100))):
            if db.query_one(
                "SELECT id FROM users WHERE name = ?", (name + suffix,)
            ) is None:
                name = name + suffix
                break
        else:
            raise ValueError(f"cannot allocate a unique name for {display!r}")
        user = create_user(db, name, secrets.token_hex(16), role="guest", email=email)
        db.execute(
            "UPDATE users SET oauth_provider = ?, oauth_subject = ? WHERE id = ?",
            (provider["name"], subject, user["id"]),
        )
        user = db.query_one("SELECT * FROM users WHERE id = ?", (user["id"],))
    if user["state"] != "enabled":
        raise ValueError(f"user {user['name']!r} is disabled")
    token, _ = create_pat(
        db, user["id"], f"oauth-session-{provider['name']}", ttl=24 * 3600.0
    )
    return token, user


def state_secret(db) -> bytes:
    """The OAuth CSRF-state HMAC key, stored in the DB so the
    redirect→callback round-trip survives manager restarts and works
    across replicas sharing the database."""
    row = db.query_one("SELECT value FROM settings WHERE key = 'oauth_state_secret'")
    if row is not None:
        return bytes.fromhex(row["value"])
    key = secrets.token_bytes(32)
    # racing replicas: INSERT OR IGNORE, then re-read the winner
    db.execute(
        "INSERT OR IGNORE INTO settings (key, value) VALUES"
        " ('oauth_state_secret', ?)",
        (key.hex(),),
    )
    row = db.query_one("SELECT value FROM settings WHERE key = 'oauth_state_secret'")
    return bytes.fromhex(row["value"])
