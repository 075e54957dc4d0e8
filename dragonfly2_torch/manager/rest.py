"""Manager REST API (upstream manager/router/router.go:269 +
manager/handlers/ + manager/service/): cluster / scheduler / seed-peer /
job / model / application CRUD over HTTP JSON, with bearer-token role
auth standing in for upstream's casbin RBAC (admin = full access,
guest = read-only; upstream roles `root`/`guest`).

Stdlib http.server — the service plane needs no framework; the threaded
server handles the console/API concurrency a control plane sees. Model
activation flips versions through ModelRegistry.activate, the REST
equivalent of upstream manager/service/model.go:109
updateModelStateToActive.

Counterpart of the reference's ``manager/rest.py``: the same route table
(methods, paths, ``write``/``auth`` flags), status codes and body shapes,
and the same OpenAPI document — its title, its description and each
handler docstring's first line (an operation's summary) are kept as the
reference publishes them, so both fronts serve one document. Every write
goes through ``service.db``: behind ``ManagerServer`` that is the
read-through cache, so a write here invalidates what gRPC readers see.
"""

from __future__ import annotations

import json
import re
import sqlite3
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dragonfly2_torch.manager.service import ManagerService
from dragonfly2_torch.utils import dflog

logger = dflog.get("manager.rest")

#                 (method, rx, fn, write, auth, raw pattern)
_ROUTES: list[tuple[str, re.Pattern, str, bool, bool, str]] = []


def route(method: str, pattern: str, write: bool = False, auth: bool = True):
    """``auth=False`` marks the route itself unauthenticated (health
    probes, credential-exchange legs) — a per-route flag, not a path
    prefix, so unrelated routes can never inherit the exemption."""
    # literal segments are escaped: a '.' in a pattern (openapi.json)
    # must match only itself, never any byte
    rx = re.compile(
        "^" + re.sub(r":(\w+)", r"(?P<\1>[^/]+)", re.escape(pattern)) + "$"
    )

    def wrap(fn):
        _ROUTES.append((method, rx, fn.__name__, write, auth, pattern))
        return fn

    return wrap


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Redirect(Exception):
    """Handler outcome: 302 with a Location header (OAuth authorize leg,
    upstream handlers/oauth.go OauthSignin → ctx.Redirect)."""

    def __init__(self, location: str):
        super().__init__(location)
        self.location = location


def _ttl_of(body: dict, default: float) -> float:
    """Validated token TTL from a request body: numeric, non-negative
    (0 = never expires for PATs; the session default applies a cap).
    A string or negative ttl is a client error, not a 500 and not an
    accidental forever-token."""
    raw = body.get("ttl", default)
    try:
        ttl = float(raw)
    except (TypeError, ValueError):
        raise ApiError(400, f"ttl must be a number of seconds, got {raw!r}")
    if ttl < 0:
        raise ApiError(400, "ttl must be >= 0")
    return ttl


class RestApi:
    """Route handlers; one instance per server, stateless per request."""

    def __init__(self, service: ManagerService):
        from dragonfly2_torch.manager import auth as _auth

        self.service = service
        self.db = service.db
        self.models = service.models
        # OAuth CSRF-state HMAC key, persisted in the DB: the
        # redirect→callback round-trip survives restarts and works
        # across replicas sharing the database
        self.oauth_state_secret = _auth.state_secret(self.db)

    # -- OpenAPI (upstream api/manager/docs.go generated swagger; here
    # the spec is derived live from the route table, so it can never
    # drift from the actual surface) -------------------------------------
    _openapi_cache: dict | None = None  # immutable after import; built once

    @route("GET", "/api/v1/openapi.json", auth=False)
    def openapi(self, req):
        if RestApi._openapi_cache is not None:
            return RestApi._openapi_cache
        paths: dict = {}
        for method, rx, fname, write, needs_auth, pattern in _ROUTES:
            oa_path = re.sub(r":(\w+)", r"{\1}", pattern)
            params = [
                {
                    "name": m.group(1),
                    "in": "path",
                    "required": True,
                    "schema": {"type": "string"},
                }
                for m in re.finditer(r":(\w+)", pattern)
            ]
            doc = (getattr(type(self), fname).__doc__ or "").strip().split("\n")[0]
            op = {
                "operationId": fname,
                "summary": doc or fname.replace("_", " "),
                "responses": {"200": {"description": "OK"}},
            }
            if params:
                op["parameters"] = params
            if needs_auth:
                op["security"] = [{"bearerAuth": []}]
                op["responses"]["401"] = {"description": "unauthenticated"}
            if write:
                op["responses"]["403"] = {"description": "requires the admin role"}
            if method in ("POST", "PATCH", "PUT"):
                op["requestBody"] = {
                    "content": {"application/json": {"schema": {"type": "object"}}}
                }
            paths.setdefault(oa_path, {})[method.lower()] = op
        RestApi._openapi_cache = {
            "openapi": "3.0.3",
            "info": {
                "title": "dragonfly2_tpu manager API",
                "version": "1",
                "description": "Derived from the live route table"
                " (reference api/manager swagger docs).",
            },
            "components": {
                "securitySchemes": {
                    "bearerAuth": {"type": "http", "scheme": "bearer"}
                }
            },
            "paths": paths,
        }
        return RestApi._openapi_cache

    # -- health ----------------------------------------------------------
    @route("GET", "/healthy", auth=False)
    def healthy(self, req):
        return {"status": "ok"}

    # -- cluster telemetry (manager/telemetry.py, docs/telemetry.md) -----
    @route("GET", "/api/v1/telemetry", auth=False)
    def get_telemetry(self, req):
        """Cluster-wide telemetry snapshot: per-service inventory, swarm
        table, per-shard/per-trainer windowed aggregates, SLO burn
        state. Unauthenticated like the health probes — it is the
        observability surface dfstat/dfdoctor poll."""
        plane = getattr(self.service, "telemetry", None)
        if plane is None:
            raise ApiError(503, "telemetry plane not enabled on this manager")
        return plane.snapshot()

    # -- scheduler clusters ----------------------------------------------
    @route("GET", "/api/v1/scheduler-clusters")
    def list_scheduler_clusters(self, req):
        return self.db.query("SELECT * FROM scheduler_clusters ORDER BY id")

    @route("POST", "/api/v1/scheduler-clusters", write=True)
    def create_scheduler_cluster(self, req):
        body = req["body"]
        name = body.get("name")
        if not name:
            raise ApiError(400, "name is required")
        now = time.time()
        cur = self.db.execute(
            "INSERT INTO scheduler_clusters (name, config, client_config, scopes,"
            " is_default, created_at, updated_at) VALUES (?, ?, ?, ?, ?, ?, ?)",
            (
                name,
                json.dumps(body.get("config", {})),
                json.dumps(body.get("client_config", {})),
                json.dumps(body.get("scopes", {})),
                1 if body.get("is_default") else 0,
                now,
                now,
            ),
        )
        return self.db.query_one(
            "SELECT * FROM scheduler_clusters WHERE id = ?", (cur.lastrowid,)
        )

    @route("GET", "/api/v1/scheduler-clusters/:id")
    def get_scheduler_cluster(self, req):
        row = self.db.query_one(
            "SELECT * FROM scheduler_clusters WHERE id = ?", (int(req["id"]),)
        )
        if row is None:
            raise ApiError(404, "scheduler cluster not found")
        return row

    @route("PATCH", "/api/v1/scheduler-clusters/:id", write=True)
    def update_scheduler_cluster(self, req):
        body = req["body"]
        sets, params = [], []
        for col in ("name", "config", "client_config", "scopes"):
            if col in body:
                v = body[col]
                sets.append(f"{col} = ?")
                params.append(v if isinstance(v, str) else json.dumps(v))
        if "is_default" in body:
            sets.append("is_default = ?")
            params.append(1 if body["is_default"] else 0)
        if not sets:
            raise ApiError(400, "no updatable fields in body")
        sets.append("updated_at = ?")
        params.append(time.time())
        params.append(int(req["id"]))
        self.db.execute(
            f"UPDATE scheduler_clusters SET {', '.join(sets)} WHERE id = ?",
            tuple(params),
        )
        return self.get_scheduler_cluster(req)

    @route("DELETE", "/api/v1/scheduler-clusters/:id", write=True)
    def delete_scheduler_cluster(self, req):
        self.db.execute(
            "DELETE FROM scheduler_clusters WHERE id = ?", (int(req["id"]),)
        )
        return {"deleted": int(req["id"])}

    # -- schedulers ------------------------------------------------------
    @route("GET", "/api/v1/schedulers")
    def list_schedulers(self, req):
        return self.db.query("SELECT * FROM schedulers ORDER BY id")

    @route("GET", "/api/v1/schedulers/:id")
    def get_scheduler(self, req):
        row = self.db.query_one(
            "SELECT * FROM schedulers WHERE id = ?", (int(req["id"]),)
        )
        if row is None:
            raise ApiError(404, "scheduler not found")
        return row

    @route("DELETE", "/api/v1/schedulers/:id", write=True)
    def delete_scheduler(self, req):
        self.db.execute("DELETE FROM schedulers WHERE id = ?", (int(req["id"]),))
        return {"deleted": int(req["id"])}

    # -- seed peers ------------------------------------------------------
    @route("GET", "/api/v1/seed-peers")
    def list_seed_peers(self, req):
        return self.db.query("SELECT * FROM seed_peers ORDER BY id")

    @route("GET", "/api/v1/seed-peers/:id")
    def get_seed_peer(self, req):
        row = self.db.query_one(
            "SELECT * FROM seed_peers WHERE id = ?", (int(req["id"]),)
        )
        if row is None:
            raise ApiError(404, "seed peer not found")
        return row

    # -- jobs (preheat etc.) --------------------------------------------
    @route("GET", "/api/v1/jobs")
    def list_jobs(self, req):
        return self.db.query("SELECT * FROM jobs ORDER BY id DESC LIMIT 100")

    @route("POST", "/api/v1/jobs", write=True)
    def create_job(self, req):
        """One cluster → one job row. ``scheduler_cluster_ids`` (a list)
        fans the job to every named cluster under a shared group id
        (upstream manager/job createGroupJob over machinery groups);
        the group's aggregate state lives at /jobs/groups/:group_id."""
        body = req["body"]
        jtype = body.get("type")
        if not jtype:
            raise ApiError(400, "type is required")
        raw_clusters = body.get("scheduler_cluster_ids")
        grouped = raw_clusters is not None
        if grouped:
            if not isinstance(raw_clusters, list) or not raw_clusters:
                raise ApiError(400, "scheduler_cluster_ids must be a non-empty list")
        else:
            raw_clusters = [body.get("scheduler_cluster_id", 0)]
        # validate EVERY id before the first insert — execute() commits
        # per statement, so a mid-loop error would leave orphaned queued
        # jobs the caller can neither track nor cancel
        try:
            # id 0 = unspecified → the default cluster (matching gRPC
            # CreateJob); a literal 0 would dead-letter the job — no
            # worker ever leases cluster 0
            clusters = [
                int(c) or self.service.default_cluster_id for c in raw_clusters
            ]
        except (TypeError, ValueError):
            raise ApiError(400, f"non-numeric scheduler cluster id in {raw_clusters!r}")
        import uuid

        # the list form ALWAYS gets a group (a 1-element list is still
        # the group contract — callers poll /jobs/groups/:group_id)
        group_id = uuid.uuid4().hex if grouped else ""
        now = time.time()
        rows = []
        args = json.dumps(body.get("args", {}))
        for cid in clusters:
            cur = self.db.execute(
                "INSERT INTO jobs (type, state, args, scheduler_cluster_id,"
                " group_id, created_at, updated_at) VALUES (?, 'queued', ?, ?, ?, ?, ?)",
                (jtype, args, cid, group_id, now, now),
            )
            rows.append(
                self.db.query_one("SELECT * FROM jobs WHERE id = ?", (cur.lastrowid,))
            )
        if grouped:
            return {"group_id": group_id, "state": "queued", "jobs": rows}
        return rows[0]

    @route("GET", "/api/v1/jobs/groups/:group_id")
    def get_job_group(self, req):
        """Aggregate group state (reference machinery group semantics):
        failed if ANY member failed, succeeded when ALL succeeded,
        running if any is running, else queued."""
        rows = self.db.query(
            "SELECT * FROM jobs WHERE group_id = ? ORDER BY id", (req["group_id"],)
        )
        if not rows:
            raise ApiError(404, "job group not found")
        states = {r["state"] for r in rows}
        if "failed" in states:
            agg = "failed"
        elif states == {"succeeded"}:
            agg = "succeeded"
        elif "running" in states:
            agg = "running"
        else:
            agg = "queued"
        return {"group_id": req["group_id"], "state": agg, "jobs": rows}

    @route("GET", "/api/v1/jobs/:id")
    def get_job(self, req):
        row = self.db.query_one("SELECT * FROM jobs WHERE id = ?", (int(req["id"]),))
        if row is None:
            raise ApiError(404, "job not found")
        return row

    # -- models (registry + activation) ----------------------------------
    @route("GET", "/api/v1/models")
    def list_models(self, req):
        cluster = req["query"].get("scheduler_cluster_id")
        rows = self.models.list(int(cluster) if cluster else None)
        return [vars(r) for r in rows]

    @route("GET", "/api/v1/models/:model_id/versions/:version")
    def get_model(self, req):
        row = self.models.get(req["model_id"], int(req["version"]))
        if row is None:
            raise ApiError(404, "model not found")
        return vars(row)

    @route("PUT", "/api/v1/models/:model_id/versions/:version/state", write=True)
    def update_model_state(self, req):
        state = req["body"].get("state")
        if state not in ("active", "inactive"):
            raise ApiError(400, "state must be 'active' or 'inactive'")
        model_id, version = req["model_id"], int(req["version"])
        try:
            if state == "active":
                row = self.models.activate(model_id, version)
            else:
                row = self.models.deactivate(model_id, version)
        except KeyError:
            raise ApiError(404, "model not found")
        return vars(row)

    @route("DELETE", "/api/v1/models/:model_id/versions/:version", write=True)
    def delete_model(self, req):
        self.models.delete(req["model_id"], int(req["version"]))
        return {"deleted": req["model_id"], "version": int(req["version"])}

    # -- users + personal access tokens (upstream manager/handlers
    # users.go / personal_access_tokens.go; roles stand in for casbin) ---
    @route("GET", "/api/v1/users")
    def list_users(self, req):
        return self.db.query(
            "SELECT id, name, email, role, state, created_at, updated_at"
            " FROM users ORDER BY id"
        )

    @route("POST", "/api/v1/users", write=True)
    def create_user(self, req):
        from dragonfly2_torch.manager import auth

        body = req["body"]
        try:
            row = auth.create_user(
                self.db,
                body.get("name", ""),
                body.get("password", ""),
                role=body.get("role", "guest"),
                email=body.get("email", ""),
            )
        except ValueError as e:
            raise ApiError(400, str(e))
        return {k: v for k, v in row.items() if not k.startswith("password")}

    @route("PATCH", "/api/v1/users/:id", write=True)
    def update_user(self, req):
        body = req["body"]
        sets, params = [], []
        if "role" in body:
            from dragonfly2_torch.manager.auth import ROLES

            if body["role"] not in ROLES:
                raise ApiError(400, f"role must be one of {ROLES}")
            sets.append("role = ?")
            params.append(body["role"])
        if "state" in body:
            if body["state"] not in ("enabled", "disabled"):
                raise ApiError(400, "state must be 'enabled' or 'disabled'")
            sets.append("state = ?")
            params.append(body["state"])
        if not sets:
            raise ApiError(400, "no updatable fields in body")
        sets.append("updated_at = ?")
        params += [time.time(), int(req["id"])]
        self.db.execute(f"UPDATE users SET {', '.join(sets)} WHERE id = ?", tuple(params))
        row = self.db.query_one(
            "SELECT id, name, email, role, state FROM users WHERE id = ?",
            (int(req["id"]),),
        )
        if row is None:
            raise ApiError(404, "user not found")
        return row

    @route("POST", "/api/v1/users/signin", auth=False)
    def signin(self, req):
        """Password → short-lived session token (the console's login;
        upstream issues a session JWT — here a TTL'd PAT)."""
        from dragonfly2_torch.manager import auth

        body = req["body"]
        user = auth.verify_password(
            self.db, body.get("name", ""), body.get("password", "")
        )
        if user is None:
            raise ApiError(401, "bad credentials")
        # session TTLs are CAPPED: ttl=0 on the unauthenticated signin
        # route must not mint an immortal credential (never-expiring
        # tokens stay exclusive to the admin-gated PAT route)
        ttl = _ttl_of(body, default=24 * 3600.0)
        ttl = min(ttl or 24 * 3600.0, 30 * 24 * 3600.0)
        token, _ = auth.create_pat(self.db, user["id"], "session", ttl=ttl)
        return {"token": token, "role": user["role"]}

    def _require_admin_or_self(self, req, user_id: int) -> None:
        """Token metadata is a credential inventory: only an admin or
        the user who owns it may read it (upstream casbin policy scopes
        the nested PAT group to the token's subject). The caller's id
        was resolved once with the role (dispatcher _auth_info)."""
        if req["auth_role"] == "admin":
            return
        if req.get("auth_user_id") is not None and req["auth_user_id"] == user_id:
            return
        raise ApiError(403, "forbidden (admin or resource owner only)")

    @route("GET", "/api/v1/users/:id/personal-access-tokens")
    def list_pats(self, req):
        self._require_admin_or_self(req, int(req["id"]))
        return self.db.query(
            "SELECT id, user_id, name, state, expires_at, created_at"
            " FROM personal_access_tokens WHERE user_id = ? ORDER BY id",
            (int(req["id"]),),
        )

    @route("POST", "/api/v1/users/:id/personal-access-tokens", write=True)
    def create_pat(self, req):
        from dragonfly2_torch.manager import auth

        user = self.db.query_one(
            "SELECT id FROM users WHERE id = ?", (int(req["id"]),)
        )
        if user is None:
            raise ApiError(404, "user not found")
        token, row = auth.create_pat(
            self.db,
            user["id"],
            req["body"].get("name", "token"),
            ttl=_ttl_of(req["body"], default=0.0),
        )
        # plaintext returned exactly once; only the hash is stored
        return {"token": token, "id": row["id"], "name": row["name"]}

    @route("DELETE", "/api/v1/users/:id/personal-access-tokens/:pat_id", write=True)
    def revoke_pat(self, req):
        from dragonfly2_torch.manager import auth

        auth.revoke_pat(self.db, int(req["pat_id"]))
        return {"revoked": int(req["pat_id"])}

    # -- user lifecycle: signup / signout / refresh / reset ---------------
    # (upstream router.go:97-111; self-service legs are auth=False like
    # signin — they exchange credentials, they don't consume a session)
    @route("POST", "/api/v1/users/signup", auth=False)
    def signup(self, req):
        """Self-service registration — always the guest role (an open
        route must never mint admins; promotion is an admin PATCH,
        upstream SignUp creates a regular user the same way)."""
        from dragonfly2_torch.manager import auth

        body = req["body"]
        try:
            row = auth.create_user(
                self.db,
                body.get("name", ""),
                body.get("password", ""),
                role="guest",
                email=body.get("email", ""),
            )
        except ValueError as e:
            raise ApiError(400, str(e))
        return {k: v for k, v in row.items() if not k.startswith("password")}

    @route("POST", "/api/v1/users/signout")
    def signout(self, req):
        """Revoke the presenting session token (reference LogoutHandler)."""
        from dragonfly2_torch.manager import auth

        if not req["token"]:
            raise ApiError(400, "no bearer token to sign out")
        if not auth.revoke_pats_for_token(self.db, req["token"]):
            # config-file tokens aren't DB rows — nothing to revoke
            raise ApiError(400, "token is not a revocable session token")
        return {"signed_out": True}

    @route("POST", "/api/v1/users/refresh_token")
    def refresh_token(self, req):
        """Rotate the presenting session token: mint a fresh one with the
        same ownership, revoke the old (upstream RefreshHandler extends
        the JWT; rotation is the PAT-shaped equivalent)."""
        from dragonfly2_torch.manager import auth

        if not req["token"]:
            raise ApiError(400, "no bearer token to refresh")
        row = self.db.query_one(
            "SELECT * FROM personal_access_tokens WHERE token_hash = ?"
            " AND state = 'active'",
            (auth._hash_token(req["token"]),),
        )
        if row is None:
            raise ApiError(400, "token is not a refreshable session token")
        ttl = min(_ttl_of(req["body"], default=24 * 3600.0) or 24 * 3600.0,
                  30 * 24 * 3600.0)
        token, _ = auth.create_pat(self.db, row["user_id"], row["name"], ttl=ttl)
        auth.revoke_pat(self.db, row["id"])
        return {"token": token}

    @route("POST", "/api/v1/users/:id/reset_password", auth=False)
    def reset_password(self, req):
        """Credential exchange: proves the OLD password, stores a new one
        (upstream ResetPassword — unauthenticated route, router.go:107,
        gated by the credential itself)."""
        from dragonfly2_torch.manager import auth

        body = req["body"]
        user = self.db.query_one(
            "SELECT * FROM users WHERE id = ?", (int(req["id"]),)
        )
        if user is None:
            raise ApiError(404, "user not found")
        verified = auth.verify_password(
            self.db, user["name"], body.get("old_password", "")
        )
        if verified is None:
            raise ApiError(401, "old password incorrect")
        try:
            auth.set_password(self.db, user["id"], body.get("new_password", ""))
        except ValueError as e:
            raise ApiError(400, str(e))
        return {"reset": user["id"]}

    # -- roles / permissions (read surface of the two-role model — the
    # casbin delta is documented in PARITY.md; upstream router.go:108-124)
    @route("GET", "/api/v1/roles")
    def list_roles(self, req):
        from dragonfly2_torch.manager.auth import ROLES

        return list(ROLES)

    @route("GET", "/api/v1/roles/:role")
    def get_role(self, req):
        from dragonfly2_torch.manager.auth import ROLES

        if req["role"] not in ROLES:
            raise ApiError(404, f"no role {req['role']!r}")
        writable = req["role"] == "admin"
        return {
            "name": req["role"],
            "permissions": [
                {"object": pattern, "action": method}
                for method, _rx, _f, write, _a, pattern in _ROUTES
                if writable or not write
            ],
        }

    @route("GET", "/api/v1/permissions")
    def list_permissions(self, req):
        """Route-derived permission objects (reference GetPermissions
        walks the gin route table the same way)."""
        pairs = sorted(
            {(pattern, method) for method, _rx, _f, _w, _a, pattern in _ROUTES}
        )
        return [{"object": p, "action": m} for p, m in pairs]

    @route("GET", "/api/v1/users/:id/roles")
    def get_user_roles(self, req):
        row = self.db.query_one(
            "SELECT role FROM users WHERE id = ?", (int(req["id"]),)
        )
        if row is None:
            raise ApiError(404, "user not found")
        return [row["role"]]

    @route("PUT", "/api/v1/users/:id/roles/:role", write=True)
    def add_user_role(self, req):
        """Two-role model: PUT admin promotes, PUT guest demotes —
        role assignment IS the role field."""
        from dragonfly2_torch.manager.auth import ROLES

        if req["role"] not in ROLES:
            raise ApiError(400, f"role must be one of {ROLES}")
        cur = self.db.execute(
            "UPDATE users SET role = ?, updated_at = ? WHERE id = ?",
            (req["role"], time.time(), int(req["id"])),
        )
        if cur.rowcount == 0:
            raise ApiError(404, "user not found")
        return {"id": int(req["id"]), "role": req["role"]}

    @route("DELETE", "/api/v1/users/:id/roles/:role", write=True)
    def delete_user_role(self, req):
        """Removing a role falls back to guest (the floor role)."""
        cur = self.db.execute(
            "UPDATE users SET role = 'guest', updated_at = ? WHERE id = ? AND role = ?",
            (time.time(), int(req["id"]), req["role"]),
        )
        if cur.rowcount == 0:
            raise ApiError(404, "user not found or does not hold that role")
        return {"id": int(req["id"]), "role": "guest"}

    # -- top-level personal-access-tokens group (upstream router.go:254-260;
    # the per-user nested group above is the console's path)
    @route("GET", "/api/v1/personal-access-tokens")
    def list_all_pats(self, req):
        """Admin-only: the cross-user token inventory would otherwise
        let any guest enumerate every user's credential metadata."""
        if req["auth_role"] != "admin":
            raise ApiError(403, "forbidden (requires the admin role)")
        return self.db.query(
            "SELECT id, user_id, name, state, expires_at, created_at"
            " FROM personal_access_tokens ORDER BY id"
        )

    @route("GET", "/api/v1/personal-access-tokens/:id")
    def get_pat(self, req):
        row = self.db.query_one(
            "SELECT id, user_id, name, state, expires_at, created_at"
            " FROM personal_access_tokens WHERE id = ?",
            (int(req["id"]),),
        )
        # existence is leaked only to admins too: 403 before 404 for
        # guests, so token ids can't be probed
        if req["auth_role"] != "admin":
            uid = req.get("auth_user_id")
            if row is None or uid is None or int(row["user_id"]) != uid:
                raise ApiError(403, "forbidden (admin or resource owner only)")
        if row is None:
            raise ApiError(404, "personal access token not found")
        return row

    @route("POST", "/api/v1/personal-access-tokens", write=True)
    def create_pat_toplevel(self, req):
        from dragonfly2_torch.manager import auth

        body = req["body"]
        user_id = body.get("user_id")
        if not user_id:
            raise ApiError(400, "user_id is required")
        if self.db.query_one("SELECT id FROM users WHERE id = ?", (int(user_id),)) is None:
            raise ApiError(404, "user not found")
        token, row = auth.create_pat(
            self.db, int(user_id), body.get("name", "token"),
            ttl=_ttl_of(body, default=0.0),
        )
        return {"token": token, "id": row["id"], "name": row["name"]}

    @route("PATCH", "/api/v1/personal-access-tokens/:id", write=True)
    def update_pat(self, req):
        state = req["body"].get("state")
        if state not in ("active", "inactive"):
            raise ApiError(400, "state must be 'active' or 'inactive'")
        cur = self.db.execute(
            "UPDATE personal_access_tokens SET state = ? WHERE id = ?"
            " AND state != 'revoked'",
            (state, int(req["id"])),
        )
        if cur.rowcount == 0:
            raise ApiError(404, "token not found or revoked")
        return {"id": int(req["id"]), "state": state}

    @route("DELETE", "/api/v1/personal-access-tokens/:id", write=True)
    def delete_pat_toplevel(self, req):
        from dragonfly2_torch.manager import auth

        auth.revoke_pat(self.db, int(req["id"]))
        return {"revoked": int(req["id"])}

    # -- applications ----------------------------------------------------
    # -- oauth providers + sign-in flow ---------------------------------
    # (upstream manager/handlers/oauth.go CRUD + OauthSignin/Callback)
    _OAUTH_PUBLIC = ("id", "name", "bio", "client_id", "redirect_url",
                     "auth_url", "scopes", "created_at", "updated_at")

    def _oauth_row(self, ident: str) -> dict:
        # numeric → by id only; else by name — a provider NAMED like
        # another provider's id must never be resolved (or deleted) in
        # its place (same rule as get_config)
        if ident.isdigit():
            row = self.db.query_one("SELECT * FROM oauth WHERE id = ?", (int(ident),))
        else:
            row = self.db.query_one("SELECT * FROM oauth WHERE name = ?", (ident,))
        if row is None:
            raise ApiError(404, f"no oauth provider {ident!r}")
        return row

    def _oauth_public(self, row: dict) -> dict:
        # client_secret and token/userinfo endpoints stay server-side
        return {k: row[k] for k in self._OAUTH_PUBLIC if k in row}

    @route("GET", "/api/v1/oauth")
    def list_oauth(self, req):
        return [self._oauth_public(r) for r in self.db.query("SELECT * FROM oauth ORDER BY id")]

    @route("POST", "/api/v1/oauth", write=True)
    def create_oauth(self, req):
        body = req["body"]
        for field in ("name", "client_id", "client_secret", "auth_url",
                      "token_url", "userinfo_url"):
            if not body.get(field):
                raise ApiError(400, f"{field} is required")
        now = time.time()
        cur = self.db.execute(
            "INSERT INTO oauth (name, bio, client_id, client_secret,"
            " redirect_url, auth_url, token_url, userinfo_url, scopes,"
            " created_at, updated_at) VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                body["name"], body.get("bio", ""), body["client_id"],
                body["client_secret"], body.get("redirect_url", ""),
                body["auth_url"], body["token_url"], body["userinfo_url"],
                body.get("scopes", ""), now, now,
            ),
        )
        return self._oauth_public(
            self.db.query_one("SELECT * FROM oauth WHERE id = ?", (cur.lastrowid,))
        )

    @route("GET", "/api/v1/oauth/:id")
    def get_oauth(self, req):
        return self._oauth_public(self._oauth_row(req["id"]))

    @route("PATCH", "/api/v1/oauth/:id", write=True)
    def update_oauth(self, req):
        row = self._oauth_row(req["id"])
        body = req["body"]
        fields = ("name", "bio", "client_id", "client_secret", "redirect_url",
                  "auth_url", "token_url", "userinfo_url", "scopes")
        updates = {k: body[k] for k in fields if k in body}
        if updates:
            sets = ", ".join(f"{k} = ?" for k in updates)
            self.db.execute(
                f"UPDATE oauth SET {sets}, updated_at = ? WHERE id = ?",
                (*updates.values(), time.time(), row["id"]),
            )
        return self._oauth_public(self._oauth_row(str(row["id"])))

    @route("DELETE", "/api/v1/oauth/:id", write=True)
    def delete_oauth(self, req):
        row = self._oauth_row(req["id"])
        self.db.execute("DELETE FROM oauth WHERE id = ?", (row["id"],))
        return {"deleted": row["id"]}

    @route("GET", "/api/v1/users/signin/:name", auth=False)
    def oauth_signin_redirect(self, req):
        from dragonfly2_torch.manager import auth

        provider = self._oauth_row(req["name"])
        state = auth.sign_state(self.oauth_state_secret, provider["name"])
        raise Redirect(auth.oauth_authorize_url(provider, state))

    @route("GET", "/api/v1/users/signin/:name/callback", auth=False)
    def oauth_signin_callback(self, req):
        from dragonfly2_torch.manager import auth

        provider = self._oauth_row(req["name"])
        code = req["query"].get("code", "")
        state = req["query"].get("state", "")
        if not code:
            raise ApiError(400, "missing code")
        if not auth.verify_state(self.oauth_state_secret, state, provider["name"]):
            raise ApiError(403, "state verification failed")
        try:
            token, user = auth.oauth_signin(self.db, provider, code)
        except ValueError as e:
            raise ApiError(401, str(e))
        return {
            "token": token,
            "user": {k: user[k] for k in ("id", "name", "email", "role")},
        }

    # -- peers (upstream handlers/peer.go; rows materialized from
    # sync_peers job results) -------------------------------------------
    @route("POST", "/api/v1/peers", write=True)
    def create_peer(self, req):
        """Manual peer row (reference CreatePeer — rows normally arrive
        via the sync_peers job; the write exists for operator tooling)."""
        body = req["body"]
        if not body.get("host_id"):
            raise ApiError(400, "host_id is required")
        now = time.time()
        cur = self.db.execute(
            "INSERT INTO peers (host_id, hostname, ip, type, state,"
            " scheduler_cluster_id, created_at, updated_at)"
            " VALUES (?, ?, ?, ?, 'active', ?, ?, ?)",
            (
                body["host_id"], body.get("hostname", ""), body.get("ip", ""),
                body.get("type", "normal"),
                int(body.get("scheduler_cluster_id", 1)), now, now,
            ),
        )
        return self.db.query_one("SELECT * FROM peers WHERE id = ?", (cur.lastrowid,))

    @route("GET", "/api/v1/peers")
    def list_peers(self, req):
        q = "SELECT * FROM peers"
        params: tuple = ()
        if req["query"].get("scheduler_cluster_id"):
            q += " WHERE scheduler_cluster_id = ?"
            params = (int(req["query"]["scheduler_cluster_id"]),)
        return self.db.query(q + " ORDER BY id", params)

    @route("GET", "/api/v1/peers/:id")
    def get_peer(self, req):
        row = self.db.query_one("SELECT * FROM peers WHERE id = ?", (int(req["id"]),))
        if row is None:
            raise ApiError(404, "peer not found")
        return row

    @route("DELETE", "/api/v1/peers/:id", write=True)
    def delete_peer(self, req):
        self.db.execute("DELETE FROM peers WHERE id = ?", (int(req["id"]),))
        return {"deleted": int(req["id"])}

    # -- configs (upstream handlers/config.go: named config rows) ------
    @route("GET", "/api/v1/configs")
    def list_configs(self, req):
        return self.db.query("SELECT * FROM configs ORDER BY id")

    @staticmethod
    def _config_text(v) -> str:
        # structured values stored as JSON (like cluster config fields),
        # scalars as plain text — never Python repr
        return json.dumps(v) if isinstance(v, (dict, list)) else str(v)

    @route("POST", "/api/v1/configs", write=True)
    def create_config(self, req):
        body = req["body"]
        if not body.get("name") or not isinstance(body["name"], str):
            raise ApiError(400, "name is required")
        now = time.time()
        cur = self.db.execute(
            "INSERT INTO configs (name, value, bio, created_at, updated_at)"
            " VALUES (?, ?, ?, ?, ?)",
            (
                body["name"],
                self._config_text(body.get("value", "")),
                self._config_text(body.get("bio", "")),
                now,
                now,
            ),
        )
        return self.db.query_one("SELECT * FROM configs WHERE id = ?", (cur.lastrowid,))

    @route("GET", "/api/v1/configs/:id")
    def get_config(self, req):
        # numeric path param addresses by id, anything else by name —
        # never both at once (an id-lookup must not resolve some OTHER
        # row whose name happens to be that number)
        ident = req["id"]
        if ident.isdigit():
            row = self.db.query_one("SELECT * FROM configs WHERE id = ?", (int(ident),))
        else:
            row = self.db.query_one("SELECT * FROM configs WHERE name = ?", (ident,))
        if row is None:
            raise ApiError(404, "config not found")
        return row

    @route("PATCH", "/api/v1/configs/:id", write=True)
    def update_config(self, req):
        row = self.get_config(req)
        body = req["body"]
        if "name" in body and (not body["name"] or not isinstance(body["name"], str)):
            raise ApiError(400, "name cannot be empty")
        updates = {
            k: self._config_text(body[k]) for k in ("name", "value", "bio") if k in body
        }
        if updates:
            sets = ", ".join(f"{k} = ?" for k in updates)
            self.db.execute(
                f"UPDATE configs SET {sets}, updated_at = ? WHERE id = ?",
                (*updates.values(), time.time(), row["id"]),
            )
        return self.db.query_one("SELECT * FROM configs WHERE id = ?", (row["id"],))

    @route("DELETE", "/api/v1/configs/:id", write=True)
    def delete_config(self, req):
        row = self.get_config(req)
        self.db.execute("DELETE FROM configs WHERE id = ?", (row["id"],))
        return {"deleted": row["id"]}

    # -- buckets (upstream handlers/bucket.go over pkg/objectstorage) --
    @route("GET", "/api/v1/buckets")
    def list_buckets(self, req):
        storage = self.models.storage
        if not hasattr(storage, "list_buckets"):
            raise ApiError(501, "bucket listing unsupported by this storage driver")
        return [{"name": b} for b in storage.list_buckets()]

    @route("POST", "/api/v1/buckets", write=True)
    def create_bucket(self, req):
        name = req["body"].get("name", "")
        if not isinstance(name, str) or not name or "/" in name or name.startswith("."):
            raise ApiError(400, "a bucket needs a plain name")
        self.models.storage.create_bucket(name)
        return {"name": name}

    @route("GET", "/api/v1/buckets/:name")
    def get_bucket(self, req):
        storage = self.models.storage
        if hasattr(storage, "list_buckets") and req["name"] not in storage.list_buckets():
            raise ApiError(404, "bucket not found")
        try:
            objects = len(storage.list_objects(req["name"]))
        except Exception:
            # backends without list_buckets (S3/OSS) surface a missing
            # bucket here — that's a 404, not a server fault
            raise ApiError(404, "bucket not found")
        return {"name": req["name"], "objects": objects}

    @route("DELETE", "/api/v1/buckets/:name", write=True)
    def delete_bucket(self, req):
        storage = self.models.storage
        if not hasattr(storage, "delete_bucket"):
            raise ApiError(501, "bucket deletion unsupported by this storage driver")
        storage.delete_bucket(req["name"])
        return {"deleted": req["name"]}

    @route("GET", "/api/v1/applications")
    def list_applications(self, req):
        return self.db.query("SELECT * FROM applications ORDER BY id")

    @route("POST", "/api/v1/applications", write=True)
    def create_application(self, req):
        body = req["body"]
        if not body.get("name"):
            raise ApiError(400, "name is required")
        now = time.time()
        cur = self.db.execute(
            "INSERT INTO applications (name, url, priority, created_at, updated_at)"
            " VALUES (?, ?, ?, ?, ?)",
            (
                body["name"],
                body.get("url", ""),
                json.dumps(body.get("priority", {})),
                now,
                now,
            ),
        )
        return self.db.query_one(
            "SELECT * FROM applications WHERE id = ?", (cur.lastrowid,)
        )

    @route("GET", "/api/v1/applications/:id")
    def get_application(self, req):
        row = self.db.query_one(
            "SELECT * FROM applications WHERE id = ?", (int(req["id"]),)
        )
        if row is None:
            raise ApiError(404, "application not found")
        return row

    @route("PATCH", "/api/v1/applications/:id", write=True)
    def update_application(self, req):
        body = req["body"]
        sets, params = [], []
        for col in ("name", "url"):
            if col in body:
                sets.append(f"{col} = ?")
                params.append(body[col])
        if "priority" in body:
            sets.append("priority = ?")
            v = body["priority"]
            params.append(v if isinstance(v, str) else json.dumps(v))
        if not sets:
            raise ApiError(400, "no updatable fields in body")
        sets.append("updated_at = ?")
        params += [time.time(), int(req["id"])]
        cur = self.db.execute(
            f"UPDATE applications SET {', '.join(sets)} WHERE id = ?", tuple(params)
        )
        if cur.rowcount == 0:
            raise ApiError(404, "application not found")
        return self.get_application(req)

    @route("DELETE", "/api/v1/applications/:id", write=True)
    def delete_application(self, req):
        self.db.execute("DELETE FROM applications WHERE id = ?", (int(req["id"]),))
        return {"deleted": int(req["id"])}

    # -- seed-peer clusters (upstream router.go:159-168) -----------------
    @route("GET", "/api/v1/seed-peer-clusters")
    def list_seed_peer_clusters(self, req):
        return self.db.query("SELECT * FROM seed_peer_clusters ORDER BY id")

    @route("POST", "/api/v1/seed-peer-clusters", write=True)
    def create_seed_peer_cluster(self, req):
        body = req["body"]
        if not body.get("name"):
            raise ApiError(400, "name is required")
        now = time.time()
        cur = self.db.execute(
            "INSERT INTO seed_peer_clusters (name, config, created_at, updated_at)"
            " VALUES (?, ?, ?, ?)",
            (
                body["name"],
                json.dumps(body.get("config", {})),
                now,
                now,
            ),
        )
        return self.db.query_one(
            "SELECT * FROM seed_peer_clusters WHERE id = ?", (cur.lastrowid,)
        )

    @route("GET", "/api/v1/seed-peer-clusters/:id")
    def get_seed_peer_cluster(self, req):
        row = self.db.query_one(
            "SELECT * FROM seed_peer_clusters WHERE id = ?", (int(req["id"]),)
        )
        if row is None:
            raise ApiError(404, "seed peer cluster not found")
        return row

    @route("PATCH", "/api/v1/seed-peer-clusters/:id", write=True)
    def update_seed_peer_cluster(self, req):
        body = req["body"]
        sets, params = [], []
        if "name" in body:
            sets.append("name = ?")
            params.append(body["name"])
        if "config" in body:
            v = body["config"]
            sets.append("config = ?")
            params.append(v if isinstance(v, str) else json.dumps(v))
        if not sets:
            raise ApiError(400, "no updatable fields in body")
        sets.append("updated_at = ?")
        params += [time.time(), int(req["id"])]
        cur = self.db.execute(
            f"UPDATE seed_peer_clusters SET {', '.join(sets)} WHERE id = ?",
            tuple(params),
        )
        if cur.rowcount == 0:
            raise ApiError(404, "seed peer cluster not found")
        return self.get_seed_peer_cluster(req)

    @route("DELETE", "/api/v1/seed-peer-clusters/:id", write=True)
    def delete_seed_peer_cluster(self, req):
        self.db.execute(
            "DELETE FROM seed_peer_clusters WHERE id = ?", (int(req["id"]),)
        )
        return {"deleted": int(req["id"])}

    @route("PUT", "/api/v1/seed-peer-clusters/:id/seed-peers/:seed_peer_id", write=True)
    def add_seed_peer_to_cluster(self, req):
        """Re-home a seed peer into a cluster (reference
        AddSeedPeerToSeedPeerCluster)."""
        if self.db.query_one(
            "SELECT id FROM seed_peer_clusters WHERE id = ?", (int(req["id"]),)
        ) is None:
            raise ApiError(404, "seed peer cluster not found")
        cur = self.db.execute(
            "UPDATE seed_peers SET seed_peer_cluster_id = ?, updated_at = ?"
            " WHERE id = ?",
            (int(req["id"]), time.time(), int(req["seed_peer_id"])),
        )
        if cur.rowcount == 0:
            raise ApiError(404, "seed peer not found")
        return {"seed_peer_cluster_id": int(req["id"]),
                "seed_peer_id": int(req["seed_peer_id"])}

    # -- users read (upstream GetUser, router.go:99)
    @route("GET", "/api/v1/users/:id")
    def get_user(self, req):
        row = self.db.query_one(
            "SELECT id, name, email, role, state, created_at, updated_at"
            " FROM users WHERE id = ?",
            (int(req["id"]),),
        )
        if row is None:
            raise ApiError(404, "user not found")
        return row

    # -- jobs PATCH/DELETE (upstream router.go:202-203)
    @route("PATCH", "/api/v1/jobs/:id", write=True)
    def update_job(self, req):
        body = req["body"]
        sets, params = [], []
        if "state" in body:
            if body["state"] not in ("queued", "running", "succeeded", "failed"):
                raise ApiError(400, "invalid state")
            sets.append("state = ?")
            params.append(body["state"])
        if "result" in body:
            v = body["result"]
            sets.append("result = ?")
            params.append(v if isinstance(v, str) else json.dumps(v))
        if not sets:
            raise ApiError(400, "no updatable fields in body")
        sets.append("updated_at = ?")
        params += [time.time(), int(req["id"])]
        cur = self.db.execute(
            f"UPDATE jobs SET {', '.join(sets)} WHERE id = ?", tuple(params)
        )
        if cur.rowcount == 0:
            raise ApiError(404, "job not found")
        return self.get_job(req)

    @route("DELETE", "/api/v1/jobs/:id", write=True)
    def delete_job(self, req):
        self.db.execute("DELETE FROM jobs WHERE id = ?", (int(req["id"]),))
        return {"deleted": int(req["id"])}

    # -- scheduler / seed-peer write surface (upstream router.go:151-174:
    # instances normally register over gRPC keepalive; the REST writes
    # exist for operators pre-provisioning or correcting rows)
    @route("POST", "/api/v1/schedulers", write=True)
    def create_scheduler(self, req):
        body = req["body"]
        if not body.get("hostname") or not body.get("ip"):
            raise ApiError(400, "hostname and ip are required")
        now = time.time()
        cur = self.db.execute(
            "INSERT INTO schedulers (hostname, ip, port, idc, location, state,"
            " scheduler_cluster_id, created_at, updated_at)"
            " VALUES (?, ?, ?, ?, ?, 'inactive', ?, ?, ?)",
            (
                body["hostname"], body["ip"], int(body.get("port", 8002)),
                body.get("idc", ""), body.get("location", ""),
                int(body.get("scheduler_cluster_id", 1)), now, now,
            ),
        )
        return self.db.query_one(
            "SELECT * FROM schedulers WHERE id = ?", (cur.lastrowid,)
        )

    @route("PATCH", "/api/v1/schedulers/:id", write=True)
    def update_scheduler(self, req):
        body = req["body"]
        sets, params = [], []
        for col in ("idc", "location", "state"):
            if col in body:
                sets.append(f"{col} = ?")
                params.append(body[col])
        if "scheduler_cluster_id" in body:
            sets.append("scheduler_cluster_id = ?")
            params.append(int(body["scheduler_cluster_id"]))
        if not sets:
            raise ApiError(400, "no updatable fields in body")
        sets.append("updated_at = ?")
        params += [time.time(), int(req["id"])]
        cur = self.db.execute(
            f"UPDATE schedulers SET {', '.join(sets)} WHERE id = ?", tuple(params)
        )
        if cur.rowcount == 0:
            raise ApiError(404, "scheduler not found")
        return self.get_scheduler(req)

    @route("POST", "/api/v1/seed-peers", write=True)
    def create_seed_peer(self, req):
        body = req["body"]
        if not body.get("hostname") or not body.get("ip"):
            raise ApiError(400, "hostname and ip are required")
        now = time.time()
        cur = self.db.execute(
            "INSERT INTO seed_peers (hostname, ip, port, download_port, type,"
            " idc, location, state, seed_peer_cluster_id, created_at, updated_at)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, 'inactive', ?, ?, ?)",
            (
                body["hostname"], body["ip"], int(body.get("port", 8002)),
                int(body.get("download_port", 0)), body.get("type", "super"),
                body.get("idc", ""), body.get("location", ""),
                int(body.get("seed_peer_cluster_id", 1)), now, now,
            ),
        )
        return self.db.query_one(
            "SELECT * FROM seed_peers WHERE id = ?", (cur.lastrowid,)
        )

    @route("PATCH", "/api/v1/seed-peers/:id", write=True)
    def update_seed_peer(self, req):
        body = req["body"]
        sets, params = [], []
        for col in ("idc", "location", "state", "type"):
            if col in body:
                sets.append(f"{col} = ?")
                params.append(body[col])
        if "seed_peer_cluster_id" in body:
            sets.append("seed_peer_cluster_id = ?")
            params.append(int(body["seed_peer_cluster_id"]))
        if not sets:
            raise ApiError(400, "no updatable fields in body")
        sets.append("updated_at = ?")
        params += [time.time(), int(req["id"])]
        cur = self.db.execute(
            f"UPDATE seed_peers SET {', '.join(sets)} WHERE id = ?", tuple(params)
        )
        if cur.rowcount == 0:
            raise ApiError(404, "seed peer not found")
        return self.get_seed_peer(req)

    @route("DELETE", "/api/v1/seed-peers/:id", write=True)
    def delete_seed_peer(self, req):
        self.db.execute("DELETE FROM seed_peers WHERE id = ?", (int(req["id"]),))
        return {"deleted": int(req["id"])}

    @route("PUT", "/api/v1/scheduler-clusters/:id/schedulers/:scheduler_id", write=True)
    def add_scheduler_to_cluster(self, req):
        """Re-home a scheduler into a cluster (reference
        AddSchedulerToSchedulerCluster)."""
        if self.db.query_one(
            "SELECT id FROM scheduler_clusters WHERE id = ?", (int(req["id"]),)
        ) is None:
            raise ApiError(404, "scheduler cluster not found")
        cur = self.db.execute(
            "UPDATE schedulers SET scheduler_cluster_id = ?, updated_at = ?"
            " WHERE id = ?",
            (int(req["id"]), time.time(), int(req["scheduler_id"])),
        )
        if cur.rowcount == 0:
            raise ApiError(404, "scheduler not found")
        return {"scheduler_cluster_id": int(req["id"]),
                "scheduler_id": int(req["scheduler_id"])}

    # -- v1-compat preheat + ping (upstream router.go:283-289, kept for
    # old clients: a thin alias over the jobs queue)
    @route("GET", "/_ping", auth=False)
    def ping(self, req):
        return {"status": "ok"}

    @route("POST", "/preheats", write=True)
    def create_v1_preheat(self, req):
        body = req["body"]
        url = (body.get("url") or "").strip()
        if not url:
            raise ApiError(400, "url is required")
        job = self.create_job(
            {**req, "body": {"type": "preheat", "args": {"url": url}}}
        )
        return {"id": str(job["id"]), "status": job["state"]}

    @route("GET", "/preheats/:id")
    def get_v1_preheat(self, req):
        job = self.get_job(req)
        return {"id": str(job["id"]), "status": job["state"]}

    # -- open API (upstream router.go:262-281: /oapi/v1 groups gated by
    # personal access tokens — here PATs already authenticate every
    # bearer route, so these are first-class aliases of the same
    # handlers for automation clients)
    @route("GET", "/oapi/v1/jobs")
    def oapi_list_jobs(self, req):
        return self.list_jobs(req)

    @route("POST", "/oapi/v1/jobs", write=True)
    def oapi_create_job(self, req):
        return self.create_job(req)

    @route("GET", "/oapi/v1/jobs/:id")
    def oapi_get_job(self, req):
        return self.get_job(req)

    @route("PATCH", "/oapi/v1/jobs/:id", write=True)
    def oapi_update_job(self, req):
        return self.update_job(req)

    @route("DELETE", "/oapi/v1/jobs/:id", write=True)
    def oapi_delete_job(self, req):
        return self.delete_job(req)

    # -- composite clusters group (upstream router.go:133-139: the main
    # UI resource — one "cluster" = a scheduler cluster and its paired
    # seed-peer cluster, created/listed together)
    @route("GET", "/api/v1/clusters")
    def list_clusters(self, req):
        out = []
        spc_by_name = {
            r["name"]: r
            for r in self.db.query("SELECT * FROM seed_peer_clusters")
        }
        for sc in self.db.query("SELECT * FROM scheduler_clusters ORDER BY id"):
            spc = spc_by_name.get(sc["name"])
            out.append(
                {
                    "id": sc["id"],
                    "name": sc["name"],
                    "scheduler_cluster": sc,
                    "seed_peer_cluster": spc,
                }
            )
        return out

    @route("POST", "/api/v1/clusters", write=True)
    def create_cluster(self, req):
        """One call provisions the scheduler cluster AND its paired
        seed-peer cluster under a shared name (upstream CreateCluster)."""
        body = req["body"]
        if not body.get("name"):
            raise ApiError(400, "name is required")
        # pre-check BOTH names: the composite must not half-create (a
        # scheduler cluster with no pair) when either side collides —
        # sqlite has no cross-statement transaction here, so collision
        # is answered before any write
        for table in ("scheduler_clusters", "seed_peer_clusters"):
            if self.db.query_one(
                f"SELECT id FROM {table} WHERE name = ?", (body["name"],)
            ) is not None:
                raise ApiError(409, f"{table[:-1]} named {body['name']!r} exists")
        sc = self.create_scheduler_cluster(
            {**req, "body": {
                "name": body["name"],
                "config": body.get("scheduler_cluster_config", {}),
                "client_config": body.get("client_config", {}),
                "scopes": body.get("scopes", {}),
                "is_default": body.get("is_default", False),
            }}
        )
        spc = self.create_seed_peer_cluster(
            {**req, "body": {
                "name": body["name"],
                "config": body.get("seed_peer_cluster_config", {}),
            }}
        )
        return {"id": sc["id"], "name": sc["name"],
                "scheduler_cluster": sc, "seed_peer_cluster": spc}

    @route("GET", "/api/v1/clusters/:id")
    def get_cluster(self, req):
        sc = self.get_scheduler_cluster(req)
        spc = self.db.query_one(
            "SELECT * FROM seed_peer_clusters WHERE name = ?", (sc["name"],)
        )
        return {"id": sc["id"], "name": sc["name"],
                "scheduler_cluster": sc, "seed_peer_cluster": spc}

    @route("PATCH", "/api/v1/clusters/:id", write=True)
    def update_cluster(self, req):
        """Composite update: scheduler-cluster fields apply directly;
        seed_peer_cluster_config applies to the paired cluster; a rename
        renames BOTH sides (the pairing is by name, so renaming only one
        would orphan the other)."""
        body = dict(req["body"])
        spc_cfg = body.pop("seed_peer_cluster_config", None)
        # resolve the pair by the CURRENT name before any rename
        sc_before = self.get_scheduler_cluster(req)
        spc = self.db.query_one(
            "SELECT id FROM seed_peer_clusters WHERE name = ?", (sc_before["name"],)
        )
        if body:
            self.update_scheduler_cluster({**req, "body": body})
        if spc is not None:
            spc_body = {}
            if "name" in body:
                spc_body["name"] = body["name"]
            if spc_cfg is not None:
                spc_body["config"] = spc_cfg
            if spc_body:
                self.update_seed_peer_cluster(
                    {**req, "id": str(spc["id"]), "body": spc_body}
                )
        return self.get_cluster(req)

    @route("DELETE", "/api/v1/clusters/:id", write=True)
    def delete_cluster(self, req):
        sc = self.get_scheduler_cluster(req)
        self.db.execute(
            "DELETE FROM seed_peer_clusters WHERE name = ?", (sc["name"],)
        )
        return self.delete_scheduler_cluster(req)

    @route("GET", "/oapi/v1/clusters")
    def oapi_list_clusters(self, req):
        return self.list_scheduler_clusters(req)

    @route("POST", "/oapi/v1/clusters", write=True)
    def oapi_create_cluster(self, req):
        return self.create_scheduler_cluster(req)

    @route("GET", "/oapi/v1/clusters/:id")
    def oapi_get_cluster(self, req):
        return self.get_scheduler_cluster(req)

    @route("PATCH", "/oapi/v1/clusters/:id", write=True)
    def oapi_update_cluster(self, req):
        return self.update_scheduler_cluster(req)

    @route("DELETE", "/oapi/v1/clusters/:id", write=True)
    def oapi_delete_cluster(self, req):
        return self.delete_scheduler_cluster(req)


class RestServer:
    def __init__(
        self,
        service: ManagerService,
        host: str = "127.0.0.1",
        port: int = 0,
        tokens: dict[str, str] | None = None,
    ):
        self.api = RestApi(service)
        self.tokens = dict(tokens or {})  # token -> role ("admin"|"guest")
        self.host = host
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def _auth_info(self, auth_header: str | None) -> tuple[str | None, int | None]:
        """→ (role, owning user id), or (None, None) when
        unauthenticated. Config tokens are checked first (they have no
        DB user, so no owner id), then DB-backed personal access tokens
        — resolved ONCE here; handlers needing the owner (per-user PAT
        routes) read it from the request instead of re-querying. No
        config tokens AND no users = open admin access (dev mode, like
        upstream without auth)."""
        from dragonfly2_torch.manager import auth

        token = ""
        if auth_header and auth_header.startswith("Bearer "):
            token = auth_header[7:]
        if token:
            role = self.tokens.get(token)
            if role is not None:
                return role, None
            row = auth._resolve_token_row(self.api.db, token)
            if row is not None:
                return row["role"], int(row["user_id"])
        if not self.tokens and not self._has_admin():
            return "admin", None
        return None, None

    def _has_admin(self) -> bool:
        """Anonymous dev-mode admin ends when an ADMIN credential exists
        — not when any user does: an OAuth passerby auto-provisioned as
        guest must not close the bootstrap window and lock every write
        route with no admin account in existence."""
        return (
            self.api.db.query_one(
                "SELECT id FROM users WHERE role = 'admin' LIMIT 1"
            )
            is not None
        )

    def start(self) -> str:
        api = self.api
        auth_info = self._auth_info

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to dflog, not stderr
                logger.debug("%s " + fmt, self.client_address[0], *args)

            def _dispatch(self):
                from urllib.parse import parse_qsl, urlsplit

                parts = urlsplit(self.path)
                # embedded console: a static page (unauthenticated, like
                # any static asset — its data calls carry the token); the
                # upstream embeds its React console the same way
                # (manager/manager.go:61-85)
                if self.command == "GET" and parts.path in ("/", "/console"):
                    from dragonfly2_torch.manager.console import index_html

                    data = index_html()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                query = dict(parse_qsl(parts.query))
                auth_header = self.headers.get("Authorization") or ""
                bearer = (
                    auth_header[7:] if auth_header.startswith("Bearer ") else ""
                )
                role, auth_user_id = auth_info(self.headers.get("Authorization"))
                for method, rx, fname, write, needs_auth, _pattern in _ROUTES:
                    if method != self.command:
                        continue
                    m = rx.match(parts.path)
                    if not m:
                        continue
                    # auth=False routes (health probe, password signin,
                    # OAuth redirect/callback legs) stay open — a
                    # per-route flag, so nothing else inherits it
                    if role is None and needs_auth:
                        return self._send(401, {"error": "unauthorized"})
                    if write and role != "admin":
                        return self._send(403, {"error": "forbidden (read-only role)"})
                    body = {}
                    length = int(self.headers.get("Content-Length") or 0)
                    if length:
                        try:
                            body = json.loads(self.rfile.read(length))
                        except ValueError:
                            return self._send(400, {"error": "invalid JSON body"})
                    # the bearer token rides along for the session
                    # routes (signout revokes it, refresh_token rotates
                    # it); the caller's role under a NON-COLLIDING key —
                    # path params (e.g. :role) must always win
                    req = {
                        "body": body,
                        "query": query,
                        "token": bearer,
                        "auth_role": role,
                        "auth_user_id": auth_user_id,
                        **m.groupdict(),
                    }
                    try:
                        return self._send(200, getattr(api, fname)(req))
                    except Redirect as r:
                        return self._send(
                            302, {"location": r.location}, location=r.location
                        )
                    except ApiError as e:
                        return self._send(e.status, {"error": str(e)})
                    except sqlite3.IntegrityError as e:
                        # UNIQUE/foreign-key violations are client
                        # mistakes (duplicate name), not server faults
                        return self._send(409, {"error": str(e)})
                    except ValueError as e:
                        # non-numeric path/query params etc. are client
                        # errors, not server faults
                        return self._send(400, {"error": str(e)})
                    except Exception as e:  # pragma: no cover - defensive
                        logger.exception("REST handler failed")
                        return self._send(500, {"error": str(e)})
                self._send(404, {"error": f"no route for {self.command} {parts.path}"})

            def _send(self, status: int, payload, location: str | None = None):
                from dragonfly2_torch.manager import metrics as M

                M.REST_REQUEST_TOTAL.labels(self.command, str(status)).inc()
                data = json.dumps(payload, default=str).encode()
                self.send_response(status)
                if location is not None:
                    self.send_header("Location", location)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _dispatch

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="manager.rest", daemon=True
        )
        self._thread.start()
        return f"{self.host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
