"""The port's manager REST front (``dragonfly2_torch.manager.rest``,
``auth`` and ``console``) against the reference's.

- The reference's ``tests/test_manager_rest.py``, case for case, on the
  port's ``RestServer``, ``Database``, ``ModelRegistry`` and
  ``ManagerService``; its OAuth cases sign in through a fake identity
  provider on loopback, and its census holds the port's route table to
  the reference's row by row.
- Across the packages, every server on port 0 and stopped by its fixture:
  one request sequence — clusters, schedulers, seed peers, jobs and
  groups, models with activation, users, tokens, roles, OAuth, configs,
  buckets, applications, peers and the ``/oapi`` and ``/preheats``
  aliases — sent to a reference front and a port front, each over a
  fresh database, must be answered with the same statuses and bodies
  once timestamps, tokens, group ids and OAuth states are masked; the
  OpenAPI documents are equal and so are the console pages; a user and
  a personal access token made through one package's front authenticate
  through the other's over one database file, both ways."""

import json
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from dragonfly2_torch.manager import auth as t_auth
from dragonfly2_torch.manager import console as t_console
from dragonfly2_torch.manager import rest as t_rest
from dragonfly2_torch.manager.database import Database
from dragonfly2_torch.manager.models_registry import ModelRegistry
from dragonfly2_torch.manager.objectstorage import FSObjectStorage
from dragonfly2_torch.manager.rest import RestServer
from dragonfly2_torch.manager.service import ManagerService
from dragonfly2_torch.rpc import glue
from dragonfly2_torch.rpc import protos
from dragonfly2_tpu.manager import auth as j_auth
from dragonfly2_tpu.manager import console as j_console
from dragonfly2_tpu.manager import database as j_database
from dragonfly2_tpu.manager import models_registry as j_registry
from dragonfly2_tpu.manager import objectstorage as j_objectstorage
from dragonfly2_tpu.manager import rest as j_rest
from dragonfly2_tpu.manager import service as j_service

manager_pb2 = protos.load("manager_pb2")


@pytest.fixture
def rest(tmp_path):
    db = Database(tmp_path / "m.db")
    models = ModelRegistry(db, FSObjectStorage(tmp_path / "obj"))
    service = ManagerService(db, models)
    server = RestServer(
        service, tokens={"admin-tok": "admin", "guest-tok": "guest"}
    )
    addr = server.start()
    yield {"addr": addr, "db": db, "models": models, "service": service}
    server.stop()
    db.close()


def call(addr, method, path, body=None, token="admin-tok"):
    req = urllib.request.Request(
        f"http://{addr}{path}",
        method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Authorization": f"Bearer {token}"} if token else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health_and_auth(rest):
    addr = rest["addr"]
    status, body = call(addr, "GET", "/healthy")
    assert status == 200 and body["status"] == "ok"
    # no token → 401
    status, body = call(addr, "GET", "/api/v1/schedulers", token=None)
    assert status == 401
    # bad token → 401
    status, body = call(addr, "GET", "/api/v1/schedulers", token="nope")
    assert status == 401
    # guest can read
    status, body = call(addr, "GET", "/api/v1/schedulers", token="guest-tok")
    assert status == 200 and body == []
    # guest cannot write
    status, body = call(
        addr, "POST", "/api/v1/scheduler-clusters", {"name": "x"}, token="guest-tok"
    )
    assert status == 403


def test_cluster_crud(rest):
    addr = rest["addr"]
    status, created = call(
        addr,
        "POST",
        "/api/v1/scheduler-clusters",
        {"name": "cluster-2", "config": {"candidate_parent_limit": 7}},
    )
    assert status == 200
    cid = created["id"]
    status, got = call(addr, "GET", f"/api/v1/scheduler-clusters/{cid}")
    assert status == 200 and got["name"] == "cluster-2"
    assert json.loads(got["config"])["candidate_parent_limit"] == 7
    status, updated = call(
        addr, "PATCH", f"/api/v1/scheduler-clusters/{cid}", {"config": {"a": 1}}
    )
    assert status == 200 and json.loads(updated["config"]) == {"a": 1}
    status, _ = call(addr, "DELETE", f"/api/v1/scheduler-clusters/{cid}")
    assert status == 200
    status, _ = call(addr, "GET", f"/api/v1/scheduler-clusters/{cid}")
    assert status == 404


def test_jobs_roundtrip(rest):
    addr = rest["addr"]
    status, job = call(
        addr,
        "POST",
        "/api/v1/jobs",
        {"type": "preheat", "args": {"url": "https://x/blob"}, "scheduler_cluster_id": 1},
    )
    assert status == 200 and job["state"] == "queued"
    status, got = call(addr, "GET", f"/api/v1/jobs/{job['id']}")
    assert status == 200 and got["type"] == "preheat"
    status, jobs = call(addr, "GET", "/api/v1/jobs")
    assert status == 200 and len(jobs) == 1


def test_model_activation_flow(rest):
    """Upload two versions via the registry, flip activation through
    REST, verify the previously-active version deactivates (upstream
    updateModelStateToActive version flip)."""
    addr = rest["addr"]
    models: ModelRegistry = rest["models"]
    weights = np.arange(4, dtype=np.float32).tobytes()
    models.create("mlp-host-1", "mlp", weights, {"mse": 0.5}, ip="1.2.3.4",
                  hostname="h1", scheduler_cluster_id=1)
    models.create("mlp-host-1", "mlp", weights, {"mse": 0.4}, ip="1.2.3.4",
                  hostname="h1", scheduler_cluster_id=1)

    status, listed = call(addr, "GET", "/api/v1/models?scheduler_cluster_id=1")
    assert status == 200 and len(listed) == 2
    assert all(m["state"] == "inactive" for m in listed)

    status, act = call(
        addr, "PUT", "/api/v1/models/mlp-host-1/versions/1/state", {"state": "active"}
    )
    assert status == 200 and act["state"] == "active"

    status, act2 = call(
        addr, "PUT", "/api/v1/models/mlp-host-1/versions/2/state", {"state": "active"}
    )
    assert status == 200 and act2["state"] == "active"
    # version 1 flipped back to inactive
    status, v1 = call(addr, "GET", "/api/v1/models/mlp-host-1/versions/1")
    assert status == 200 and v1["state"] == "inactive"

    status, _ = call(addr, "DELETE", "/api/v1/models/mlp-host-1/versions/1")
    assert status == 200
    status, _ = call(addr, "GET", "/api/v1/models/mlp-host-1/versions/1")
    assert status == 404


def test_applications(rest):
    addr = rest["addr"]
    status, app = call(
        addr, "POST", "/api/v1/applications",
        {"name": "registry", "url": "https://r.io", "priority": {"level": 3}},
    )
    assert status == 200
    status, apps = call(addr, "GET", "/api/v1/applications")
    assert status == 200 and apps[0]["name"] == "registry"


def test_open_mode_without_tokens(tmp_path):
    db = Database(tmp_path / "m.db")
    service = ManagerService(db, ModelRegistry(db, FSObjectStorage(tmp_path / "o")))
    server = RestServer(service)  # no tokens = dev mode
    addr = server.start()
    try:
        status, _ = call(addr, "GET", "/api/v1/schedulers", token=None)
        assert status == 200
    finally:
        server.stop()
        db.close()


def test_healthy_is_unauthenticated(rest):
    status, body = call(rest["addr"], "GET", "/healthy", token=None)
    assert status == 200 and body["status"] == "ok"


def test_bad_path_param_is_client_error(rest):
    status, body = call(rest["addr"], "GET", "/api/v1/schedulers/abc")
    assert status == 400


def test_deactivate_stamps_updated_at(rest):
    import numpy as np

    models = rest["models"]
    models.create("m1", "mlp", b"\x00", {"mse": 1.0}, scheduler_cluster_id=1)
    models.activate("m1", 1)
    before = models.get("m1", 1).updated_at
    import time

    time.sleep(0.01)
    status, row = call(
        rest["addr"], "PUT", "/api/v1/models/m1/versions/1/state", {"state": "inactive"}
    )
    assert status == 200 and row["state"] == "inactive"
    assert models.get("m1", 1).updated_at > before


def test_console_served_at_root(rest):
    """The embedded console page is served at / and /console without auth
    (static asset; its data calls carry the token — upstream embeds its
    React console the same way, manager/manager.go:61-85)."""
    for path in ("/", "/console"):
        req = urllib.request.Request(f"http://{rest['addr']}{path}")
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/html")
            page = resp.read().decode()
    # the page drives the same REST surface this test drives
    assert "/api/v1/scheduler-clusters" in page
    assert "/api/v1/models" in page
    assert "setModelState" in page


def test_users_and_pats(tmp_path):
    """DB-backed users + personal access tokens: bootstrap in dev mode,
    then auth flips on — PATs and signin tokens resolve to roles, config
    tokens keep working (upstream manager users/PAT surface)."""
    db = Database(tmp_path / "u.db")
    models = ModelRegistry(db, FSObjectStorage(tmp_path / "obj"))
    server = RestServer(ManagerService(db, models))  # no config tokens
    addr = server.start()
    try:
        # dev mode: open admin until the first user exists
        status, _ = call(addr, "GET", "/api/v1/users", token=None)
        assert status == 200
        status, admin = call(
            addr, "POST", "/api/v1/users",
            {"name": "root", "password": "s3cret", "role": "admin"}, token=None,
        )
        assert status == 200 and "password_hash" not in admin
        # auth is now enforced
        status, _ = call(addr, "GET", "/api/v1/users", token=None)
        assert status == 401
        # signin exchanges the password for a session token
        status, session = call(
            addr, "POST", "/api/v1/users/signin",
            {"name": "root", "password": "s3cret"}, token=None,
        )
        assert status == 200 and session["role"] == "admin"
        tok = session["token"]
        # bad password refused
        status, _ = call(
            addr, "POST", "/api/v1/users/signin",
            {"name": "root", "password": "wrong"}, token=None,
        )
        assert status == 401
        # the session token authenticates as admin
        status, _ = call(addr, "GET", "/api/v1/users", token=tok)
        assert status == 200
        # mint a guest user + PAT: read-only enforcement
        status, guest = call(
            addr, "POST", "/api/v1/users",
            {"name": "viewer", "password": "pw", "role": "guest"}, token=tok,
        )
        status, pat = call(
            addr, "POST", f"/api/v1/users/{guest['id']}/personal-access-tokens",
            {"name": "ci"}, token=tok,
        )
        assert status == 200 and pat["token"].startswith("dfp_")
        status, _ = call(addr, "GET", "/api/v1/schedulers", token=pat["token"])
        assert status == 200
        status, _ = call(
            addr, "POST", "/api/v1/scheduler-clusters", {"name": "x"},
            token=pat["token"],
        )
        assert status == 403  # guest is read-only
        # revocation kills the token
        status, _ = call(
            addr, "DELETE",
            f"/api/v1/users/{guest['id']}/personal-access-tokens/{pat['id']}",
            token=tok,
        )
        assert status == 200
        status, _ = call(addr, "GET", "/api/v1/schedulers", token=pat["token"])
        assert status == 401
        # disabling a user kills their remaining tokens
        status, pat2 = call(
            addr, "POST", f"/api/v1/users/{guest['id']}/personal-access-tokens",
            {"name": "ci2"}, token=tok,
        )
        call(addr, "PATCH", f"/api/v1/users/{guest['id']}", {"state": "disabled"}, token=tok)
        status, _ = call(addr, "GET", "/api/v1/schedulers", token=pat2["token"])
        assert status == 401
    finally:
        server.stop()
        db.close()


# ---------------------------------------------------------------------------
# OAuth sign-in (upstream manager/handlers/oauth.go + auth/oauth/)
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_idp():
    """OAuth2 provider fake: token endpoint validating client creds +
    code, userinfo endpoint validating the bearer token."""
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    seen = {"token_body": None}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            if self.path != "/token":
                self.send_error(404)
                return
            body = dict(
                urllib.parse.parse_qsl(
                    self.rfile.read(int(self.headers["Content-Length"])).decode()
                )
            )
            seen["token_body"] = body
            if (
                body.get("client_id") == "cid"
                and body.get("client_secret") == "csec"
                and body.get("code") == "good-code"
            ):
                payload = json.dumps({"access_token": "at-1", "token_type": "bearer"})
                self.send_response(200)
            else:
                payload = json.dumps({"error": "invalid_grant"})
                self.send_response(200)  # oauth2 errors ride 200+JSON too
            data = payload.encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path != "/userinfo":
                self.send_error(404)
                return
            if self.headers.get("Authorization") != "Bearer at-1":
                self.send_error(401)
                return
            data = json.dumps(
                {"id": 424242, "login": "octo", "email": "octo@example.com"}
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield {"base": f"http://127.0.0.1:{httpd.server_port}", "seen": seen}
    httpd.shutdown()
    httpd.server_close()


def _make_provider(addr, base):
    status, body = call(
        addr,
        "POST",
        "/api/v1/oauth",
        {
            "name": "fakehub",
            "client_id": "cid",
            "client_secret": "csec",
            "redirect_url": "http://console.local/callback",
            "auth_url": f"{base}/authorize",
            "token_url": f"{base}/token",
            "userinfo_url": f"{base}/userinfo",
            "scopes": "read:user",
        },
    )
    assert status == 200, body
    return body


def test_oauth_provider_crud_redacts_secret(rest, fake_idp):
    addr = rest["addr"]
    created = _make_provider(addr, fake_idp["base"])
    assert "client_secret" not in created and "token_url" not in created
    status, listed = call(addr, "GET", "/api/v1/oauth", token="guest-tok")
    assert status == 200 and listed[0]["name"] == "fakehub"
    status, got = call(addr, "PATCH", f"/api/v1/oauth/{created['id']}", {"bio": "x"})
    assert status == 200 and got["bio"] == "x"
    # guest cannot write providers
    status, _ = call(addr, "POST", "/api/v1/oauth", {}, token="guest-tok")
    assert status == 403
    status, _ = call(addr, "DELETE", f"/api/v1/oauth/{created['id']}")
    assert status == 200
    status, listed = call(addr, "GET", "/api/v1/oauth")
    assert listed == []


def test_oauth_signin_full_flow(rest, fake_idp):
    """Redirect leg → state round-trip → code exchange → user
    provisioned → session token works against the API."""
    import urllib.parse

    addr = rest["addr"]
    _make_provider(addr, fake_idp["base"])

    # unauthenticated browser hits the signin leg; 302 carries state
    req = urllib.request.Request(f"http://{addr}/api/v1/users/signin/fakehub")

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **k):
            return None

    opener = urllib.request.build_opener(NoRedirect)
    try:
        opener.open(req, timeout=5)
        raise AssertionError("expected 302")
    except urllib.error.HTTPError as e:
        assert e.code == 302
        loc = e.headers["Location"]
    q = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(loc).query))
    assert loc.startswith(fake_idp["base"] + "/authorize")
    assert q["client_id"] == "cid" and q["redirect_uri"] == "http://console.local/callback"
    state = q["state"]

    # callback with the provider-issued code
    status, body = call(
        addr,
        "GET",
        f"/api/v1/users/signin/fakehub/callback?code=good-code&state={state}",
        token=None,
    )
    assert status == 200, body
    assert body["user"]["name"] == "octo" and body["user"]["role"] == "guest"
    assert fake_idp["seen"]["token_body"]["redirect_uri"] == "http://console.local/callback"

    # the minted session token authenticates read access
    status, _ = call(addr, "GET", "/api/v1/schedulers", token=body["token"])
    assert status == 200

    # tampered/mismatched state is rejected
    status, err = call(
        addr,
        "GET",
        f"/api/v1/users/signin/fakehub/callback?code=good-code&state={state[:-4]}AAAA",
        token=None,
    )
    assert status == 403

    # bad code: provider refuses, no session
    status, err = call(
        addr,
        "GET",
        f"/api/v1/users/signin/fakehub/callback?code=bad&state={state}",
        token=None,
    )
    assert status in (401, 500) and "token" not in err


def test_oauth_name_collision_cannot_take_over_local_account(rest, fake_idp):
    """An IdP login equal to an existing local admin's name must NOT
    sign into that account: matching is by (provider, subject), and the
    display name gets uniquified."""
    addr = rest["addr"]
    t_auth.create_user(rest["db"], "octo", "hunter2", role="admin")  # local admin
    _make_provider(addr, fake_idp["base"])
    state = _state_secret_signed(rest, "fakehub")
    status, body = call(
        addr,
        "GET",
        f"/api/v1/users/signin/fakehub/callback?code=good-code&state={state}",
        token=None,
    )
    assert status == 200, body
    # NOT the admin account: provisioned under a uniquified name, guest role
    assert body["user"]["name"] != "octo" or body["user"]["role"] == "guest"
    assert body["user"]["role"] == "guest"
    local = rest["db"].query_one("SELECT * FROM users WHERE name = 'octo'")
    assert local["role"] == "admin" and local["oauth_subject"] == ""
    # second sign-in reuses the SAME linked account (stable subject)
    state2 = _state_secret_signed(rest, "fakehub")
    status, body2 = call(
        addr,
        "GET",
        f"/api/v1/users/signin/fakehub/callback?code=good-code&state={state2}",
        token=None,
    )
    assert status == 200 and body2["user"]["id"] == body["user"]["id"]


def _state_secret(rest):
    return t_auth.state_secret(rest["db"])


def _state_secret_signed(rest, provider):
    return t_auth.sign_state(_state_secret(rest), provider)


def test_oauth_state_survives_server_restart(rest, fake_idp, tmp_path):
    """The CSRF state key is DB-persisted: a state minted before a
    manager restart verifies after it."""
    addr = rest["addr"]
    _make_provider(addr, fake_idp["base"])
    state = _state_secret_signed(rest, "fakehub")
    # a fresh RestServer over the same DB (the "restarted" replica)
    server2 = RestServer(rest["service"], tokens={"admin-tok": "admin"})
    addr2 = server2.start()
    try:
        status, body = call(
            addr2,
            "GET",
            f"/api/v1/users/signin/fakehub/callback?code=good-code&state={state}",
            token=None,
        )
        assert status == 200, body
    finally:
        server2.stop()


def test_oauth_bad_code_is_401_and_duplicate_provider_409(rest, fake_idp):
    addr = rest["addr"]
    _make_provider(addr, fake_idp["base"])
    # provider 400s / refuses the code → clean 401, not a 500
    state = _state_secret_signed(rest, "fakehub")
    status, err = call(
        addr,
        "GET",
        f"/api/v1/users/signin/fakehub/callback?code=bad&state={state}",
        token=None,
    )
    assert status == 401, err
    # duplicate provider name → 409 conflict, not 500
    status, err = call(
        addr,
        "POST",
        "/api/v1/oauth",
        {
            "name": "fakehub", "client_id": "x", "client_secret": "y",
            "auth_url": "http://a", "token_url": "http://t", "userinfo_url": "http://u",
        },
    )
    assert status == 409, err


def test_signin_prefix_does_not_unauthenticate_other_routes(rest):
    """/api/v1/users/signin/... exemption is per-route: a path that
    happens to share the prefix but matches another route still needs
    auth."""
    addr = rest["addr"]
    status, _ = call(
        addr, "GET", "/api/v1/users/signin/personal-access-tokens", token=None
    )
    # either the PAT route demands auth (401) or nothing matches (404);
    # anything but an unauthenticated 200/400 is fine
    assert status in (401, 404)


def test_oauth_refuses_userinfo_without_stable_subject(rest, fake_idp, monkeypatch):
    """login-only userinfo (a reassignable handle) must be refused, not
    used as the account link key."""
    monkeypatch.setattr(
        t_auth, "oauth_userinfo", lambda p, t, timeout=10.0: {"login": "octo"}
    )
    addr = rest["addr"]
    _make_provider(addr, fake_idp["base"])
    state = _state_secret_signed(rest, "fakehub")
    status, err = call(
        addr,
        "GET",
        f"/api/v1/users/signin/fakehub/callback?code=good-code&state={state}",
        token=None,
    )
    assert status == 401 and "stable subject" in err["error"]


def test_oauth_guest_does_not_close_admin_bootstrap(tmp_path, fake_idp):
    """Token-less dev mode: an OAuth-provisioned guest must not end the
    anonymous-admin bootstrap window (that would lock every write route
    with no admin in existence); creating an admin user does."""
    db = Database(tmp_path / "boot.db")
    service = ManagerService(db, ModelRegistry(db, FSObjectStorage(tmp_path / "o")))
    server = RestServer(service)  # no config tokens
    addr = server.start()
    try:
        status, _ = _make_provider_status(addr, fake_idp["base"], token=None)
        assert status == 200  # anonymous admin can configure the provider
        state = t_auth.sign_state(t_auth.state_secret(db), "fakehub")
        status, body = call(
            addr,
            "GET",
            f"/api/v1/users/signin/fakehub/callback?code=good-code&state={state}",
            token=None,
        )
        assert status == 200 and body["user"]["role"] == "guest"
        # bootstrap window still open: anonymous can create the admin
        status, admin = call(
            addr, "POST", "/api/v1/users",
            {"name": "root", "password": "pw12345", "role": "admin"}, token=None,
        )
        assert status == 200, admin
        # and NOW anonymous write access is gone
        status, _ = call(
            addr, "POST", "/api/v1/applications", {"name": "x"}, token=None
        )
        assert status == 401
    finally:
        server.stop()
        db.close()


def _make_provider_status(addr, base, token="admin-tok"):
    return call(
        addr,
        "POST",
        "/api/v1/oauth",
        {
            "name": "fakehub", "client_id": "cid", "client_secret": "csec",
            "auth_url": f"{base}/authorize", "token_url": f"{base}/token",
            "userinfo_url": f"{base}/userinfo",
        },
        token=token,
    )


def test_configs_crud(rest):
    addr = rest["addr"]
    status, row = call(addr, "POST", "/api/v1/configs", {"name": "gc-ttl", "value": "3600"})
    assert status == 200 and row["value"] == "3600"
    status, got = call(addr, "GET", "/api/v1/configs/gc-ttl", token="guest-tok")
    assert status == 200 and got["id"] == row["id"]
    status, upd = call(addr, "PATCH", f"/api/v1/configs/{row['id']}", {"value": "60"})
    assert status == 200 and upd["value"] == "60"
    status, _ = call(addr, "POST", "/api/v1/configs", {"name": "gc-ttl"})
    assert status == 409  # UNIQUE name
    status, _ = call(addr, "DELETE", f"/api/v1/configs/{row['id']}")
    assert status == 200
    status, listed = call(addr, "GET", "/api/v1/configs")
    assert listed == []


def test_buckets_crud(rest):
    addr = rest["addr"]
    status, listed = call(addr, "GET", "/api/v1/buckets")
    assert status == 200  # models bucket pre-created by the registry
    before = {b["name"] for b in listed}
    status, made = call(addr, "POST", "/api/v1/buckets", {"name": "blobs"})
    assert status == 200
    status, got = call(addr, "GET", "/api/v1/buckets/blobs")
    assert status == 200 and got["objects"] == 0
    status, listed = call(addr, "GET", "/api/v1/buckets")
    assert {b["name"] for b in listed} == before | {"blobs"}
    status, _ = call(addr, "GET", "/api/v1/buckets/nope")
    assert status == 404
    status, _ = call(addr, "POST", "/api/v1/buckets", {"name": "../escape"})
    assert status == 400
    status, _ = call(addr, "DELETE", "/api/v1/buckets/blobs")
    assert status == 200


def test_peers_materialized_from_sync_peers_job(rest):
    """sync_peers job result → peers rows the REST surface serves
    (upstream handlers/peer.go backed by the sync-peers job)."""
    service = rest["service"]
    server, port = glue.serve({glue.MANAGER_SERVICE: service})
    try:
        chan = glue.dial(f"127.0.0.1:{port}")
        client = glue.ServiceClient(chan, glue.MANAGER_SERVICE)
        job = client.CreateJob(
            manager_pb2.CreateJobRequest(
                type="sync_peers", args_json="{}", scheduler_cluster_id=1
            )
        )
        leased = client.ListPendingJobs(
            manager_pb2.ListPendingJobsRequest(
                ip="10.9.9.9", hostname="sched-w", scheduler_cluster_id=1
            )
        )
        assert [j.id for j in leased.jobs] == [job.id]
        result = json.dumps(
            {
                "hosts": [
                    {"id": "h-1", "hostname": "a", "ip": "10.0.0.1",
                     "type": "normal", "peer_count": 3, "upload_count": 7},
                    {"id": "h-2", "hostname": "b", "ip": "10.0.0.2",
                     "type": "super", "peer_count": 1, "upload_count": 0},
                ]
            }
        )
        client.UpdateJobResult(
            manager_pb2.UpdateJobResultRequest(
                id=job.id, state="succeeded", result_json=result,
                ip="10.9.9.9", hostname="sched-w",
            )
        )
        chan.close()
    finally:
        server.stop(0)

    status, peers = call(rest["addr"], "GET", "/api/v1/peers?scheduler_cluster_id=1")
    assert status == 200 and len(peers) == 2
    by_host = {p["host_id"]: p for p in peers}
    assert by_host["h-1"]["peer_count"] == 3 and by_host["h-2"]["type"] == "super"
    status, one = call(rest["addr"], "GET", f"/api/v1/peers/{peers[0]['id']}")
    assert status == 200 and one["host_id"] in by_host
    status, _ = call(rest["addr"], "DELETE", f"/api/v1/peers/{peers[0]['id']}")
    assert status == 200
    status, remaining = call(rest["addr"], "GET", "/api/v1/peers")
    assert len(remaining) == 1


def test_config_numeric_name_never_shadows_id(rest):
    addr = rest["addr"]
    _, a = call(addr, "POST", "/api/v1/configs", {"name": "2", "value": "A"})
    _, b = call(addr, "POST", "/api/v1/configs", {"name": "gc", "value": "B"})
    assert a["id"] == 1 and b["id"] == 2
    # id lookup resolves config B, not config A (whose NAME is "2")
    status, got = call(addr, "GET", "/api/v1/configs/2")
    assert got["name"] == "gc"
    status, _ = call(addr, "DELETE", "/api/v1/configs/2")
    status, remaining = call(addr, "GET", "/api/v1/configs")
    assert [r["name"] for r in remaining] == ["2"]
    # malformed bodies are client errors, not 500s
    status, _ = call(addr, "POST", "/api/v1/configs", {"name": 7})
    assert status == 400
    status, _ = call(addr, "PATCH", "/api/v1/configs/1", {"name": ""})
    assert status == 400
    status, _ = call(addr, "POST", "/api/v1/buckets", {"name": 5})
    assert status == 400
    # structured config values stored as JSON
    status, c = call(addr, "POST", "/api/v1/configs", {"name": "j", "value": {"a": 1}})
    assert status == 200 and json.loads(c["value"]) == {"a": 1}


def test_malformed_sync_peers_result_leaves_peers_intact(rest):
    """A worker-supplied result with bad row shapes must neither wipe
    the peers table nor fail the RPC (the job row already committed)."""
    service = rest["service"]
    server, port = glue.serve({glue.MANAGER_SERVICE: service})
    try:
        chan = glue.dial(f"127.0.0.1:{port}")
        client = glue.ServiceClient(chan, glue.MANAGER_SERVICE)

        def run_job(result_json):
            job = client.CreateJob(manager_pb2.CreateJobRequest(
                type="sync_peers", args_json="{}", scheduler_cluster_id=1))
            client.ListPendingJobs(manager_pb2.ListPendingJobsRequest(
                ip="1.1.1.1", hostname="w", scheduler_cluster_id=1))
            return client.UpdateJobResult(manager_pb2.UpdateJobResultRequest(
                id=job.id, state="succeeded", result_json=result_json,
                ip="1.1.1.1", hostname="w"))

        run_job(json.dumps({"hosts": [{"id": "keep", "peer_count": 1}]}))
        status, peers = call(rest["addr"], "GET", "/api/v1/peers")
        assert [p["host_id"] for p in peers] == ["keep"]
        # null count coerces to 0 — a usable row, refresh applies
        r = run_job(json.dumps({"hosts": [{"id": "nul", "peer_count": None}]}))
        assert r.state == "succeeded"
        status, peers = call(rest["addr"], "GET", "/api/v1/peers")
        assert [(p["host_id"], p["peer_count"]) for p in peers] == [("nul", 0)]
        # truly unusable rows (non-numeric count) → logged no-op, RPC succeeds
        r = run_job(json.dumps({"hosts": [{"id": "bad", "peer_count": "NaNsense"}]}))
        assert r.state == "succeeded"
        # list-shaped result (valid JSON, wrong shape) → also a no-op
        r = run_job("[]")
        assert r.state == "succeeded"
        status, peers = call(rest["addr"], "GET", "/api/v1/peers")
        assert [p["host_id"] for p in peers] == ["nul"]
        chan.close()
    finally:
        server.stop(0)


def test_openapi_spec_matches_route_table(rest):
    """The live-derived OpenAPI document covers every registered route
    with correct method, params, and auth annotations."""
    status, spec = call(rest["addr"], "GET", "/api/v1/openapi.json", token=None)
    assert status == 200 and spec["openapi"].startswith("3.")
    paths = spec["paths"]
    # spot checks across surfaces
    assert "get" in paths["/api/v1/schedulers"]
    assert "put" in paths["/api/v1/models/{model_id}/versions/{version}/state"]
    assert {p["name"] for p in paths["/api/v1/models/{model_id}/versions/{version}"]["get"]["parameters"]} == {"model_id", "version"}
    # auth annotations: signin legs open, writes admin-gated
    assert "security" not in paths["/api/v1/users/signin/{name}"]["get"]
    assert paths["/api/v1/oauth"]["post"]["responses"].get("403")
    # completeness: every registered route appears — derived straight
    # from the route table (independent of how the implementation finds
    # patterns, so a silently skipped route fails here)
    import re as _re

    _ROUTES = t_rest._ROUTES

    want = {
        (_re.sub(r":(\w+)", r"{\1}", entry[5]), entry[0].lower())
        for entry in _ROUTES
    }
    have = {(p, m) for p, ops in paths.items() for m in ops}
    assert want == have and len(want) >= 45


def test_route_literals_are_escaped(rest):
    """A '.' in a route pattern matches only itself — openapiXjson must
    not resolve the openapi.json route."""
    status, _ = call(rest["addr"], "GET", "/api/v1/openapiXjson", token=None)
    assert status in (401, 404)


def test_group_jobs_fan_out_and_aggregate(rest):
    """scheduler_cluster_ids fans one job to N clusters under a group id
    whose state aggregates machinery-style: any failed → failed, all
    succeeded → succeeded (upstream manager/job createGroupJob)."""
    addr = rest["addr"]
    status, group = call(
        addr, "POST", "/api/v1/jobs",
        {"type": "preheat", "args": {"url": "https://x/y"},
         "scheduler_cluster_ids": [1, 2]},
    )
    assert status == 200 and len(group["jobs"]) == 2 and group["group_id"]
    gid = group["group_id"]
    status, agg = call(addr, "GET", f"/api/v1/jobs/groups/{gid}")
    assert agg["state"] == "queued"

    service = rest["service"]
    server, port = glue.serve({glue.MANAGER_SERVICE: service})
    try:
        chan = glue.dial(f"127.0.0.1:{port}")
        client = glue.ServiceClient(chan, glue.MANAGER_SERVICE)

        def work(cluster, state):
            leased = client.ListPendingJobs(
                manager_pb2.ListPendingJobsRequest(
                    ip="1.1.1.1", hostname=f"w{cluster}",
                    scheduler_cluster_id=cluster,
                )
            )
            assert len(leased.jobs) == 1
            client.UpdateJobResult(
                manager_pb2.UpdateJobResultRequest(
                    id=leased.jobs[0].id, state=state, result_json="{}",
                    ip="1.1.1.1", hostname=f"w{cluster}",
                )
            )

        work(1, "succeeded")
        status, agg = call(addr, "GET", f"/api/v1/jobs/groups/{gid}")
        assert agg["state"] == "queued"  # one member still pending
        work(2, "succeeded")
        status, agg = call(addr, "GET", f"/api/v1/jobs/groups/{gid}")
        assert agg["state"] == "succeeded"
        chan.close()
    finally:
        server.stop(0)

    # single-cluster create keeps the old shape (no group wrapper)
    status, single = call(
        addr, "POST", "/api/v1/jobs",
        {"type": "preheat", "args": {}, "scheduler_cluster_id": 1},
    )
    assert status == 200 and "id" in single and single.get("group_id") == ""

    # a failed member fails the whole group
    status, g2 = call(
        addr, "POST", "/api/v1/jobs",
        {"type": "preheat", "args": {}, "scheduler_cluster_ids": [3, 4]},
    )
    rest["db"].execute(
        "UPDATE jobs SET state = 'failed' WHERE id = ?", (g2["jobs"][0]["id"],)
    )
    status, agg = call(addr, "GET", f"/api/v1/jobs/groups/{g2['group_id']}")
    assert agg["state"] == "failed"
    status, _ = call(addr, "GET", "/api/v1/jobs/groups/nope")
    assert status == 404


def test_group_job_validation_and_single_element_list(rest):
    addr = rest["addr"]
    # invalid id anywhere → 400, and NO orphaned rows inserted
    status, err = call(
        addr, "POST", "/api/v1/jobs",
        {"type": "preheat", "scheduler_cluster_ids": [1, "abc"]},
    )
    assert status == 400
    status, jobs = call(addr, "GET", "/api/v1/jobs")
    assert jobs == []
    # a 1-element LIST still follows the group contract
    status, g = call(
        addr, "POST", "/api/v1/jobs",
        {"type": "preheat", "scheduler_cluster_ids": [7]},
    )
    assert status == 200 and g["group_id"] and len(g["jobs"]) == 1
    status, agg = call(addr, "GET", f"/api/v1/jobs/groups/{g['group_id']}")
    assert status == 200 and agg["state"] == "queued"


def test_rest_job_defaults_to_default_cluster(rest):
    """A REST-created job without scheduler_cluster_id must land in the
    DEFAULT cluster, not dead-letter in cluster 0 no worker leases."""
    status, job = call(rest["addr"], "POST", "/api/v1/jobs", {"type": "preheat"})
    assert status == 200
    assert job["scheduler_cluster_id"] == rest["service"].default_cluster_id != 0


def test_signin_ttl_zero_is_capped(rest):
    t_auth.create_user(rest["db"], "sess", "pw12345", role="guest")
    status, out = call(
        rest["addr"], "POST", "/api/v1/users/signin",
        {"name": "sess", "password": "pw12345", "ttl": 0}, token=None,
    )
    assert status == 200
    row = rest["db"].query_one(
        "SELECT expires_at FROM personal_access_tokens ORDER BY id DESC LIMIT 1"
    )
    assert row["expires_at"] > 0  # never-expiring stays admin-route-only


def test_oauth_numeric_name_never_shadows_provider_id(rest, fake_idp):
    a = _make_provider(addr := rest["addr"], fake_idp["base"])
    status, b = call(
        addr, "POST", "/api/v1/oauth",
        {"name": str(a["id"]), "client_id": "x", "client_secret": "y",
         "auth_url": "http://a", "token_url": "http://t", "userinfo_url": "http://u"},
    )
    assert status == 200
    status, got = call(addr, "GET", f"/api/v1/oauth/{a['id']}")
    assert got["name"] == a["name"]  # id lookup resolves A, never B
    status, _ = call(addr, "DELETE", f"/api/v1/oauth/{a['id']}")
    status, listed = call(addr, "GET", "/api/v1/oauth")
    assert [r["name"] for r in listed] == [str(a["id"])]


class TestUserLifecycle:
    """The user lifecycle (upstream router.go:97-111): signup,
    signout, refresh_token, reset_password."""

    def test_signup_is_guest_only(self, rest):
        addr = rest["addr"]
        status, user = call(
            addr, "POST", "/api/v1/users/signup",
            {"name": "joiner", "password": "pw1", "role": "admin"},  # role ignored
            token=None,  # unauthenticated route
        )
        assert status == 200 and user["role"] == "guest"
        assert "password_hash" not in user and "password_salt" not in user

    def test_signout_revokes_session(self, rest):
        addr = rest["addr"]
        call(addr, "POST", "/api/v1/users",
             {"name": "op", "password": "pw", "role": "admin"})
        _, session = call(addr, "POST", "/api/v1/users/signin",
                          {"name": "op", "password": "pw"}, token=None)
        tok = session["token"]
        status, _ = call(addr, "GET", "/api/v1/schedulers", token=tok)
        assert status == 200
        status, out = call(addr, "POST", "/api/v1/users/signout", {}, token=tok)
        assert status == 200 and out["signed_out"]
        status, _ = call(addr, "GET", "/api/v1/schedulers", token=tok)
        assert status == 401  # the token died with the session
        # config-file tokens aren't revocable sessions
        status, _ = call(addr, "POST", "/api/v1/users/signout", {}, token="admin-tok")
        assert status == 400

    def test_refresh_token_rotates(self, rest):
        addr = rest["addr"]
        call(addr, "POST", "/api/v1/users",
             {"name": "op2", "password": "pw", "role": "admin"})
        _, session = call(addr, "POST", "/api/v1/users/signin",
                          {"name": "op2", "password": "pw"}, token=None)
        old = session["token"]
        status, out = call(addr, "POST", "/api/v1/users/refresh_token", {}, token=old)
        assert status == 200 and out["token"] and out["token"] != old
        # new works, old is revoked
        assert call(addr, "GET", "/api/v1/schedulers", token=out["token"])[0] == 200
        assert call(addr, "GET", "/api/v1/schedulers", token=old)[0] == 401

    def test_reset_password_requires_old(self, rest):
        addr = rest["addr"]
        _, user = call(addr, "POST", "/api/v1/users",
                       {"name": "r", "password": "old-pw", "role": "guest"})
        status, _ = call(
            addr, "POST", f"/api/v1/users/{user['id']}/reset_password",
            {"old_password": "WRONG", "new_password": "new-pw"}, token=None,
        )
        assert status == 401
        status, out = call(
            addr, "POST", f"/api/v1/users/{user['id']}/reset_password",
            {"old_password": "old-pw", "new_password": "new-pw"}, token=None,
        )
        assert status == 200
        # old password dead, new one signs in
        assert call(addr, "POST", "/api/v1/users/signin",
                    {"name": "r", "password": "old-pw"}, token=None)[0] == 401
        assert call(addr, "POST", "/api/v1/users/signin",
                    {"name": "r", "password": "new-pw"}, token=None)[0] == 200


class TestRolesSurface:
    def test_roles_and_permissions_read(self, rest):
        addr = rest["addr"]
        status, roles = call(addr, "GET", "/api/v1/roles", token="guest-tok")
        assert status == 200 and set(roles) == {"admin", "guest"}
        status, role = call(addr, "GET", "/api/v1/roles/guest", token="guest-tok")
        assert status == 200
        actions = {p["action"] for p in role["permissions"]}
        assert "GET" in actions and "DELETE" not in actions  # guest is read-only
        status, admin_role = call(addr, "GET", "/api/v1/roles/admin")
        assert {p["action"] for p in admin_role["permissions"]} >= {"GET", "POST", "DELETE"}
        status, perms = call(addr, "GET", "/api/v1/permissions")
        assert status == 200 and len(perms) > 40
        assert call(addr, "GET", "/api/v1/roles/root")[0] == 404

    def test_user_role_assignment(self, rest):
        addr = rest["addr"]
        _, user = call(addr, "POST", "/api/v1/users",
                       {"name": "promote-me", "password": "pw"})
        assert call(addr, "GET", f"/api/v1/users/{user['id']}/roles")[1] == ["guest"]
        status, out = call(addr, "PUT", f"/api/v1/users/{user['id']}/roles/admin", {})
        assert status == 200 and out["role"] == "admin"
        status, out = call(addr, "DELETE", f"/api/v1/users/{user['id']}/roles/admin")
        assert status == 200 and out["role"] == "guest"
        assert call(addr, "DELETE", f"/api/v1/users/{user['id']}/roles/admin")[0] == 404


class TestSeedPeerClusters:
    def test_crud_and_assignment(self, rest):
        addr = rest["addr"]
        status, c = call(addr, "POST", "/api/v1/seed-peer-clusters",
                         {"name": "spc-1", "config": {"load_limit": 100}})
        assert status == 200 and c["name"] == "spc-1"
        status, rows = call(addr, "GET", "/api/v1/seed-peer-clusters", token="guest-tok")
        assert status == 200 and len(rows) == 1
        status, c2 = call(addr, "PATCH", f"/api/v1/seed-peer-clusters/{c['id']}",
                          {"config": {"load_limit": 50}})
        assert status == 200 and json.loads(c2["config"]) == {"load_limit": 50}
        # move a registered seed peer into the new cluster
        import time as _time

        rest["db"].execute(
            "INSERT INTO seed_peers (hostname, ip, port, seed_peer_cluster_id,"
            " created_at, updated_at) VALUES ('sp-h', '10.0.0.9', 1, 999, ?, ?)",
            (_time.time(), _time.time()),
        )
        sp = rest["db"].query_one("SELECT id FROM seed_peers WHERE hostname='sp-h'")
        status, out = call(
            addr, "PUT", f"/api/v1/seed-peer-clusters/{c['id']}/seed-peers/{sp['id']}", {}
        )
        assert status == 200
        moved = rest["db"].query_one(
            "SELECT seed_peer_cluster_id FROM seed_peers WHERE id = ?", (sp["id"],)
        )
        assert moved["seed_peer_cluster_id"] == c["id"]
        status, _ = call(addr, "DELETE", f"/api/v1/seed-peer-clusters/{c['id']}")
        assert status == 200
        assert call(addr, "GET", f"/api/v1/seed-peer-clusters/{c['id']}")[0] == 404


class TestApplicationsFullCrud:
    def test_get_patch_delete(self, rest):
        addr = rest["addr"]
        _, app = call(addr, "POST", "/api/v1/applications",
                      {"name": "ml-sync", "url": "https://repo", "priority": {"value": 5}})
        status, got = call(addr, "GET", f"/api/v1/applications/{app['id']}",
                           token="guest-tok")
        assert status == 200 and got["name"] == "ml-sync"
        status, upd = call(addr, "PATCH", f"/api/v1/applications/{app['id']}",
                           {"url": "https://repo2"})
        assert status == 200 and upd["url"] == "https://repo2"
        status, _ = call(addr, "DELETE", f"/api/v1/applications/{app['id']}")
        assert status == 200
        assert call(addr, "GET", f"/api/v1/applications/{app['id']}")[0] == 404
        assert call(addr, "PATCH", "/api/v1/applications/424242", {"url": "x"})[0] == 404


class TestPatOpenApi:
    def test_toplevel_pat_crud_and_oapi_access(self, rest):
        addr = rest["addr"]
        _, user = call(addr, "POST", "/api/v1/users",
                       {"name": "automation", "password": "pw", "role": "admin"})
        status, pat = call(addr, "POST", "/api/v1/personal-access-tokens",
                           {"user_id": user["id"], "name": "ci"})
        assert status == 200 and pat["token"]
        status, rows = call(addr, "GET", "/api/v1/personal-access-tokens")
        assert status == 200 and any(r["id"] == pat["id"] for r in rows)
        status, one = call(addr, "GET", f"/api/v1/personal-access-tokens/{pat['id']}")
        assert status == 200 and one["name"] == "ci"

        # the open API surface: a PAT drives jobs + clusters CRUD
        tok = pat["token"]
        status, c = call(addr, "POST", "/oapi/v1/clusters",
                         {"name": "oapi-c"}, token=tok)
        assert status == 200
        status, rows = call(addr, "GET", "/oapi/v1/clusters", token=tok)
        assert status == 200 and any(r["name"] == "oapi-c" for r in rows)
        assert call(addr, "GET", "/oapi/v1/jobs", token=tok)[0] == 200

        # deactivate, then the PAT stops working; reactivate restores
        status, _ = call(addr, "PATCH", f"/api/v1/personal-access-tokens/{pat['id']}",
                         {"state": "inactive"})
        assert status == 200
        assert call(addr, "GET", "/oapi/v1/clusters", token=tok)[0] == 401
        call(addr, "PATCH", f"/api/v1/personal-access-tokens/{pat['id']}",
             {"state": "active"})
        assert call(addr, "GET", "/oapi/v1/clusters", token=tok)[0] == 200
        # revoke is terminal
        call(addr, "DELETE", f"/api/v1/personal-access-tokens/{pat['id']}")
        assert call(addr, "GET", "/oapi/v1/clusters", token=tok)[0] == 401


def test_route_census():
    """The port's route table is the reference's, row for row: method,
    pattern and its compiled matcher, handler, ``write`` and ``auth``
    flags (the reference's own census holds its table to upstream's
    router.go and the deltas docs/manager-api.md records)."""
    def rows(routes):
        return [(m, rx.pattern, f, w, a, p) for m, rx, f, w, a, p in routes]

    assert rows(t_rest._ROUTES) == rows(j_rest._ROUTES)
    assert len(t_rest._ROUTES) == 101


def test_composite_clusters_and_v1_preheat(rest):
    """Upstream's /api/v1/clusters (one resource = scheduler + seed-peer
    cluster pair, router.go:133-139) and the v1-compat /preheats alias."""
    addr = rest["addr"]
    status, c = call(addr, "POST", "/api/v1/clusters",
                     {"name": "site-a", "is_default": True,
                      "seed_peer_cluster_config": {"load_limit": 3}})
    assert status == 200
    assert c["scheduler_cluster"]["name"] == c["seed_peer_cluster"]["name"] == "site-a"
    status, rows = call(addr, "GET", "/api/v1/clusters", token="guest-tok")
    mine = next(r for r in rows if r["name"] == "site-a")  # DB pre-seeds 'default'
    assert status == 200 and mine["seed_peer_cluster"] is not None
    status, got = call(addr, "GET", f"/api/v1/clusters/{c['id']}")
    assert status == 200 and got["seed_peer_cluster"]["name"] == "site-a"
    status, upd = call(addr, "PATCH", f"/api/v1/clusters/{c['id']}",
                       {"config": {"x": 1}, "seed_peer_cluster_config": {"y": 2}})
    assert status == 200
    assert json.loads(upd["scheduler_cluster"]["config"]) == {"x": 1}
    assert json.loads(upd["seed_peer_cluster"]["config"]) == {"y": 2}
    status, _ = call(addr, "DELETE", f"/api/v1/clusters/{c['id']}")
    assert status == 200
    assert call(addr, "GET", "/api/v1/seed-peer-clusters", token="guest-tok")[1] == []

    # v1 preheat compat: POST /preheats -> a queued preheat job
    status, ph = call(addr, "POST", "/preheats", {"url": "https://x/blob"})
    assert status == 200 and ph["status"] == "queued"
    status, got = call(addr, "GET", f"/preheats/{ph['id']}")
    assert status == 200 and got["status"] in ("queued", "running")
    assert call(addr, "GET", "/_ping", token=None)[0] == 200


def test_pat_metadata_restricted_to_admin_or_owner(tmp_path):
    """Token metadata is a credential inventory: the
    top-level PAT routes are admin-only, and the per-user list is
    readable only by an admin or the user it belongs to."""
    db = Database(tmp_path / "pat.db")
    models = ModelRegistry(db, FSObjectStorage(tmp_path / "obj"))
    server = RestServer(ManagerService(db, models))
    addr = server.start()
    try:
        # bootstrap an admin + two guests, each with a PAT
        status, _ = call(
            addr, "POST", "/api/v1/users",
            {"name": "root", "password": "pw", "role": "admin"}, token=None,
        )
        assert status == 200
        status, session = call(
            addr, "POST", "/api/v1/users/signin",
            {"name": "root", "password": "pw"}, token=None,
        )
        admin_tok = session["token"]
        users, toks = {}, {}
        for name in ("alice", "bob"):
            status, u = call(
                addr, "POST", "/api/v1/users",
                {"name": name, "password": "pw", "role": "guest"}, token=admin_tok,
            )
            assert status == 200
            users[name] = u["id"]
            status, pat = call(
                addr, "POST", f"/api/v1/users/{u['id']}/personal-access-tokens",
                {"name": f"{name}-tok"}, token=admin_tok,
            )
            assert status == 200
            toks[name] = pat["token"]

        # top-level inventory: admin yes, guest no
        status, body = call(addr, "GET", "/api/v1/personal-access-tokens", token=admin_tok)
        assert status == 200 and len(body) >= 3
        status, _ = call(addr, "GET", "/api/v1/personal-access-tokens", token=toks["alice"])
        assert status == 403
        # single token: admin yes; guests can't read others' (or even
        # probe ids — 403, not 404)
        some_id = body[0]["id"]
        status, row = call(
            addr, "GET", f"/api/v1/personal-access-tokens/{some_id}", token=admin_tok
        )
        assert status == 200 and "token_hash" not in row
        status, _ = call(
            addr, "GET", f"/api/v1/personal-access-tokens/{some_id}", token=toks["alice"]
        )
        assert status == 403
        status, _ = call(
            addr, "GET", "/api/v1/personal-access-tokens/999999", token=toks["alice"]
        )
        assert status == 403  # non-existent id leaks nothing to guests

        # per-user list: owner yes, other guest no, admin yes
        status, mine = call(
            addr, "GET", f"/api/v1/users/{users['alice']}/personal-access-tokens",
            token=toks["alice"],
        )
        assert status == 200 and all(r["user_id"] == users["alice"] for r in mine)
        status, _ = call(
            addr, "GET", f"/api/v1/users/{users['alice']}/personal-access-tokens",
            token=toks["bob"],
        )
        assert status == 403
        status, _ = call(
            addr, "GET", f"/api/v1/users/{users['alice']}/personal-access-tokens",
            token=admin_tok,
        )
        assert status == 200
    finally:
        server.stop()
        db.close()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

PORT = dict(db=Database, registry=ModelRegistry, storage=FSObjectStorage, service=ManagerService,
            server=RestServer, auth=t_auth)
REFERENCE = dict(db=j_database.Database, registry=j_registry.ModelRegistry,
                 storage=j_objectstorage.FSObjectStorage, service=j_service.ManagerService,
                 server=j_rest.RestServer, auth=j_auth)
PACKAGES = {"jax": REFERENCE, "torch": PORT}
TOKENS = {"admin-tok": "admin", "guest-tok": "guest"}


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *a, **k):
        return None


_OPENER = urllib.request.build_opener(_NoRedirect)


def _send(addr, method, path, body=None, token="admin-tok"):
    """One request → (status, JSON body, Location header); a 302 is
    answered, never followed."""
    req = urllib.request.Request(
        f"http://{addr}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Authorization": f"Bearer {token}"} if token else {},
    )
    try:
        with _OPENER.open(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read()), resp.headers.get("Location")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Location")


class _Front:
    """One package's REST front over its own stack (or over ``db_path``)."""

    def __init__(self, pkg, root, tokens=None, db_path=None):
        root.mkdir(parents=True, exist_ok=True)
        self.db = pkg["db"](db_path or root / "m.db")
        self.models = pkg["registry"](self.db, pkg["storage"](root / "obj"))
        self.service = pkg["service"](self.db, self.models)
        self.server = pkg["server"](self.service, tokens=tokens)
        self.addr = self.server.start()
        self.log = []

    def call(self, method, path, body=None, token="admin-tok"):
        status, got, location = _send(self.addr, method, path, body, token)
        self.log.append((method, _mask_path(path), status, _mask(got), _mask_path(location or "")))
        return status, got

    def stop(self):
        self.server.stop()
        self.db.close()


_TIMES = ("created_at", "updated_at", "expires_at", "last_keepalive")


def _mask_path(path):
    """Group ids and OAuth states differ from run to run; nothing else
    in a path does."""
    import re

    return re.sub(r"[0-9a-f]{32}", "<group>", re.sub(r"state=[^&]*", "state=<state>", path))


def _mask(v, key=None):
    """Only what is not reproducible: timestamps, tokens, group ids and
    the OAuth state in a redirect."""
    if isinstance(v, dict):
        return {k: _mask(x, k) for k, x in v.items()}
    if isinstance(v, list):
        return [_mask(x) for x in v]
    if key in _TIMES and v:
        return "<time>"
    if key == "token" and isinstance(v, str) and v.startswith(t_auth.TOKEN_PREFIX):
        return "<token>"
    if key == "group_id" and v:
        return "<group>"
    if key == "location" and isinstance(v, str):
        return _mask_path(v)
    return v


@pytest.fixture
def fronts(tmp_path):
    made = {}
    try:
        for name, pkg in PACKAGES.items():
            made[name] = _Front(pkg, tmp_path / name, tokens=TOKENS)
        yield made
    finally:
        for front in made.values():
            front.stop()


def _sequence(front, idp):
    """One operator's session against ``front``: every route family, the
    refusals beside the successes."""
    call = front.call
    weights = np.arange(8, dtype=np.float32).tobytes()
    for mse in (0.5, 0.4):
        front.models.create("mlp-h", "mlp", weights, {"mse": mse}, ip="10.0.0.1", hostname="h",
                            scheduler_cluster_id=1)
    call("GET", "/healthy", token=None)
    call("GET", "/_ping", token=None)
    call("GET", "/api/v1/schedulers", token=None)
    call("GET", "/api/v1/schedulers", token="nope")
    call("POST", "/api/v1/scheduler-clusters", {"name": "x"}, token="guest-tok")
    call("GET", "/api/v1/nowhere")
    call("GET", "/api/v1/telemetry", token=None)
    # clusters and their members
    _, c2 = call("POST", "/api/v1/scheduler-clusters",
                 {"name": "c2", "config": {"candidate_parent_limit": 7}, "scopes": {"idc": "idc-2"}})
    call("PATCH", f"/api/v1/scheduler-clusters/{c2['id']}", {"scopes": {"cidrs": ["10.0.0.0/8"]}})
    call("PATCH", f"/api/v1/scheduler-clusters/{c2['id']}", {})
    call("POST", "/api/v1/scheduler-clusters", {"name": "c2"})
    call("POST", "/api/v1/scheduler-clusters", {})
    call("GET", "/api/v1/scheduler-clusters", token="guest-tok")
    _, s = call("POST", "/api/v1/schedulers", {"hostname": "s1", "ip": "10.0.0.2", "port": 8002})
    call("POST", "/api/v1/schedulers", {"hostname": "s1"})
    call("PATCH", f"/api/v1/schedulers/{s['id']}", {"idc": "idc-2", "state": "active"})
    call("PUT", f"/api/v1/scheduler-clusters/{c2['id']}/schedulers/{s['id']}", {})
    call("PUT", f"/api/v1/scheduler-clusters/999/schedulers/{s['id']}", {})
    call("GET", f"/api/v1/schedulers/{s['id']}")
    call("GET", "/api/v1/schedulers/abc")
    _, spc = call("POST", "/api/v1/seed-peer-clusters", {"name": "spc", "config": {"load_limit": 100}})
    _, sp = call("POST", "/api/v1/seed-peers", {"hostname": "sp1", "ip": "10.0.0.3", "download_port": 8001})
    call("PATCH", f"/api/v1/seed-peers/{sp['id']}", {"type": "strong"})
    call("PUT", f"/api/v1/seed-peer-clusters/{spc['id']}/seed-peers/{sp['id']}", {})
    call("PATCH", f"/api/v1/seed-peer-clusters/{spc['id']}", {"config": {"load_limit": 50}})
    call("GET", "/api/v1/seed-peers")
    call("GET", f"/api/v1/seed-peer-clusters/{spc['id']}")
    _, site = call("POST", "/api/v1/clusters", {"name": "site-a", "seed_peer_cluster_config": {"load_limit": 3}})
    call("POST", "/api/v1/clusters", {"name": "site-a"})
    call("PATCH", f"/api/v1/clusters/{site['id']}", {"name": "site-b", "seed_peer_cluster_config": {"y": 2}})
    call("GET", "/api/v1/clusters", token="guest-tok")
    call("DELETE", f"/api/v1/clusters/{site['id']}")
    call("DELETE", f"/api/v1/seed-peers/{sp['id']}")
    call("DELETE", f"/api/v1/seed-peer-clusters/{spc['id']}")
    call("DELETE", f"/api/v1/schedulers/{s['id']}")
    # jobs, groups and the aliases
    _, job = call("POST", "/api/v1/jobs", {"type": "preheat", "args": {"url": "https://x/blob"}})
    _, group = call("POST", "/api/v1/jobs", {"type": "preheat", "scheduler_cluster_ids": [1, c2["id"]]})
    call("GET", f"/api/v1/jobs/groups/{group['group_id']}")
    call("PATCH", f"/api/v1/jobs/{group['jobs'][0]['id']}", {"state": "failed", "result": {"why": "x"}})
    call("GET", f"/api/v1/jobs/groups/{group['group_id']}")
    call("POST", "/api/v1/jobs", {"type": "preheat", "scheduler_cluster_ids": [1, "abc"]})
    call("POST", "/api/v1/jobs", {"type": "preheat", "scheduler_cluster_ids": []})
    call("POST", "/api/v1/jobs", {})
    call("PATCH", f"/api/v1/jobs/{job['id']}", {"state": "bogus"})
    call("GET", "/api/v1/jobs/groups/nope")
    _, ojob = call("POST", "/oapi/v1/jobs", {"type": "sync_peers", "scheduler_cluster_id": c2["id"]})
    call("GET", f"/oapi/v1/jobs/{ojob['id']}")
    call("PATCH", f"/oapi/v1/jobs/{ojob['id']}", {"state": "succeeded", "result": "{}"})
    call("GET", "/oapi/v1/jobs", token="guest-tok")
    call("POST", "/oapi/v1/clusters", {"name": "oapi-c"})
    call("GET", "/oapi/v1/clusters")
    _, ph = call("POST", "/preheats", {"url": "https://x/y"})
    call("POST", "/preheats", {"url": " "})
    call("GET", f"/preheats/{ph['id']}")
    call("DELETE", f"/oapi/v1/jobs/{ojob['id']}")
    call("GET", "/api/v1/jobs")
    # models and activation
    call("GET", "/api/v1/models?scheduler_cluster_id=1")
    call("PUT", "/api/v1/models/mlp-h/versions/1/state", {"state": "active"})
    call("PUT", "/api/v1/models/mlp-h/versions/2/state", {"state": "active"})
    call("GET", "/api/v1/models/mlp-h/versions/1")
    call("PUT", "/api/v1/models/mlp-h/versions/2/state", {"state": "bogus"})
    call("PUT", "/api/v1/models/mlp-h/versions/9/state", {"state": "active"})
    call("PUT", "/api/v1/models/mlp-h/versions/1/state", {"state": "active"}, token="guest-tok")
    call("DELETE", "/api/v1/models/mlp-h/versions/1")
    call("GET", "/api/v1/models/mlp-h/versions/1")
    call("GET", "/api/v1/models")
    # users, sessions, roles and tokens
    call("POST", "/api/v1/users", {"name": "root", "password": "s3cret", "role": "admin"})
    call("POST", "/api/v1/users", {"name": "bad", "password": "pw", "role": "root"})
    _, session = call("POST", "/api/v1/users/signin", {"name": "root", "password": "s3cret"}, token=None)
    call("POST", "/api/v1/users/signin", {"name": "root", "password": "wrong"}, token=None)
    call("POST", "/api/v1/users/signin", {"name": "root", "password": "s3cret", "ttl": "x"}, token=None)
    _, joiner = call("POST", "/api/v1/users/signup", {"name": "joiner", "password": "pw1", "role": "admin"},
                     token=None)
    call("POST", "/api/v1/users/signup", {"name": "joiner", "password": "pw1"}, token=None)
    call("GET", "/api/v1/users", token=session["token"])
    call("GET", f"/api/v1/users/{joiner['id']}")
    call("PATCH", f"/api/v1/users/{joiner['id']}", {"state": "sleepy"})
    call("GET", "/api/v1/roles", token="guest-tok")
    call("GET", "/api/v1/roles/guest")
    call("GET", "/api/v1/roles/root")
    call("GET", "/api/v1/permissions")
    call("PUT", f"/api/v1/users/{joiner['id']}/roles/admin", {})
    call("GET", f"/api/v1/users/{joiner['id']}/roles")
    call("DELETE", f"/api/v1/users/{joiner['id']}/roles/admin")
    call("DELETE", f"/api/v1/users/{joiner['id']}/roles/admin")
    _, pat = call("POST", f"/api/v1/users/{joiner['id']}/personal-access-tokens", {"name": "ci"})
    call("GET", "/api/v1/schedulers", token=pat["token"])
    call("POST", "/api/v1/applications", {"name": "x"}, token=pat["token"])
    call("GET", f"/api/v1/users/{joiner['id']}/personal-access-tokens", token=pat["token"])
    call("GET", "/api/v1/users/1/personal-access-tokens", token=pat["token"])
    call("GET", "/api/v1/personal-access-tokens", token=pat["token"])
    _, top = call("POST", "/api/v1/personal-access-tokens", {"user_id": joiner["id"], "name": "top", "ttl": 60})
    call("POST", "/api/v1/personal-access-tokens", {"name": "orphan"})
    call("GET", "/api/v1/personal-access-tokens")
    call("GET", f"/api/v1/personal-access-tokens/{top['id']}", token=top["token"])
    call("PATCH", f"/api/v1/personal-access-tokens/{top['id']}", {"state": "inactive"})
    call("GET", "/api/v1/schedulers", token=top["token"])
    call("PATCH", f"/api/v1/personal-access-tokens/{top['id']}", {"state": "active"})
    call("DELETE", f"/api/v1/personal-access-tokens/{top['id']}")
    call("PATCH", f"/api/v1/personal-access-tokens/{top['id']}", {"state": "active"})
    call("DELETE", f"/api/v1/users/{joiner['id']}/personal-access-tokens/{pat['id']}")
    call("GET", "/api/v1/schedulers", token=pat["token"])
    _, fresh = call("POST", "/api/v1/users/refresh_token", {}, token=session["token"])
    call("GET", "/api/v1/schedulers", token=session["token"])
    call("POST", "/api/v1/users/signout", {}, token=fresh["token"])
    call("POST", "/api/v1/users/signout", {}, token="admin-tok")
    call("POST", f"/api/v1/users/{joiner['id']}/reset_password",
         {"old_password": "WRONG", "new_password": "pw2"}, token=None)
    call("POST", f"/api/v1/users/{joiner['id']}/reset_password",
         {"old_password": "pw1", "new_password": "pw2"}, token=None)
    call("POST", "/api/v1/users/signin", {"name": "joiner", "password": "pw2"}, token=None)
    # OAuth through the loopback identity provider
    provider = {"name": "fakehub", "client_id": "cid", "client_secret": "csec",
                "redirect_url": "http://console.local/callback", "auth_url": f"{idp}/authorize",
                "token_url": f"{idp}/token", "userinfo_url": f"{idp}/userinfo", "scopes": "read:user"}
    _, made = call("POST", "/api/v1/oauth", provider)
    call("POST", "/api/v1/oauth", provider)
    call("POST", "/api/v1/oauth", {"name": "half"})
    call("PATCH", f"/api/v1/oauth/{made['id']}", {"bio": "hub"})
    call("GET", "/api/v1/oauth", token="guest-tok")
    _, redirect = call("GET", "/api/v1/users/signin/fakehub", token=None)
    state = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(redirect["location"]).query))["state"]
    _, signed = call("GET", f"/api/v1/users/signin/fakehub/callback?code=good-code&state={state}", token=None)
    call("GET", "/api/v1/schedulers", token=signed["token"])
    call("GET", f"/api/v1/users/signin/fakehub/callback?code=bad&state={state}", token=None)
    call("GET", f"/api/v1/users/signin/fakehub/callback?code=good-code&state={state[:-4]}AAAA", token=None)
    call("GET", "/api/v1/users/signin/nohub", token=None)
    call("DELETE", "/api/v1/oauth/fakehub")
    # configs, buckets, applications, peers
    _, cfg = call("POST", "/api/v1/configs", {"name": "gc-ttl", "value": "3600"})
    call("POST", "/api/v1/configs", {"name": "j", "value": {"a": 1}, "bio": ["b"]})
    call("POST", "/api/v1/configs", {"name": "gc-ttl"})
    call("POST", "/api/v1/configs", {"name": 7})
    call("GET", "/api/v1/configs/gc-ttl", token="guest-tok")
    call("PATCH", f"/api/v1/configs/{cfg['id']}", {"value": "60"})
    call("PATCH", f"/api/v1/configs/{cfg['id']}", {"name": ""})
    call("DELETE", "/api/v1/configs/j")
    call("GET", "/api/v1/configs")
    call("GET", "/api/v1/buckets")
    call("POST", "/api/v1/buckets", {"name": "blobs"})
    call("POST", "/api/v1/buckets", {"name": "../escape"})
    call("GET", "/api/v1/buckets/blobs")
    call("GET", "/api/v1/buckets/nope")
    call("DELETE", "/api/v1/buckets/blobs")
    _, app = call("POST", "/api/v1/applications", {"name": "registry", "url": "https://r.io",
                                                   "priority": {"level": 3}})
    call("PATCH", f"/api/v1/applications/{app['id']}", {"url": "https://r2.io", "priority": "{}"})
    call("PATCH", "/api/v1/applications/4242", {"url": "x"})
    call("GET", f"/api/v1/applications/{app['id']}", token="guest-tok")
    call("DELETE", f"/api/v1/applications/{app['id']}")
    call("GET", "/api/v1/applications")
    _, peer = call("POST", "/api/v1/peers", {"host_id": "h-1", "hostname": "a", "ip": "10.0.0.1",
                                            "scheduler_cluster_id": c2["id"]})
    call("POST", "/api/v1/peers", {"host_id": "h-1", "scheduler_cluster_id": c2["id"]})
    call("POST", "/api/v1/peers", {})
    call("GET", f"/api/v1/peers?scheduler_cluster_id={c2['id']}")
    call("GET", f"/api/v1/peers/{peer['id']}")
    call("DELETE", f"/api/v1/peers/{peer['id']}")
    call("GET", "/api/v1/peers")
    call("DELETE", f"/api/v1/scheduler-clusters/{c2['id']}")
    call("GET", f"/api/v1/scheduler-clusters/{c2['id']}")


def test_one_request_sequence_is_answered_alike(fronts, fake_idp):
    for front in fronts.values():
        _sequence(front, fake_idp["base"])
    want, got = fronts["jax"].log, fronts["torch"].log
    assert len(got) == len(want) >= 150
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"request {i}: {w[:3]}"
    # the sequence reached every status the front answers with
    assert {w[2] for w in want} == {200, 302, 400, 401, 403, 404, 409, 503}


def test_the_openapi_documents_are_equal(fronts):
    docs = {name: _send(f.addr, "GET", "/api/v1/openapi.json", token=None) for name, f in fronts.items()}
    assert docs["torch"] == docs["jax"] and docs["torch"][0] == 200
    assert len(docs["torch"][1]["paths"]) == len({p for _m, _rx, _f, _w, _a, p in t_rest._ROUTES})


def test_the_console_pages_are_equal(fronts):
    assert t_console.index_html() == j_console.index_html()
    # the port reads its own copy, never the reference's file
    assert t_console._HERE != j_console._HERE and (t_console._HERE / "index.html").is_file()
    for path in ("/", "/console"):
        pages = {}
        for name, front in fronts.items():
            with urllib.request.urlopen(f"http://{front.addr}{path}", timeout=10) as resp:
                pages[name] = (resp.status, resp.headers["Content-Type"], resp.read())
        assert pages["torch"] == pages["jax"] == (200, "text/html; charset=utf-8", t_console.index_html())


@pytest.mark.parametrize("maker,taker", [("jax", "torch"), ("torch", "jax")])
def test_credentials_cross_between_the_packages(tmp_path, fake_idp, maker, taker):
    """Users, sessions, tokens and OAuth states that ``maker``'s front
    writes into one database file authenticate through ``taker``'s."""
    shared = tmp_path / "shared.db"
    a = _Front(PACKAGES[maker], tmp_path / maker, db_path=shared)
    b = _Front(PACKAGES[taker], tmp_path / taker, db_path=shared)
    try:
        st, _ = a.call("POST", "/api/v1/users", {"name": "root", "password": "pw-root", "role": "admin"}, token=None)
        assert st == 200
        st, session = a.call("POST", "/api/v1/users/signin", {"name": "root", "password": "pw-root"}, token=None)
        assert st == 200 and session["role"] == "admin"
        st, viewer = a.call("POST", "/api/v1/users/signup", {"name": "viewer", "password": "pw-v"}, token=None)
        st, pat = a.call("POST", f"/api/v1/users/{viewer['id']}/personal-access-tokens", {"name": "ci"},
                         token=session["token"])
        assert st == 200 and pat["token"].startswith("dfp_")
        # the password, the session and the token, through the other front
        assert b.call("POST", "/api/v1/users/signin", {"name": "root", "password": "pw-root"}, token=None)[0] == 200
        assert b.call("POST", "/api/v1/users/signin", {"name": "root", "password": "nope"}, token=None)[0] == 401
        assert b.call("POST", "/api/v1/users/signin", {"name": "viewer", "password": "pw-v"}, token=None)[0] == 200
        assert b.call("GET", "/api/v1/users", token=None)[0] == 401
        assert b.call("POST", "/api/v1/configs", {"name": "k", "value": "v"}, token=session["token"])[0] == 200
        assert b.call("GET", "/api/v1/configs/k", token=pat["token"])[0] == 200
        assert b.call("POST", "/api/v1/configs", {"name": "k2"}, token=pat["token"])[0] == 403
        # the other front revokes; the maker's front refuses the token after it
        assert b.call("DELETE", f"/api/v1/users/{viewer['id']}/personal-access-tokens/{pat['id']}",
                      token=session["token"])[0] == 200
        assert a.call("GET", "/api/v1/configs", token=pat["token"])[0] == 401
        # a new password stored by the other front signs in at the maker's
        assert b.call("POST", f"/api/v1/users/{viewer['id']}/reset_password",
                      {"old_password": "pw-v", "new_password": "pw-w"}, token=None)[0] == 200
        assert a.call("POST", "/api/v1/users/signin", {"name": "viewer", "password": "pw-w"}, token=None)[0] == 200
        # one state secret: a redirect from one front verifies at the other
        assert a.call("POST", "/api/v1/oauth", {
            "name": "fakehub", "client_id": "cid", "client_secret": "csec",
            "auth_url": f"{fake_idp['base']}/authorize", "token_url": f"{fake_idp['base']}/token",
            "userinfo_url": f"{fake_idp['base']}/userinfo"}, token=session["token"])[0] == 200
        st, redirect = a.call("GET", "/api/v1/users/signin/fakehub", token=None)
        assert st == 302
        state = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(redirect["location"]).query))["state"]
        st, signed = b.call("GET", f"/api/v1/users/signin/fakehub/callback?code=good-code&state={state}",
                            token=None)
        assert st == 200 and signed["user"]["role"] == "guest"
        assert a.call("GET", "/api/v1/schedulers", token=signed["token"])[0] == 200
        assert PORT["auth"].state_secret(a.db) == REFERENCE["auth"].state_secret(b.db)
    finally:
        a.stop()
        b.stop()
