"""The port's RESP server (``dragonfly2_torch/utils/kvserver.py``) against
the reference's (``dragonfly2_tpu/utils/kvserver.py``).

Every case of the reference's ``tests/test_kvserver.py`` runs on both
packages as a case of one parametrised test: the RESP commands, two
clients sharing one store, the topology over RESP, and ``AUTH`` with
``requirepass`` semantics. Then the packages cross: one command sequence
sent over a raw socket gets byte-identical replies from both servers,
with and without a secret, and each package's ``RemoteKVStore`` works
against the other's server. Expiry is polled for with a deadline, never
read after a fixed sleep."""

import socket
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from dragonfly2_torch.scheduler import networktopology as t_nt
from dragonfly2_torch.scheduler import resource as t_res
from dragonfly2_torch.utils import kvserver as t_kvserver
from dragonfly2_torch.utils import kvstore as t_kv

from dragonfly2_tpu.scheduler import networktopology as j_nt
from dragonfly2_tpu.scheduler import resource as j_res
from dragonfly2_tpu.utils import kvserver as j_kvserver
from dragonfly2_tpu.utils import kvstore as j_kv

torch.set_num_threads(1)

PKGS = {
    "torch": SimpleNamespace(server=t_kvserver, kv=t_kv, nt=t_nt, res=t_res),
    "jax": SimpleNamespace(server=j_kvserver, kv=j_kv, nt=j_nt, res=j_res),
}
both = pytest.mark.parametrize("pkg", sorted(PKGS))
EXPIRY_DEADLINE_S = 10.0


def _connect(m, address: str, secret: str = ""):
    """Backend selection as each package does it: the reference's
    ``kvstore.connect``; the port's scheduler server picks the same way
    from ``kv_address`` (empty → an in-process store)."""
    if m is PKGS["jax"]:
        return m.kv.connect(address, secret=secret)
    return m.kv.RemoteKVStore(address, secret=secret) if address else m.kv.KVStore()


def _gone(kv, key: str) -> bool:
    """True once ``key`` has expired, polled until a deadline."""
    deadline = time.monotonic() + EXPIRY_DEADLINE_S
    while time.monotonic() < deadline:
        if kv.get(key) is None:
            return True
        time.sleep(0.01)
    return False


@pytest.fixture
def served(pkg):
    m = PKGS[pkg]
    srv = m.server.KVServer(host="127.0.0.1")
    port = srv.serve()
    client = m.kv.RemoteKVStore(f"127.0.0.1:{port}")
    yield m, srv, client
    client.close()
    srv.stop()


# ---------------------------------------------------------------------------
# the reference's cases, on both packages
# ---------------------------------------------------------------------------


@both
def test_string_roundtrip(served):
    _, _, kv = served
    kv.set("k", "value")
    assert kv.get("k") == "value"
    assert kv.get("absent") is None
    assert kv.exists("k") and not kv.exists("absent")
    assert kv.delete("k") == 1
    assert kv.get("k") is None


@both
def test_counters(served):
    _, _, kv = served
    assert kv.incr("c") == 1
    assert kv.incr("c", 5) == 6
    assert kv.get("c") == "6"


@both
def test_hash(served):
    _, _, kv = served
    kv.hset("h", {"a": 1, "b": "two"})
    assert kv.hget("h", "a") == "1"
    assert kv.hget("h", "missing") is None
    assert kv.hgetall("h") == {"a": "1", "b": "two"}


@both
def test_list_bounded_queue(served):
    _, _, kv = served
    kv.rpush("q", "x", "y", "z")
    assert kv.llen("q") == 3
    assert kv.lrange("q", 0, -1) == ["x", "y", "z"]
    assert kv.lpop("q") == "x"
    assert kv.llen("q") == 2


@both
def test_keys_scan(served):
    _, _, kv = served
    kv.set("networktopology:a:b", "1")
    kv.set("networktopology:a:c", "1")
    kv.set("probes:a:b", "1")
    assert sorted(kv.scan_iter("networktopology:a:*")) == [
        "networktopology:a:b",
        "networktopology:a:c",
    ]


@both
def test_expire(served):
    _, _, kv = served
    kv.set("t", "v")
    assert kv.expire("t", 0.05)
    assert _gone(kv, "t")


@both
def test_binary_safe_values(served):
    _, _, kv = served
    payload = "with\r\nnewlines and \x00 bytes and unicode ✓"
    kv.set("bin", payload)
    assert kv.get("bin") == payload


@both
def test_unknown_command_is_error_not_disconnect(served):
    _, _, kv = served
    with pytest.raises(ValueError):
        kv._call("NOSUCH")
    kv.set("still", "alive")  # same connection keeps working
    assert kv.get("still") == "alive"


@both
def test_set_with_ttl_is_one_atomic_command(served):
    """The fleet lease write: SET k v PX ms expires without a separate
    PEXPIRE round trip (scheduler/fleet.py heartbeat)."""
    _, _, kv = served
    kv.set_with_ttl("lease", "x", 0.05)
    assert _gone(kv, "lease")
    kv.set_with_ttl("lease", "x", 60.0)
    assert kv.get("lease") == "x"
    # EX form too (seconds)
    kv._call("SET", "lease2", "y", "EX", "1")
    assert kv.get("lease2") == "y"


@both
def test_set_with_dangling_ttl_option_is_error_not_disconnect(served):
    _, _, kv = served
    with pytest.raises(ValueError):
        kv._call("SET", "k", "v", "PX")  # option with no operand
    kv.set("still", "here")  # connection survived the syntax error
    assert kv.get("still") == "here"


@both
def test_flushall(served):
    _, _, kv = served
    kv.set("a", "1")
    kv.flushall()
    assert kv.scan_iter("*") == []


@both
def test_two_clients_share_state(served):
    m, srv, kv1 = served
    kv2 = m.kv.RemoteKVStore(f"127.0.0.1:{srv.port}")
    try:
        kv1.incr("probedcount:h1")
        kv2.incr("probedcount:h1")
        assert kv1.get("probedcount:h1") == "2"
        kv2.hset("networktopology:a:b", {"averageRTT": 42})
        assert kv1.hget("networktopology:a:b", "averageRTT") == "42"
    finally:
        kv2.close()


@both
def test_reconnect_after_server_restart_socket_drop(served):
    _, _, kv = served
    kv.set("k", "1")
    # sever the client's socket underneath it; next call reconnects
    kv._sock.shutdown(socket.SHUT_RDWR)
    kv._sock.close()
    assert kv.get("k") == "1"


@both
def test_concurrent_clients(served):
    m, srv, _ = served
    errors = []

    def worker(n):
        c = m.kv.RemoteKVStore(f"127.0.0.1:{srv.port}")
        try:
            for i in range(50):
                c.incr("shared")
                c.hset(f"h{n}", {"i": i})
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(n,)) for n in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    client = m.kv.RemoteKVStore(f"127.0.0.1:{srv.port}")
    try:
        assert client.get("shared") == "200"
    finally:
        client.close()


def _topology(m, kv):
    hm = m.res.HostManager()
    for hid in ("h0", "h1", "h2"):
        hm.store(m.res.Host(id=hid, ip="10.0.0.1"))
    return m.nt.NetworkTopology(kv, hm)


@both
@pytest.mark.parametrize("backend", ["local", "resp"])
def test_probe_flow(served, backend):
    """NetworkTopology behaves identically on both backends — the
    in-process store is the spec, the served store is the deployment."""
    m, _, remote = served
    kv = m.kv.KVStore() if backend == "local" else remote
    nt = _topology(m, kv)
    base = 100_000_000
    for i in range(7):  # overflow the 5-deep queue
        nt.enqueue_probe("h0", m.nt.Probe("h1", base + i, created_at=time.time()))
    q = nt.probes("h0", "h1")
    assert len(q) == 5  # bounded
    assert all(isinstance(e, dict) and "rtt" in e for e in q)
    assert nt.probed_count("h1") == 7
    # EWMA: nearly last-sample (0.1 old + 0.9 new)
    rtt = nt.average_rtt("h0", "h1")
    assert rtt is not None and abs(rtt - (base + 6)) < base * 0.2
    recs = nt.export_records()
    assert len(recs) == 1 and recs[0].dest_hosts[0].id == "h1"
    nt.delete_host("h1")
    assert nt.average_rtt("h0", "h1") is None
    assert nt.probes("h0", "h1") == []


@both
def test_two_schedulers_one_graph(served):
    """Probes from TWO topology instances (standing in for two scheduler
    processes) land in ONE store."""
    m, srv, _ = served
    nt_a = _topology(m, m.kv.RemoteKVStore(f"127.0.0.1:{srv.port}"))
    nt_b = _topology(m, m.kv.RemoteKVStore(f"127.0.0.1:{srv.port}"))
    nt_a.enqueue_probe("h0", m.nt.Probe("h1", 10_000_000))
    nt_b.enqueue_probe("h2", m.nt.Probe("h1", 20_000_000))
    # both edges visible from either instance; probed counts merged
    assert nt_b.average_rtt("h0", "h1") == 10_000_000
    assert nt_a.average_rtt("h2", "h1") == 20_000_000
    assert nt_a.probed_count("h1") == 2
    srcs = {r.host.id for r in nt_b.export_records()}
    assert srcs == {"h0", "h2"}


@both
def test_connect_backend_selection(pkg):
    m = PKGS[pkg]
    assert isinstance(_connect(m, ""), m.kv.KVStore)
    assert isinstance(_connect(m, "127.0.0.1:6379"), m.kv.RemoteKVStore)


@pytest.fixture
def secured(pkg):
    m = PKGS[pkg]
    srv = m.server.KVServer(host="127.0.0.1", secret="hunter2")
    srv.serve()
    yield m, srv
    srv.stop()


def _raw(port: int, *commands: bytes) -> list:
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        out = []
        for c in commands:
            s.sendall(c)
            out.append(s.recv(4096))
        return out


@both
def test_unauthenticated_commands_rejected(secured):
    _, srv = secured
    replies = _raw(srv.port, b"*1\r\n$4\r\nPING\r\n", b"*2\r\n$3\r\nGET\r\n$1\r\nk\r\n")
    assert all(r.startswith(b"-NOAUTH") for r in replies)


@both
def test_wrong_password_rejected_then_correct_accepted(secured):
    _, srv = secured
    replies = _raw(
        srv.port,
        b"*2\r\n$4\r\nAUTH\r\n$5\r\nwrong\r\n",
        b"*2\r\n$4\r\nAUTH\r\n$7\r\nhunter2\r\n",
        b"*1\r\n$4\r\nPING\r\n",
    )
    assert replies[0].startswith(b"-ERR invalid password")
    assert replies[1] == b"+OK\r\n"
    assert replies[2] == b"+PONG\r\n"


@both
def test_two_arg_auth_requires_default_user(secured):
    _, srv = secured
    replies = _raw(
        srv.port,
        b"*3\r\n$4\r\nAUTH\r\n$5\r\nadmin\r\n$7\r\nhunter2\r\n",
        b"*3\r\n$4\r\nAUTH\r\n$7\r\ndefault\r\n$7\r\nhunter2\r\n",
        b"*1\r\n$4\r\nPING\r\n",
    )
    assert replies[0].startswith(b"-ERR")
    assert replies[1] == b"+OK\r\n"
    assert replies[2] == b"+PONG\r\n"


@both
def test_auth_without_secret_is_error_but_connection_stays_open(served):
    _, srv, _ = served
    replies = _raw(srv.port, b"*2\r\n$4\r\nAUTH\r\n$2\r\npw\r\n", b"*1\r\n$4\r\nPING\r\n")
    assert replies[0].startswith(b"-ERR")
    assert replies[1] == b"+PONG\r\n"  # open server stays usable


@both
def test_remote_kvstore_authenticates(secured):
    m, srv = secured
    kv = m.kv.RemoteKVStore(f"127.0.0.1:{srv.port}", secret="hunter2")
    kv.set("k", "v")
    assert kv.get("k") == "v"
    kv.close()
    # reconnect after close re-authenticates transparently
    assert kv.get("k") == "v"
    kv.close()


@both
def test_remote_kvstore_wrong_secret_raises(secured):
    m, srv = secured
    kv = m.kv.RemoteKVStore(f"127.0.0.1:{srv.port}", secret="nope")
    with pytest.raises(ValueError, match="invalid password"):
        kv.get("k")
    kv.close()


@both
def test_remote_kvstore_no_secret_gets_noauth(secured):
    m, srv = secured
    kv = m.kv.RemoteKVStore(f"127.0.0.1:{srv.port}")
    with pytest.raises(ValueError, match="NOAUTH"):
        kv.set("k", "v")
    kv.close()


@both
def test_connect_passes_secret(secured):
    m, srv = secured
    kv = _connect(m, f"127.0.0.1:{srv.port}", secret="hunter2")
    assert kv.incr("c") == 1
    kv.close()


@both
def test_default_bind_is_loopback(pkg):
    srv = PKGS[pkg].server.KVServer()
    assert srv._host == "127.0.0.1"


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _cmd(*parts: str) -> bytes:
    out = b"*%d\r\n" % len(parts)
    for p in parts:
        data = p.encode()
        out += b"$%d\r\n%s\r\n" % (len(data), data)
    return out


# one session: every command the servers implement, the errors a client
# may provoke, and the inline form redis-cli may send
SEQUENCE = [
    b"PING\r\n",
    _cmd("PING"), _cmd("PING", "hi"), _cmd("ECHO", "e\r\nx"),
    _cmd("SET", "s", "1"), _cmd("SET", "t", "2", "PX", "60000"), _cmd("SET", "u", "3", "EX", "60"),
    _cmd("SET", "v", "4", "px", "60000"), _cmd("SET", "w", "5", "PX"), _cmd("SET", "x", "6", "EX", "soon"),
    _cmd("GET", "s"), _cmd("GET", "absent"), _cmd("MGET", "s", "absent", "t"),
    _cmd("EXISTS", "s", "t", "absent"), _cmd("DEL", "u", "absent"),
    _cmd("EXPIRE", "s", "600"), _cmd("PEXPIRE", "t", "600000"), _cmd("EXPIRE", "absent", "1"),
    _cmd("INCR", "n"), _cmd("INCRBY", "n", "41"), _cmd("INCR", "s"), _cmd("INCRBY", "n", "x"),
    _cmd("HSET", "h", "a", "1", "b", "2"), _cmd("HSET", "h", "b", "3"), _cmd("HSET", "h", "odd"),
    _cmd("HGET", "h", "b"), _cmd("HGET", "h", "z"), _cmd("HMGET", "h", "a", "z", "b"),
    _cmd("HGETALL", "h"), _cmd("HDEL", "h", "a", "z"), _cmd("HGETALL", "h"), _cmd("HGETALL", "absent"),
    _cmd("RPUSH", "l", "a", "b", "c"), _cmd("LLEN", "l"), _cmd("LRANGE", "l", "0", "-1"),
    _cmd("LRANGE", "l", "1", "1"), _cmd("LPOP", "l"), _cmd("LPOP", "absent"), _cmd("LLEN", "absent"),
    _cmd("KEYS", "h*"), _cmd("SCAN", "0", "MATCH", "l*"), _cmd("SCAN", "0", "MATCH"),
    _cmd("GET", "h"), _cmd("NOSUCH", "a"), _cmd("GET"), _cmd("FLUSHALL"), _cmd("KEYS", "*"),
    _cmd("AUTH", "pw"),
]


def _reply_end(buf: bytes, i: int = 0) -> "int | None":
    """The end of the one RESP reply that starts at ``buf[i]``, or None
    while it is incomplete."""
    nl = buf.find(b"\r\n", i)
    if nl < 0:
        return None
    kind, end = buf[i:i + 1], nl + 2
    if kind == b"$":
        n = int(buf[i + 1:nl])
        end = end if n < 0 else end + n + 2
        return end if len(buf) >= end else None
    if kind == b"*":
        for _ in range(int(buf[i + 1:nl])):
            end = _reply_end(buf, end)
            if end is None:
                return None
    return end


def _replies(port: int, commands, auth: "bytes | None" = None) -> "list[bytes]":
    """Each command's reply, read until it is one whole RESP value."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        for c in ([auth] if auth else []) + list(commands):
            s.sendall(c)
            data = b""
            while not data or _reply_end(data) != len(data):
                more = s.recv(65536)
                assert more, f"the server hung up after {c!r}"
                data += more
            out.append(data)
    return out[1:] if auth else out


@pytest.mark.parametrize("secret", ["", "hunter2"])
def test_raw_replies_are_byte_identical(secret):
    replies = {}
    for name, m in PKGS.items():
        srv = m.server.KVServer(host="127.0.0.1", secret=secret)
        srv.serve()
        try:
            before = _replies(srv.port, [_cmd("GET", "s"), _cmd("AUTH", "wrong"), _cmd("AUTH", "a", "b", "c")])
            auth = _cmd("AUTH", secret) if secret else None
            replies[name] = (before, _replies(srv.port, SEQUENCE, auth=auth))
        finally:
            srv.stop()
    assert replies["torch"] == replies["jax"]
    before, seq = replies["torch"]
    if secret:
        assert before[0].startswith(b"-NOAUTH") and before[1] == b"-ERR invalid password\r\n"
        assert seq[-1] == b"-ERR invalid password\r\n"
    else:
        assert before[0] == b"$-1\r\n" and before[1].startswith(b"-ERR Client sent AUTH")
    # the -ERR for an unknown command kept the connection: later commands answered
    assert any(r.startswith(b"-ERR unknown command") for r in seq) and seq[-2] == b"*0\r\n"


@pytest.mark.parametrize("client,server", [("torch", "jax"), ("jax", "torch")])
@pytest.mark.parametrize("secret", ["", "hunter2"])
def test_each_client_against_the_other_server(client, server, secret):
    srv = PKGS[server].server.KVServer(host="127.0.0.1", secret=secret)
    port = srv.serve()
    kv = PKGS[client].kv.RemoteKVStore(f"127.0.0.1:{port}", secret=secret)
    try:
        kv.set("s", "v")
        kv.set_with_ttl("lease", "x", 60.0)
        assert kv.mget(["s", "absent", "lease"]) == ["v", None, "x"]
        assert kv.incr("n", 3) == 3
        kv.hset("h", {"a": "1", "b": "2"})
        assert kv.hmget("h", ["b", "z", "a"]) == ["2", None, "1"]
        kv.hset_batch([("r1", {"epoch": "1", "data": "{}"}), ("r2", {"epoch": "2"})], ttl_ms=600_000)
        assert kv.hgetall("r1") == {"epoch": "1", "data": "{}"} and kv.hget("r2", "epoch") == "2"
        assert kv.hdel("h", "a", "z") == 1 and kv.hgetall("h") == {"b": "2"}
        kv.rpush("q", "1", "2")
        assert kv.lrange("q", 0, -1) == ["1", "2"] and kv.lpop("q") == "1" and kv.llen("q") == 1
        assert sorted(kv.scan_iter("r*")) == ["r1", "r2"]
        assert kv.expire("s", 0.05) and _gone(kv, "s")
        with pytest.raises(ValueError):
            kv._call("NOSUCH")
        assert kv.delete("lease", "absent") == 1
        # the server's own store holds what the other package's client wrote
        assert int(srv.store.get("n")) == 3 and srv.store.hget("r1", "epoch") == "1"
    finally:
        kv.close()
        srv.stop()
