"""The port's KV store (``utils/kvstore.py``) against the reference's: the
in-process ``KVStore`` answers the same operations with the same values,
and the port's RESP client ``RemoteKVStore`` against the reference's
``utils/kvserver.KVServer`` answers as the reference's client does."""

import pytest

from dragonfly2_torch.utils import kvstore as t_kv

from dragonfly2_tpu.utils import kvstore as j_kv
from dragonfly2_tpu.utils.kvserver import KVServer

# (method, args) in order; each store's answers are compared call by call
SCRIPTS = {
    "strings": [
        ("set", ("k", "v")), ("get", ("k",)), ("get", ("absent",)), ("exists", ("k",)),
        ("exists", ("absent",)), ("delete", ("k", "absent")), ("get", ("k",)),
    ],
    "counters": [
        ("incr", ("c",)), ("incr", ("c", 5)), ("get", ("c",)), ("incr", ("d", 2)),
    ],
    "hashes": [
        ("hset", ("h", {"a": "1", "b": "2"})), ("hset", ("h", {"b": "3", "c": "4"})),
        ("hget", ("h", "b")), ("hget", ("h", "z")), ("hgetall", ("h",)),
        ("hmget", ("h", ["a", "z", "c"])), ("hdel", ("h", "a", "z")), ("hgetall", ("h",)),
        ("hgetall", ("absent",)),
    ],
    "lists": [
        ("rpush", ("l", "a", "b")), ("rpush", ("l", "c")), ("llen", ("l",)), ("lrange", ("l", 0, -1)),
        ("lrange", ("l", 1, 1)), ("lpop", ("l",)), ("lrange", ("l", 0, -1)), ("lpop", ("absent",)),
        ("llen", ("absent",)),
    ],
    "drained_list": [
        # a probe queue at its bound, then drained: the key stays
        ("rpush", ("q", "1", "2", "3", "4", "5")), ("lpop", ("q",)), ("rpush", ("q", "6")),
        ("lrange", ("q", 0, -1)), ("lpop", ("q",)), ("lpop", ("q",)), ("lpop", ("q",)), ("lpop", ("q",)),
        ("lpop", ("q",)), ("lpop", ("q",)), ("llen", ("q",)), ("exists", ("q",)), ("lrange", ("q", 0, -1)),
        ("rpush", ("q", "7")), ("lrange", ("q", 0, -1)), ("delete", ("q",)), ("exists", ("q",)),
    ],
    "scan": [
        ("set", ("networktopology:a:b", "1")), ("set", ("networktopology:a:c", "1")),
        ("set", ("probes:a:b", "1")), ("scan_iter", ("networktopology:*",)),
        ("scan_iter", ("networktopology:a:*",)), ("scan_iter", ("nothing*",)),
    ],
    "expiry": [
        ("set_with_ttl", ("t", "v", 60.0)), ("get", ("t",)), ("expire", ("t", 120.0)),
        ("expire", ("absent", 1.0)), ("exists", ("t",)),
    ],
    "flush": [
        ("set", ("a", "1")), ("rpush", ("b", "x")), ("flushall", ()), ("exists", ("a",)),
        ("scan_iter", ("*",)),
    ],
}


def _norm(v):
    # scan order is the store's; the keys are what is compared
    return sorted(v) if isinstance(v, list) and v and all(isinstance(x, str) for x in v) and ":" in v[0] else v


def _run(store, script):
    return [_norm(getattr(store, name)(*args)) for name, args in script]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_in_process_store_matches(name):
    assert _run(t_kv.KVStore(), SCRIPTS[name]) == _run(j_kv.KVStore(), SCRIPTS[name])


@pytest.fixture
def kv_server():
    srv = KVServer(host="127.0.0.1")
    port = srv.serve()
    yield f"127.0.0.1:{port}"
    srv.stop()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_remote_client_matches_the_reference_client(name, kv_server):
    port = t_kv.RemoteKVStore(kv_server)
    got = _run(port, SCRIPTS[name])
    port.flushall()
    ref = j_kv.RemoteKVStore(kv_server)
    want = _run(ref, SCRIPTS[name])
    port.close()
    ref.close()
    assert got == want


def test_remote_batches_and_auth():
    srv = KVServer(host="127.0.0.1", secret="s3cret")
    addr = f"127.0.0.1:{srv.serve()}"
    try:
        port = t_kv.RemoteKVStore(addr, secret="s3cret")
        ref = j_kv.RemoteKVStore(addr, secret="s3cret")
        port.hset("e:1", {"averageRTT": "10"})
        ref.hset("e:2", {"averageRTT": "20"})
        port.set("n:1", "7")
        got, want = ([s.hget_batch(["e:1", "e:2", "e:3"], "averageRTT"), s.mget(["n:1", "nope"])]
                     for s in (port, ref))
        assert got == want and got[0] == ["10", "20", None] and got[1] == ["7", None]
        port.close()
        ref.close()
        with pytest.raises(Exception):
            t_kv.RemoteKVStore(addr, secret="wrong").get("e:1")
    finally:
        srv.stop()


def test_key_helpers_match():
    for fn in ("make_network_topology_key", "make_probes_key"):
        assert getattr(t_kv, fn)("a", "b") == getattr(j_kv, fn)("a", "b")
    assert t_kv.make_probed_count_key("a") == j_kv.make_probed_count_key("a")
