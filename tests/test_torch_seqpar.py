"""The port's sequence-parallel plane (``dragonfly2_torch.ops.{ring,ulysses}``,
``dragonfly2_torch.parallel``) over gloo worlds of 2 and 4 processes, against
the JAX package's ring and Ulysses paths on a ``make_mesh(jax.devices()[:n],
sp=n)`` mesh of this process's virtual CPU devices, on the same seeded
inputs.

Each world is spawned once for the module (``tests/torch_seqpar_child.py``,
one process a rank, a ``FileStore`` under a temporary directory, never
jax): every rank runs every case on its shards and returns what it got, and
the tests here concatenate the shards and compare. The encoder case (the
slice as a whole) runs in the world of 2: gradients of every encoder
parameter through Ulysses with the flash path, summed over the ranks, against
``jax.grad`` of the JAX encoder with ``local_attention``.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from dragonfly2_torch.parallel import distributed as tdist
from dragonfly2_torch.parallel.mesh import axis_sizes
from dragonfly2_tpu.models.attention import apply_transformer, init_transformer
from dragonfly2_tpu.ops.ring import make_ring_attention, ring_all_gather, ring_gather_rows
from dragonfly2_tpu.ops.ulysses import make_ulysses_attention
from dragonfly2_tpu.parallel.mesh import make_mesh, mesh_shape

REPO = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).resolve().parent / "torch_seqpar_child.py"
WORLDS = (2, 4)
B, T_PER_RANK, H, D = 2, 16, 8, 8  # H > sp and B > 1: a transposed layout shows
ENCODER = dict(in_dim=2, model_dim=32, num_heads=4, num_layers=2)
ENCODER_T = 64


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(100 + n)
    t = T_PER_RANK * n
    q, k, v = (rng.standard_normal((B, t, H, D)).astype(np.float32) for _ in range(3))
    inp = {
        "q": q, "k": k, "v": v,
        "q_odd_heads": rng.standard_normal((B, t, n + 1, D)).astype(np.float32),
        "table": rng.standard_normal((6 * n, 5)).astype(np.float32),
        "indices": rng.integers(0, 6 * n, size=(7 * n,)).astype(np.int64),
    }
    if n == 2:
        params = init_transformer(jax.random.PRNGKey(0), **ENCODER)
        inp["tree"] = jax.tree_util.tree_map(np.asarray, params)
        inp["x"] = rng.standard_normal((B, ENCODER_T, ENCODER["in_dim"])).astype(np.float32)
        inp["w"] = rng.standard_normal((B, ENCODER_T, ENCODER["model_dim"])).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, spawned at once → {n: (inputs, [rank outputs])}."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    runs = {}
    for n in WORLDS:
        work = tmp_path_factory.mktemp(f"sp{n}")
        inputs = _inputs(n)
        (work / "inputs.pkl").write_bytes(pickle.dumps(inputs))
        procs = [
            subprocess.Popen(
                [sys.executable, str(CHILD), str(work), str(n), str(r)],
                cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for r in range(n)
        ]
        runs[n] = (work, inputs, procs)
    out = {}
    try:
        for n, (work, inputs, procs) in runs.items():
            logs = [p.communicate(timeout=240)[0] for p in procs]
            for r, (p, log) in enumerate(zip(procs, logs)):
                assert p.returncode == 0, f"rank {r} of {n} failed:\n{log}"
            out[n] = (inputs, [pickle.loads((work / f"out_{r}.pkl").read_bytes()) for r in range(n)])
    finally:
        for _, _, procs in runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def _cat(ranks, key, axis=1):
    return np.concatenate([r[key] for r in ranks], axis=axis)


def _mesh(n):
    return make_mesh(jax.devices()[:n], sp=n)


def _sharded(mesh, *xs):
    spec = NamedSharding(mesh, P(None, "sp", None, None))
    return [jax.device_put(jnp.asarray(x), spec) for x in xs]


# --- mesh rules and the launcher's environment ---


@pytest.mark.parametrize(
    "n,axes",
    [
        (8, {}),
        (8, {"sp": -1}),
        (8, {"dp": 2, "sp": -1}),
        (8, {"dp": 2, "mp": 2, "sp": -1}),
        (4, {"sp": 2}),  # fewer ranks than there are
        (4, {"sp": 8}),  # too many
        (6, {"dp": 4, "sp": -1}),  # not divisible
        (8, {"dp": -1, "sp": -1}),  # two unknown axes
    ],
)
def test_axis_rules_match_reference(n, axes):
    try:
        want = mesh_shape(make_mesh(jax.devices()[:n], **axes))
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc).split(" ")[0]):
            axis_sizes(n, **axes)
        return
    assert axis_sizes(n, **axes) == want


@pytest.mark.parametrize("n", WORLDS)
def test_make_mesh_in_a_world(worlds, n):
    _, ranks = worlds[n]
    for got in ranks:
        m = got["mesh"]
        assert m["default"] == {"dp": n} and m["sp-1"] == {"sp": n} and m["auto"] == {"dp": n}
        assert m["dp2"] == {"dp": 2, "sp": n // 2}
        assert "needs" in m["too_many"]


def test_ensure_initialized_without_environment(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert tdist.ensure_initialized(device="cpu") is False


def test_ensure_initialized_needs_world_size_and_rank(monkeypatch):
    for key in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(ValueError, match="WORLD_SIZE and RANK"):
        tdist.ensure_initialized(device="cpu")


def test_backend_follows_the_device():
    assert tdist.backend_for("cpu") == "gloo"


# --- ring ---


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", WORLDS)
def test_ring_forward_matches_reference(worlds, n, causal):
    inp, ranks = worlds[n]
    mesh = _mesh(n)
    want = jax.jit(make_ring_attention(mesh, "sp", causal=causal))(
        *_sharded(mesh, inp["q"], inp["k"], inp["v"])
    )
    np.testing.assert_allclose(_cat(ranks, f"ring_{causal}"), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("n", WORLDS)
def test_ring_bfloat16_matches_reference(worlds, n):
    inp, ranks = worlds[n]
    mesh = _mesh(n)
    bf = [jnp.asarray(inp[x], jnp.bfloat16) for x in "qkv"]
    want = jax.jit(make_ring_attention(mesh, "sp", causal=True))(*_sharded(mesh, *bf))
    # two float32 sums on either side of a bfloat16 rounding point: one step
    # (2^-7·|o|) apart, with room for one more
    np.testing.assert_allclose(
        _cat(ranks, "ring_bf16"), np.asarray(want, np.float32), atol=1e-5, rtol=2**-6
    )


@pytest.mark.parametrize("n", WORLDS)
def test_ring_gradients_match_reference(worlds, n):
    inp, ranks = worlds[n]
    mesh = _mesh(n)
    ring = make_ring_attention(mesh, "sp", causal=True)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(ring(*a) ** 2), argnums=(0, 1, 2)))(
        *_sharded(mesh, inp["q"], inp["k"], inp["v"])
    )
    got = [np.concatenate([r["ring_grad"][i] for r in ranks], axis=1) for i in (1, 2, 3)]
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=3e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("n", WORLDS)
def test_ring_all_gather_matches_reference(worlds, n):
    inp, ranks = worlds[n]
    mesh = _mesh(n)
    fn = jax.jit(shard_map(
        lambda x: ring_all_gather(x, "sp")[None], mesh=mesh, in_specs=P("sp", None),
        out_specs=P("sp", None, None), check_vma=False,
    ))
    want = np.asarray(fn(jnp.asarray(inp["table"])))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["all_gather"], want[r])
        np.testing.assert_array_equal(got["all_gather"], inp["table"])


@pytest.mark.parametrize("n", WORLDS)
def test_ring_gather_rows_matches_reference(worlds, n):
    inp, ranks = worlds[n]
    mesh = _mesh(n)
    fn = jax.jit(shard_map(
        lambda t, i: ring_gather_rows(t, i, "sp"), mesh=mesh, in_specs=(P("sp", None), P("sp")),
        out_specs=P("sp", None), check_vma=False,
    ))
    want = np.asarray(fn(jnp.asarray(inp["table"]), jnp.asarray(inp["indices"], jnp.int32)))
    np.testing.assert_array_equal(_cat(ranks, "gather_rows", axis=0), want)
    np.testing.assert_array_equal(want, inp["table"][inp["indices"]])


@pytest.mark.parametrize("n", WORLDS)
def test_causal_ring_rejects_unequal_shards(worlds, n):
    inp, ranks = worlds[n]
    mesh = _mesh(n)
    half = inp["k"][:, : inp["k"].shape[1] // 2]
    with pytest.raises(ValueError, match="equal q/k shard lengths") as exc:
        make_ring_attention(mesh, "sp", causal=True)(*_sharded(mesh, inp["q"], half, half))
    for got in ranks:
        assert got["unequal_error"] == str(exc.value)


# --- Ulysses ---


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_forward_matches_reference(worlds, n, causal):
    inp, ranks = worlds[n]
    mesh = _mesh(n)
    want = jax.jit(make_ulysses_attention(mesh, "sp", causal=causal))(
        *_sharded(mesh, inp["q"], inp["k"], inp["v"])
    )
    np.testing.assert_allclose(_cat(ranks, f"ulysses_{causal}"), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_kernel_path_trains_like_the_plain_one(worlds, n):
    """The flash path (its plain version here) under Ulysses: same output
    and gradients as ``local_attention`` under Ulysses, within the
    reference's limit between its Pallas and XLA paths."""
    _, ranks = worlds[n]
    for r in ranks:
        for i, what in enumerate(("out", "dq", "dk", "dv")):
            np.testing.assert_allclose(
                r["ulysses_kernel_grad"][i], r["ulysses_grad"][i], atol=2e-3, rtol=2e-3,
                err_msg=what,
            )


@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_gradients_match_reference(worlds, n):
    inp, ranks = worlds[n]
    mesh = _mesh(n)
    uly = make_ulysses_attention(mesh, "sp", causal=True)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(uly(*a) ** 2), argnums=(0, 1, 2)))(
        *_sharded(mesh, inp["q"], inp["k"], inp["v"])
    )
    got = [np.concatenate([r["ulysses_kernel_grad"][i] for r in ranks], axis=1) for i in (1, 2, 3)]
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-3, rtol=2e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_heads_must_divide(worlds, n):
    inp, ranks = worlds[n]
    mesh = _mesh(n)
    odd = inp["q_odd_heads"]
    with pytest.raises(ValueError, match="heads % axis_size") as exc:
        make_ulysses_attention(mesh, "sp")(*_sharded(mesh, odd, odd, odd))
    for got in ranks:
        assert got["heads_error"] == str(exc.value)


@pytest.mark.parametrize("n", WORLDS)
def test_plain_path_counts_no_launch(worlds, n):
    _, ranks = worlds[n]
    assert all(r["kernel_launches"] == 0 for r in ranks)


# --- the slice: the encoder's gradients through Ulysses and the flash path ---


def _reference_encoder(inp):
    params = jax.tree_util.tree_map(jnp.asarray, inp["tree"])
    x, w = jnp.asarray(inp["x"]), jnp.asarray(inp["w"])

    def loss(embed, layers):
        h = apply_transformer(
            dict(params, embed=embed, layers=layers), x, causal=True, compute_dtype=jnp.float32
        )
        return jnp.sum(h * w), h

    (_, h), (g_embed, g_layers) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params["embed"], params["layers"]
    )
    return np.asarray(h), g_embed, g_layers


def _reference_grad(name, g_embed, g_layers):
    if name == "embed":
        return g_embed
    _, i, *path = name.split(".")
    node = g_layers[int(i)]
    for key in path:
        node = node[key]
    return node


def test_encoder_output_matches_reference(worlds):
    inp, ranks = worlds[2]
    want, _, _ = _reference_encoder(inp)
    np.testing.assert_allclose(
        np.concatenate([r["encoder"]["out"] for r in ranks], axis=1), want, atol=1e-4
    )
    assert all(r["encoder"]["launches"] == 0 for r in ranks)


@pytest.mark.parametrize("part", ["embed", "layers.0", "layers.1"])
def test_encoder_gradients_match_reference(worlds, part):
    """Every parameter's gradient of sum(encoder(x) ⊙ w) over both ranks,
    through Ulysses (sp = 2) with the flash path, against ``jax.grad`` of the
    JAX encoder with ``local_attention``, in float32: summation order only,
    so within 1e-4 of the largest entry of each gradient and 1e-3 of each
    entry."""
    inp, ranks = worlds[2]
    _, g_embed, g_layers = _reference_encoder(inp)
    got = ranks[0]["encoder"]["grads"]
    names = [n for n in got if n == part or n.startswith(part + ".")]
    assert names and not any(n.startswith("head.") for n in got)
    for name in names:
        want = np.asarray(_reference_grad(name, g_embed, g_layers))
        for r in ranks[1:]:  # every rank holds the same all-reduced gradient
            np.testing.assert_array_equal(r["encoder"]["grads"][name], got[name])
        np.testing.assert_allclose(
            got[name], want, atol=1e-4 * np.abs(want).max(), rtol=1e-3, err_msg=name
        )
