"""The port's fit loops (dragonfly2_torch.trainer.train, models.gnn,
ops.segment, schema.features' probe graph) against the JAX package's on
the CPU, from one init tree loaded into both (JAX's random init cannot be
reproduced in torch): the optimizer and both schedules step for step
against optax, ``train_mlp`` and ``train_gnn`` epoch for epoch, the probe
graph array for array, and the evaluation metrics."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dragonfly2_torch.models import gnn as t_gnn
from dragonfly2_torch.ops import segment as t_segment
from dragonfly2_torch.schema import features as t_features
from dragonfly2_torch.trainer import train as t_train
from dragonfly2_torch.weights import graphsage_from_numpy, mlp_from_numpy, module_tree
from dragonfly2_tpu.models import gnn as j_gnn
from dragonfly2_tpu.models import mlp as j_mlp
from dragonfly2_tpu.ops import segment as j_segment
from dragonfly2_tpu.schema import columnar as j_columnar
from dragonfly2_tpu.schema import features as j_features
from dragonfly2_tpu.schema import synth as j_synth
from dragonfly2_tpu.trainer import train as j_train

torch.set_num_threads(1)


def _numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _leaves(tree) -> dict:
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            out[prefix[:-1]] = np.asarray(node, np.float64)

    walk(tree, "")
    return out


def _max_rel(got_tree, want_tree) -> float:
    """max over leaves of max|got - want| / max|want|."""
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert got.keys() == want.keys()
    return max(
        float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30)) for k in got
    )


# -- optimizer and schedules -------------------------------------------------


@pytest.mark.parametrize("total", [1, 7, 60, 1000])
def test_warmup_cosine_schedule_matches_optax(total):
    warmup, decay = max(1, int(total * 0.1)), max(2, total)
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, decay)
    got = t_train.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, decay)
    for c in list(range(min(total + 5, 200))) + [total, total + 50]:
        # float32 cos on either side may differ by one ulp
        assert abs(got(c) - float(want(c))) <= 2e-7 * 3e-3, c
    assert got(0) == 0.0


def test_linear_schedule_matches_optax():
    want = optax.linear_schedule(0.0, 3e-3, 64)
    got = t_train.linear_schedule(0.0, 3e-3, 64)
    assert [got(c) for c in range(100)] == [float(want(c)) for c in range(100)]


@pytest.mark.parametrize("schedule", ["warmup_cosine", "linear"])
def test_adamw_matches_optax_step_for_step(schedule):
    """60 updates of one tree from the same gradients: every parameter
    within 1e-6 of optax's (relative to the leaf's largest), and the first
    update — lr 0 at count 0 — leaves the parameters as they were."""
    rng = np.random.default_rng(0)
    tree = {
        "layers": [
            {"w": rng.standard_normal((7, 5)).astype(np.float32), "b": np.zeros(5, np.float32)},
            {"w": rng.standard_normal((5, 1)).astype(np.float32), "b": np.zeros(1, np.float32)},
        ]
    }
    grads = [
        jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.1, tree)
        for _ in range(60)
    ]
    if schedule == "linear":
        opt = optax.adamw(optax.linear_schedule(0.0, 3e-3, 64), weight_decay=1e-4)
        make = lambda p: t_train.AdamW(p, t_train.linear_schedule(0.0, 3e-3, 64), 1e-4)
    else:
        opt = j_train._optimizer(j_train.FitConfig(), 60)
        make = lambda p: t_train._optimizer(t_train.FitConfig(), 60, p)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = opt.init(params)
    mlp = mlp_from_numpy(tree, device="cpu")
    topt = make(mlp.parameters())
    names = dict(mlp.named_parameters())
    worst = 0.0
    for i, g in enumerate(grads):
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        for key, value in _leaves(g).items():
            names[key.replace("/", ".")].grad = torch.tensor(value, dtype=torch.float32)
        topt.step()
        if i == 0:
            assert _max_rel(module_tree(mlp), tree) == 0.0
        worst = max(worst, _max_rel(module_tree(mlp), _numpy(params)))
    assert worst <= 1e-6, worst


# -- MLP fit -------------------------------------------------------------------


def _pairs(n=300, seed=0):
    cols = j_columnar.records_to_columns(j_synth.make_download_records(n, seed=seed))
    p = j_features.extract_pair_features(cols)
    return p.features, p.labels


@pytest.mark.parametrize("batch,epochs", [(64, 3), (5000, 2)])
def test_train_mlp_matches_reference(batch, epochs):
    """Float32 on both sides: the sums run in another order (XLA's dots
    against torch's), a few ulps a step, which Adam's normalized steps
    carry into the parameters over 3 epochs; the limits allow ~100 ulps
    of float32 on the losses and ~1e-5 of each leaf's largest entry."""
    x, y = _pairs()
    cfg = dict(hidden_dims=(16, 16), batch_size=batch, epochs=epochs, seed=3)
    want = j_train.train_mlp(x, y, config=j_train.FitConfig(**cfg))
    init = _numpy(j_mlp.init_mlp(jax.random.PRNGKey(3), [x.shape[1], 16, 16, 1]))
    got = t_train.train_mlp(x, y, config=t_train.FitConfig(init=init, **cfg), device="cpu")
    np.testing.assert_allclose(got.history, want.history, rtol=1e-5)
    assert _max_rel(module_tree(got.params), _numpy(want.params)) <= 2e-5
    assert got.metrics.keys() == want.metrics.keys() == {"mse", "mae"}
    for k in got.metrics:
        assert got.metrics[k] == pytest.approx(want.metrics[k], rel=1e-4)


def test_train_mlp_without_init_warm_starts_and_learns():
    x, y = _pairs()
    got = t_train.train_mlp(x, y, config=t_train.FitConfig(hidden_dims=(16,), batch_size=64, epochs=4), device="cpu")
    assert got.history[-1] < got.history[0]
    assert np.isfinite(got.metrics["mse"])


def test_evaluate_mlp_matches_reference():
    x, y = _pairs(80, seed=2)
    tree = _numpy(j_mlp.init_mlp(jax.random.PRNGKey(1), [x.shape[1], 8, 1]))
    want = j_train.evaluate_mlp(tree, x, y)
    got = t_train.evaluate_mlp(mlp_from_numpy(tree, device="cpu"), x, y)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6)


@pytest.mark.parametrize("fit", ["mlp", "gnn"])
def test_fit_with_checkpoint_dir_matches_reference(fit, tmp_path):
    """Both packages' fits with a ``checkpoint_dir`` (a snapshot every
    epoch) from one init, at the limits of the parity tests above; each
    clears its snapshots on success (the port its whole directory)."""
    j_dir, t_dir = tmp_path / "jax", tmp_path / "torch"
    if fit == "mlp":
        x, y = _pairs()
        cfg = dict(hidden_dims=(16,), batch_size=64, epochs=3, seed=3)
        want = j_train.train_mlp(x, y, config=j_train.FitConfig(checkpoint_dir=str(j_dir), **cfg))
        init = _numpy(j_mlp.init_mlp(jax.random.PRNGKey(3), [x.shape[1], 16, 1]))
        got = t_train.train_mlp(x, y, config=t_train.FitConfig(init=init, checkpoint_dir=str(t_dir), **cfg),
                                device="cpu")
        rtol, limit = 1e-5, 2e-5
    else:
        tg, jg = _graph(300, 40, 8, 2)
        cfg = dict(hidden_dims=(16, 16), batch_size=64, epochs=3, seed=0)
        want = j_train.train_gnn(jg, config=j_train.GNNFitConfig(checkpoint_dir=str(j_dir), **cfg))
        init = _gnn_init(jg, j_train.GNNFitConfig(**cfg))
        got = t_train.train_gnn(tg, config=t_train.GNNFitConfig(init=init, checkpoint_dir=str(t_dir), **cfg),
                                device="cpu")
        rtol, limit = 5e-5, 2e-3
    np.testing.assert_allclose(got.history, want.history, rtol=rtol)
    assert len(got.history) == 3
    assert _max_rel(module_tree(got.params), _numpy(want.params)) <= limit
    assert not t_dir.exists()
    assert not any(p.is_file() for p in j_dir.rglob("*"))


@pytest.mark.parametrize("n", [1, 9, 100, 101])
def test_split_and_batch_steps_match(n):
    a, b = t_train._split_eval(n, 0.1, 4), j_train._split_eval(n, 0.1, 4)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert t_train._batch_steps(n, 32) == j_train._batch_steps(n, 32)


# -- probe graph and GNN -------------------------------------------------------


def _graph(n=150, hosts=30, max_degree=6, seed=0):
    recs = j_synth.make_topology_records(n, num_hosts=hosts, seed=seed)
    cols = j_columnar.records_to_columns(recs)
    return (
        t_features.build_probe_graph(cols, max_degree=max_degree, seed=seed),
        j_features.build_probe_graph(cols, max_degree=max_degree, seed=seed),
    )


@pytest.mark.parametrize("n,hosts,max_degree,seed", [(150, 30, 6, 0), (400, 12, 4, 3), (5, 64, 16, 1)])
def test_probe_graph_is_exactly_the_references(n, hosts, max_degree, seed):
    got, want = _graph(n, hosts, max_degree, seed)
    assert got.node_ids == want.node_ids and got.num_records == want.num_records == n
    for f in ("node_features", "edge_src", "edge_dst", "edge_rtt_log_ms", "neighbors", "neighbor_mask"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert t_features.build_probe_graph({}).num_nodes == 0


def test_neighbor_aggregation_matches_reference():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((12, 5)).astype(np.float32)
    nbrs = rng.integers(0, 12, (12, 4)).astype(np.int32)
    mask = (rng.random((12, 4)) < 0.6).astype(np.float32)
    got = t_segment.aggregate_neighbors(torch.tensor(feats), torch.tensor(nbrs), torch.tensor(mask))
    want = j_segment.aggregate_neighbors(jnp.asarray(feats), jnp.asarray(nbrs), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _gnn_init(graph, cfg):
    return _numpy(j_train._init_gnn(graph, cfg))


def test_gnn_forward_matches_reference():
    """bfloat16 SAGE matmul inputs on both sides, products summed in
    float32: the embeddings agree to float32 summation order."""
    tg, jg = _graph()
    cfg = j_train.GNNFitConfig(hidden_dims=(16, 16))
    tree = _gnn_init(jg, cfg)
    model = graphsage_from_numpy(tree, device="cpu")
    assert _max_rel(module_tree(model), tree) == 0.0
    src, dst = jg.edge_src[:40], jg.edge_dst[:40]
    want = j_gnn.forward_edge_rtt(
        tree, jnp.asarray(jg.node_features), jnp.asarray(jg.neighbors),
        jnp.asarray(jg.neighbor_mask), jnp.asarray(src), jnp.asarray(dst),
    )
    with torch.no_grad():
        got = t_gnn.forward_edge_rtt(
            model, torch.tensor(tg.node_features), torch.tensor(tg.neighbors),
            torch.tensor(tg.neighbor_mask), torch.tensor(src), torch.tensor(dst),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_train_gnn_matches_reference():
    """bfloat16 SAGE inputs on both sides (the reference computes in bf16
    on every backend): a float32 sum landing on the other side of a bf16
    rounding point moves one input by 2⁻⁸ relative, and 3 epochs carry
    such flips into the losses and the parameters; the limits allow a
    few of them, far below one bf16 step of the parameters."""
    tg, jg = _graph(300, 40, 8, 2)
    cfg = dict(hidden_dims=(16, 16), batch_size=64, epochs=3, seed=0)
    want = j_train.train_gnn(jg, config=j_train.GNNFitConfig(**cfg))
    init = _gnn_init(jg, j_train.GNNFitConfig(**cfg))
    got = t_train.train_gnn(tg, config=t_train.GNNFitConfig(init=init, **cfg), device="cpu")
    np.testing.assert_allclose(got.history, want.history, rtol=5e-5)
    assert _max_rel(module_tree(got.params), _numpy(want.params)) <= 2e-3
    assert got.metrics.keys() == want.metrics.keys()
    for k in got.metrics:
        assert got.metrics[k] == pytest.approx(want.metrics[k], rel=1e-3, abs=1e-6), k



# A graph on which the single-device fit drifts from the reference past the
# limits above: at 64 hosts the bf16 flips of the SAGE inputs compound over
# 3 epochs to 7.7e-4 of the losses and 7.6e-2 of the parameters (relative,
# read with this test; ROADMAP.md §C). With float32 SAGE inputs on both
# sides the same fits agree to float32 summation order, which shows the
# flips are the whole gap. The bf16 limits pin the gap so it cannot grow
# unseen.
DRIFT_GRAPH = (600, 64, 8, 2)


@pytest.mark.parametrize(
    "sage_dtype, history_rtol, param_limit", [("bfloat16", 1e-3, 0.1), ("float32", 5e-6, 2e-5)]
)
def test_train_gnn_drift_on_a_larger_graph_is_the_bf16_sage_inputs(
    monkeypatch, sage_dtype, history_rtol, param_limit
):
    tg, jg = _graph(*DRIFT_GRAPH)
    monkeypatch.setattr(t_gnn.apply_graphsage, "__defaults__", (getattr(torch, sage_dtype),))
    monkeypatch.setattr(j_gnn.apply_graphsage, "__defaults__", (getattr(jnp, sage_dtype),))
    cfg = dict(hidden_dims=(16, 16), batch_size=64, epochs=3, seed=0)
    want = j_train.train_gnn(jg, config=j_train.GNNFitConfig(**cfg))
    init = _gnn_init(jg, j_train.GNNFitConfig(**cfg))
    got = t_train.train_gnn(tg, config=t_train.GNNFitConfig(init=init, **cfg), device="cpu")
    np.testing.assert_allclose(got.history, want.history, rtol=history_rtol)
    assert _max_rel(module_tree(got.params), _numpy(want.params)) <= param_limit

def test_edge_metrics_and_evaluate_gnn_match():
    rng = np.random.default_rng(1)
    pred, y = rng.standard_normal(50), rng.standard_normal(50)
    assert t_train._edge_metrics(pred, y, 0.1) == j_train._edge_metrics(pred, y, 0.1)
    tg, jg = _graph()
    tree = _gnn_init(jg, j_train.GNNFitConfig(hidden_dims=(8,)))
    idx = np.arange(0, len(jg.edge_src), 3)
    want = j_train.evaluate_gnn(tree, jg, idx)
    got = t_train.evaluate_gnn(graphsage_from_numpy(tree, device="cpu"), tg, idx)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6)


def test_gnn_init_without_a_tree_has_the_references_shapes():
    tg, jg = _graph()
    model = t_gnn.init_graphsage(torch.Generator().manual_seed(0), 7, (16, 16), num_nodes=tg.num_nodes)
    want = j_gnn.init_graphsage(jax.random.PRNGKey(0), 7, (16, 16), num_nodes=jg.num_nodes)
    got = _leaves(module_tree(model))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in _leaves(want).items()}
    with pytest.raises(ValueError, match="no edges"):
        t_train.train_gnn(t_features.build_probe_graph({}), device="cpu")
