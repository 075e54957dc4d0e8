"""The port's FedAvg round (dragonfly2_torch.parallel.fedavg,
dragonfly2_torch.trainer.federation, ``Training.federated_round``)
against the JAX package's on the CPU: ``fedavg_trees`` on the same trees,
the same shard pairs from binary and CSV uploads, and the same federated
round — the same shards in both packages' trainer storage, each per-host
fit started from the JAX package's init — uploading one merged model
whose params and holdout metrics match the reference's; the merge is
example-weighted; an empty storage raises in both."""

import jax
import numpy as np
import pytest
import torch

from dragonfly2_torch.parallel import fedavg as t_fedavg
from dragonfly2_torch.parallel import make_mesh
from dragonfly2_torch.trainer import federation as t_federation
from dragonfly2_torch.trainer import train as t_train
from dragonfly2_torch.trainer import training as t_training
from dragonfly2_torch.trainer.storage import TrainerStorage as TStorage
from dragonfly2_torch.utils import idgen as t_idgen
from dragonfly2_torch.weights import module_tree
from dragonfly2_tpu.models import mlp as j_mlp
from dragonfly2_tpu.parallel import fedavg as j_fedavg
from dragonfly2_tpu.schema import columnar as j_columnar
from dragonfly2_tpu.schema import synth as j_synth
from dragonfly2_tpu.schema import wire as j_wire
from dragonfly2_tpu.schema.features import MLP_FEATURE_DIM
from dragonfly2_tpu.trainer import federation as j_federation
from dragonfly2_tpu.trainer import train as j_train
from dragonfly2_tpu.trainer import training as j_training
from dragonfly2_tpu.trainer.storage import TrainerStorage as JStorage
from dragonfly2_tpu.utils import idgen as j_idgen
from torch_mesh_child import one_rank_world

torch.set_num_threads(1)

HIDDEN = (16, 16)


def _numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"layers": [
        {"w": rng.standard_normal((5, 3)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)},
        {"w": rng.standard_normal((3, 1)).astype(np.float32), "b": np.zeros(1, np.float32)},
    ]}


def _torch_tree(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("weights", [None, [3.0, 1.0, 2.0], [1e6, 1.0, 1.0]])
def test_fedavg_trees_matches_reference(weights):
    trees = [_tree(s) for s in range(3)]
    want = _numpy(j_fedavg.fedavg_trees(trees, weights))
    got = t_fedavg.fedavg_trees([_torch_tree(t) for t in trees], weights)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_fedavg_trees_weights_by_examples_and_averages_state_dicts():
    a = {"w": torch.ones(2, 2)}
    b = {"w": torch.zeros(2, 2)}
    np.testing.assert_allclose(t_fedavg.fedavg_trees([a, b], weights=[3.0, 1.0])["w"].numpy(), 0.75)
    mlps = [t_train.mlp_from_numpy(_tree(s), device="cpu") for s in range(2)]
    merged = t_fedavg.fedavg_trees([m.state_dict() for m in mlps], [1.0, 1.0])
    assert merged.keys() == mlps[0].state_dict().keys()
    with pytest.raises(ValueError, match="no models"):
        t_fedavg.fedavg_trees([])
    with pytest.raises(ValueError, match="positive"):
        t_fedavg.fedavg_trees([a, b], weights=[0.0, 0.0])


def test_fedavg_psum_is_not_ported_yet():
    """Ported since: over a ``fed`` axis of one replica the average is the
    replica itself (worlds of 2 and 4 against ``fedavg_trees``:
    tests/test_torch_mesh.py)."""
    with one_rank_world():
        got = t_fedavg.fedavg_psum({"w": torch.arange(3.0)}, torch.full((), 7.0), mesh=make_mesh(fed=1))
    assert torch.equal(got["w"], torch.arange(3.0))


def test_federated_model_id_matches_reference():
    assert t_idgen.federated_model_id_v1() == j_idgen.federated_model_id_v1()
    assert t_idgen.federated_model_id_v1("dc-2") == j_idgen.federated_model_id_v1("dc-2")


# -- the round ---------------------------------------------------------------

SHARDS = (("10.0.0.1", "s1", 80, 1, "csv"), ("10.0.0.2", "s2", 60, 2, "binary"),
          ("10.0.0.3", "s3", 70, 3, "both"))


def _seed(tmp_path, storages):
    """The same shards into each storage: CSV, binary blocks or both (a
    scheduler that switched payload formats)."""
    for ip, hostname, n, seed, form in SHARDS:
        hid = j_idgen.host_id_v2(ip, hostname)
        recs = j_synth.make_download_records(n, seed=seed)
        csv = tmp_path / f"{hostname}.csv"
        j_columnar.write_csv(csv, recs[: n // 2] if form == "both" else recs)
        blocks = j_wire.encode_train_block(recs[n // 2 :] if form == "both" else recs)
        for storage in storages:
            if form in ("csv", "both"):
                storage.append_download(hid, csv.read_bytes())
            if form in ("binary", "both"):
                storage.append_download_blocks(hid, blocks)


@pytest.mark.parametrize("shard", [s[1] for s in SHARDS])
def test_host_pairs_match_reference(tmp_path, shard):
    t_storage, j_storage = TStorage(tmp_path / "t"), JStorage(tmp_path / "j")
    _seed(tmp_path, (t_storage, j_storage))
    ip = next(s[0] for s in SHARDS if s[1] == shard)
    hid = j_idgen.host_id_v2(ip, shard)
    got, want = t_federation._host_pairs(t_storage, hid), j_federation._host_pairs(j_storage, hid)
    for field in ("features", "labels", "download_index"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.num_downloads == want.num_downloads


class _Uploads:
    def __init__(self):
        self.models = []

    def create_model(self, **kw):
        self.models.append(kw)


def test_federated_round_matches_reference(tmp_path):
    """Each host's fit starts from the reference's init (PRNGKey(seed)),
    float32 on both sides: the merged upload within 2e-5 of each leaf's
    largest entry (``test_train_mlp_matches_reference``'s limit), the
    holdout metrics within 1e-4."""
    t_storage, j_storage = TStorage(tmp_path / "t"), JStorage(tmp_path / "j")
    _seed(tmp_path, (t_storage, j_storage))
    fit = dict(hidden_dims=HIDDEN, batch_size=64, epochs=3, seed=0)
    init = _numpy(j_mlp.init_mlp(jax.random.PRNGKey(0), [MLP_FEATURE_DIM, *HIDDEN, 1]))
    j_up, t_up = _Uploads(), _Uploads()
    want = j_training.Training(j_storage, j_up, j_training.TrainingConfig(
        mlp=j_train.FitConfig(**fit), auto_mesh=False)).federated_round()
    got = t_training.Training(t_storage, t_up, t_training.TrainingConfig(
        mlp=t_train.FitConfig(init=init, **fit)), device="cpu").federated_round()
    assert len(t_up.models) == len(j_up.models) == 1
    g, w = t_up.models[0], j_up.models[0]
    for key in ("model_id", "model_type", "ip", "hostname"):
        assert g[key] == w[key]
    assert (g["model_type"], g["hostname"], g["model_id"]) == ("mlp", "federated", t_idgen.federated_model_id_v1())
    got_tree, want_tree = module_tree(g["params"]), _numpy(w["params"])
    for a, b in zip(jax.tree_util.tree_leaves(got_tree), jax.tree_util.tree_leaves(want_tree)):
        assert np.abs(a - b).max() <= 2e-5 * max(np.abs(b).max(), 1e-30)
    assert got.keys() == want.keys() == {"mse", "mae"}
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-4)


def test_merge_is_weighted_by_training_examples(tmp_path):
    """The uploaded params are ``fedavg_trees`` of the per-host fits, each
    weighted by its training pairs: refit each shard as the round splits it
    and merge."""
    storage = TStorage(tmp_path / "t")
    _seed(tmp_path, (storage,))
    cfg = t_train.FitConfig(hidden_dims=HIDDEN, batch_size=64, epochs=2, seed=0)
    up = _Uploads()
    t_training.Training(storage, up, t_training.TrainingConfig(mlp=cfg), device="cpu").federated_round()
    fits, weights = [], []
    for hid in storage.host_ids():
        pairs = t_federation._host_pairs(storage, hid)
        n = pairs.features.shape[0]
        perm = np.random.default_rng(cfg.seed).permutation(n)
        tr = perm[max(1, int(n * 0.1)) :]
        fits.append(t_train.train_mlp(pairs.features[tr], pairs.labels[tr], config=cfg, device="cpu")
                    .params.state_dict())
        weights.append(float(len(tr)))
    assert len(set(weights)) == len(weights)  # the weights matter
    merged = t_fedavg.fedavg_trees(fits, weights)
    uploaded = up.models[0]["params"].state_dict()
    for k in merged:
        torch.testing.assert_close(uploaded[k], merged[k], rtol=0, atol=0)
    unweighted = t_fedavg.fedavg_trees(fits)
    assert any(not torch.equal(uploaded[k], unweighted[k]) for k in merged)


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_federated_round_empty_storage_raises(tmp_path, package):
    if package == "torch":
        training = t_training.Training(TStorage(tmp_path / "empty"), device="cpu")
    else:
        training = j_training.Training(JStorage(tmp_path / "empty"))
    with pytest.raises(ValueError, match="no host shards"):
        training.federated_round()


def test_federated_fit_mesh_is_not_ported_yet(tmp_path):
    """Ported since: each shard's fit over a dp mesh of one rank lands on
    the fit without a mesh exactly (the reduction over one rank divides
    by one)."""
    storage = TStorage(tmp_path / "t")
    _seed(tmp_path, (storage,))
    cfg = t_train.FitConfig(hidden_dims=HIDDEN, batch_size=64, epochs=2, seed=0)
    hosts = storage.host_ids()
    with one_rank_world():
        got = t_federation.federated_fit_mlp(storage, hosts, config=cfg, mesh=make_mesh(dp=1), device="cpu")
    want = t_federation.federated_fit_mlp(storage, hosts, config=cfg, device="cpu")
    assert got.metrics == want.metrics and got.total_examples == want.total_examples
    for a, b in zip(got.params.state_dict().values(), want.params.state_dict().values()):
        assert torch.equal(a, b)
