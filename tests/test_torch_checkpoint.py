"""The port's fit snapshots (dragonfly2_torch.trainer.checkpoint.
FitCheckpointer and the fit loops' resume) on the CPU: a snapshot round
trip, retention of the newest two, ``clear``, a save cut short leaving
the previous snapshot whole; an interrupted-and-resumed ``train_mlp`` /
``train_gnn`` landing on the uninterrupted run's parameters within 1e-6
(the reference's resume contract, tests/test_checkpoint.py); the SIGKILL
drill (``DF_FAULTS=trainer.fit_step=abort#2``) in a subprocess that
imports no JAX; and a port fit started from the JAX package's init,
killed and resumed, matching the JAX package's uninterrupted fit within
``test_train_mlp_matches_reference``'s limits."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dragonfly2_torch.trainer import checkpoint as t_checkpoint
from dragonfly2_torch.trainer import train as t_train
from dragonfly2_torch.weights import module_tree
from dragonfly2_tpu.models import mlp as j_mlp
from dragonfly2_tpu.schema import columnar as j_columnar
from dragonfly2_tpu.schema import features as j_features
from dragonfly2_tpu.schema import synth as j_synth
from dragonfly2_tpu.trainer import checkpoint as j_checkpoint
from dragonfly2_tpu.trainer import train as j_train

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _pairs(n=300, seed=0):
    p = j_features.extract_pair_features(j_columnar.records_to_columns(j_synth.make_download_records(n, seed=seed)))
    return p.features, p.labels


def _graph(hosts=24, seed=1):
    recs = j_synth.make_topology_records(120, num_hosts=hosts, seed=seed)
    return j_features.build_probe_graph(j_columnar.records_to_columns(recs), max_degree=8)


def _state(scale=1.0):
    return {
        "params": {"w": torch.arange(6.0).reshape(2, 3) * scale, "b": torch.zeros(3)},
        "opt_state": {"mu": [torch.ones(2, 3) * scale], "nu": [torch.full((3,), 0.5)], "count": 7},
    }


# -- the snapshot files -------------------------------------------------------


def test_round_trip(tmp_path):
    ckpt = t_checkpoint.FitCheckpointer(tmp_path / "ckpt")
    assert ckpt.latest_epoch() is None and ckpt.restore_latest() is None
    ckpt.save(0, _state(1.0))
    ckpt.save(1, _state(2.0))
    assert ckpt.latest_epoch() == 1
    epoch, state = ckpt.restore_latest("cpu")
    assert epoch == 1
    want = _state(2.0)
    assert t_checkpoint.params_equal(state, want)
    assert state["opt_state"]["count"] == 7
    for got, ref in zip(state["params"].values(), want["params"].values()):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    # a fresh checkpointer on the same directory sees the same snapshots
    assert t_checkpoint.FitCheckpointer(tmp_path / "ckpt").latest_epoch() == 1


def test_snapshots_hold_host_copies(tmp_path):
    """What is saved is a copy: training on after a save leaves the
    snapshot as it was."""
    state = _state()
    ckpt = t_checkpoint.FitCheckpointer(tmp_path)
    ckpt.save(3, state)
    state["params"]["w"].add_(1.0)
    _, back = ckpt.restore_latest()
    assert torch.equal(back["params"]["w"], _state()["params"]["w"])


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_retention_keeps_the_newest(tmp_path, keep):
    ckpt = t_checkpoint.FitCheckpointer(tmp_path / "ckpt", max_to_keep=keep)
    for epoch in range(5):
        ckpt.save(epoch, _state(epoch))
    names = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert names == sorted(f"epoch-{e}.pt" for e in range(5 - keep, 5))
    assert ckpt.restore_latest()[0] == 4


def test_default_retention_is_two(tmp_path):
    ckpt = t_checkpoint.FitCheckpointer(tmp_path / "ckpt")
    for epoch in range(4):
        ckpt.save(epoch, _state(epoch))
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["epoch-2.pt", "epoch-3.pt"]


def test_clear_removes_the_run(tmp_path):
    ckpt = t_checkpoint.FitCheckpointer(tmp_path / "ckpt")
    ckpt.save(0, _state())
    (tmp_path / "ckpt" / ".epoch-1.pt.tmp").write_bytes(b"torn")
    ckpt.clear()
    assert not (tmp_path / "ckpt").exists()
    assert t_checkpoint.FitCheckpointer(tmp_path / "ckpt").latest_epoch() is None


def test_a_save_cut_short_leaves_the_previous_snapshot(tmp_path):
    """A process killed mid-save leaves only the temporary file: the
    previous snapshot stays the newest, whole."""
    ckpt = t_checkpoint.FitCheckpointer(tmp_path)
    ckpt.save(0, _state(3.0))
    (tmp_path / ".epoch-1.pt.tmp").write_bytes(b"\x00" * 17)
    assert ckpt.latest_epoch() == 0
    assert t_checkpoint.params_equal(ckpt.restore_latest()[1], _state(3.0))


def test_params_equal_matches_reference():
    rng = np.random.default_rng(0)
    a = {"layers": [{"w": rng.standard_normal((3, 2)).astype(np.float32), "b": np.zeros(2, np.float32)}]}
    close = jax.tree_util.tree_map(lambda x: x + 5e-7, a)
    far = jax.tree_util.tree_map(lambda x: x + 1e-3, a)
    other = {"layers": [{"w": a["layers"][0]["w"]}]}
    for b, atol in ((a, 0.0), (close, 0.0), (close, 1e-6), (far, 1e-6), (other, 0.0)):
        assert t_checkpoint.params_equal(a, b, atol=atol) == j_checkpoint.params_equal(a, b, atol=atol)
    mlp = t_train.mlp_from_numpy(a, device="cpu")
    assert t_checkpoint.params_equal(mlp, mlp.state_dict())
    assert not t_checkpoint.params_equal(mlp, t_train.mlp_from_numpy(far, device="cpu"), atol=1e-6)


def test_adamw_state_round_trips():
    mlp = t_train.mlp_mod.init_mlp(torch.Generator().manual_seed(0), [4, 3, 1])
    opt = t_train._optimizer(t_train.FitConfig(), 10, mlp.parameters())
    for p in opt.params:
        p.grad = torch.ones_like(p)
    opt.step()
    saved = t_checkpoint._to_cpu(opt.state_dict())
    fresh = t_train._optimizer(t_train.FitConfig(), 10, mlp.parameters())
    fresh.load_state_dict(saved)
    assert fresh.count == 1
    assert all(torch.equal(a, b) for a, b in zip(fresh.mu + fresh.nu, opt.mu + opt.nu))


# -- resume reproduces the uninterrupted fit ----------------------------------


def _fit(kind, checkpoint_dir=None, epochs=4, init=None):
    if kind == "mlp":
        x, y = _pairs(2048 // 4, seed=0)
        cfg = t_train.FitConfig(hidden_dims=(32,), batch_size=256, seed=3, epochs=epochs,
                                checkpoint_dir=checkpoint_dir, init=init)
        return t_train.train_mlp(x, y, config=cfg, device="cpu")
    cfg = t_train.GNNFitConfig(hidden_dims=(16, 16), batch_size=64, seed=3, epochs=epochs,
                               checkpoint_dir=checkpoint_dir, init=init)
    return t_train.train_gnn(_graph(), config=cfg, device="cpu")


@pytest.mark.parametrize("kind", ["mlp", "gnn"])
def test_resume_reproduces_uninterrupted(tmp_path, monkeypatch, kind):
    full = _fit(kind)
    ckpt_dir = str(tmp_path / "ckpt")
    # crash right after epoch 1's snapshot lands
    orig = t_train._maybe_save_tree

    class Crash(RuntimeError):
        pass

    def crashing(ckpt, cfg, epoch, state):
        orig(ckpt, cfg, epoch, state)
        if epoch == 1:
            raise Crash()

    monkeypatch.setattr(t_train, "_maybe_save_tree", crashing)
    with pytest.raises(Crash):
        _fit(kind, ckpt_dir)
    monkeypatch.setattr(t_train, "_maybe_save_tree", orig)
    assert t_checkpoint.FitCheckpointer(ckpt_dir).latest_epoch() == 1

    resumed = _fit(kind, ckpt_dir)
    assert len(resumed.history) == 2  # only epochs 2 and 3 ran
    np.testing.assert_allclose(resumed.history, full.history[2:], rtol=1e-6)
    assert t_checkpoint.params_equal(full.params, resumed.params, atol=1e-6)
    assert abs(full.metrics["mse"] - resumed.metrics["mse"]) < 1e-5
    # success clears the snapshots: the next round trains fresh
    assert not Path(ckpt_dir).exists()
    assert len(_fit(kind, ckpt_dir).history) == 4


def test_checkpoint_every_skips_epochs(tmp_path, monkeypatch):
    saved = []
    monkeypatch.setattr(t_checkpoint.FitCheckpointer, "save", lambda self, epoch, state: saved.append(epoch))
    x, y = _pairs(200)
    t_train.train_mlp(x, y, config=t_train.FitConfig(hidden_dims=(8,), batch_size=64, epochs=5,
                                                     checkpoint_dir=str(tmp_path), checkpoint_every=2),
                      device="cpu")
    assert saved == [1, 3]


# -- the SIGKILL drill --------------------------------------------------------

_DRILL = r"""
import sys
for name in ("jax", "jaxlib", "dragonfly2_tpu"):
    sys.modules[name] = None  # the port runs without them
import torch
torch.set_num_threads(1)
import numpy as np
from dragonfly2_torch.trainer import train as T
data = np.load({data!r})
init = {{k[5:]: data[k] for k in data.files if k.startswith("init/")}}
tree = {{"layers": [{{"w": init[f"{{i}}/w"], "b": init[f"{{i}}/b"]}} for i in range(len(init) // 2)]}}
T.train_mlp(data["x"], data["y"], config=T.FitConfig(hidden_dims={hidden!r}, batch_size=64, epochs=4, seed=3,
            checkpoint_dir={ckpt!r}, init=tree), device="cpu")
raise SystemExit("the fit survived an armed abort rule")
"""


def _drill(tmp_path, x, y, init_tree, hidden):
    ckpt_dir = str(tmp_path / "ckpt")
    data = tmp_path / "data.npz"
    flat = {f"init/{i}/{k}": v for i, layer in enumerate(init_tree["layers"]) for k, v in layer.items()}
    np.savez(data, x=x, y=y, **flat)
    env = dict(os.environ, DF_FAULTS="trainer.fit_step=abort#2", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _DRILL.format(data=str(data), hidden=hidden, ckpt=ckpt_dir)],
        env=env, cwd=str(REPO), capture_output=True, timeout=300,
    )
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stdout[-500:], proc.stderr[-2000:])
    assert t_checkpoint.FitCheckpointer(ckpt_dir).latest_epoch() == 1
    return ckpt_dir


def test_sigkill_mid_fit_resumes_from_the_snapshot(tmp_path):
    """The crash drill: ``trainer.fit_step=abort#2`` SIGKILLs the fit
    process as epoch 2 starts (no atexit, no finally — the way an OOM kill
    dies). The fit restarted here resumes from epoch 1's snapshot and
    reaches the uninterrupted run's parameters."""
    x, y = _pairs()
    init = _numpy(j_mlp.init_mlp(jax.random.PRNGKey(3), [x.shape[1], 16, 1]))
    ckpt_dir = _drill(tmp_path, x, y, init, (16,))
    base = dict(hidden_dims=(16,), batch_size=64, epochs=4, seed=3, init=init)
    full = t_train.train_mlp(x, y, config=t_train.FitConfig(**base), device="cpu")
    resumed = t_train.train_mlp(x, y, config=t_train.FitConfig(checkpoint_dir=ckpt_dir, **base), device="cpu")
    assert len(resumed.history) == 2
    assert t_checkpoint.params_equal(full.params, resumed.params, atol=1e-6)
    assert not Path(ckpt_dir).exists()


def _max_rel(got_tree, want_tree) -> float:
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    assert got.keys() == want.keys()
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()
                     / max(np.abs(np.asarray(want[k])).max(), 1e-30)) for k in got)


def test_killed_and_resumed_from_the_jax_init_matches_the_reference(tmp_path):
    """A port fit from the JAX package's init, SIGKILLed at epoch 2 and
    resumed, against the JAX package's uninterrupted fit: the limits of
    ``test_train_mlp_matches_reference`` (losses rtol 1e-5, each leaf
    within 2e-5 of its largest entry, metrics rel 1e-4)."""
    x, y = _pairs()
    cfg = dict(hidden_dims=(16, 16), batch_size=64, epochs=4, seed=3)
    want = j_train.train_mlp(x, y, config=j_train.FitConfig(**cfg))
    init = _numpy(j_mlp.init_mlp(jax.random.PRNGKey(3), [x.shape[1], 16, 16, 1]))
    ckpt_dir = _drill(tmp_path, x, y, init, (16, 16))
    got = t_train.train_mlp(x, y, config=t_train.FitConfig(init=init, checkpoint_dir=ckpt_dir, **cfg), device="cpu")
    assert len(got.history) == 2
    np.testing.assert_allclose(got.history, want.history[2:], rtol=1e-5)
    assert _max_rel(module_tree(got.params), _numpy(want.params)) <= 2e-5
    for k in want.metrics:
        assert got.metrics[k] == pytest.approx(want.metrics[k], rel=1e-4)
