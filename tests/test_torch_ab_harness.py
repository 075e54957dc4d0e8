"""The port's A/B harness (``dragonfly2_torch.tools.ab_harness``) against
the reference's ``tools/ab_harness.py`` on the CPU.

The whole loop runs in process on the port's modules: a scheduler and its
daemons, the default evaluator's phase, the announcer's upload to the
trainer, the fit, ``CreateModel`` and activation in the manager, the
``ModelRefresher`` installing the MLP (and the GRU) on ``device="cpu"``,
and the ``ml`` phase scored through the batched scoring service.

- ``_make_origins`` writes byte-identical payloads in both packages.
- ``run_ab`` at the reference's tier-1 size rides the scoring service,
  counts the reference's pieces and reports its keys, the served model's
  kind among them; with ``serving_backend="off"`` phase 2 keeps the
  per-call rung and reports no serving keys; an idle service in phase 2
  and a failed refresh raise.
- ``run_gru_ab`` at a small size installs the GRU and counts the
  reference's pieces.
- The quality gates (the ``ml`` evaluator beats the default one; the GRU
  beats statistics) are the reference's ``slow`` tests, mirrored here as
  ``slow`` too: they time real piece pulls, so tier-1 does not run them.
  A third ``slow`` test starts the port's GRU fit from the reference's
  init tree, to tell the fit's init from the rest of the scenario.
"""

import json
import logging
import random

import pytest
import torch

from dragonfly2_torch.scheduler import model_refresher as t_refresher
from dragonfly2_torch.scheduler import serving as t_serving
from dragonfly2_torch.tools import ab_harness as tab
from dragonfly2_torch.trainer.serving import GRUScorer, MLPScorer
from dragonfly2_torch.utils import profiling as t_profiling
from dragonfly2_tpu.tools import ab_harness as jab
from dragonfly2_tpu.utils import profiling as j_profiling

torch.set_num_threads(1)

# the reference's tier-1 size (tests/test_ab_harness.py:53-60)
TIER1 = dict(n_daemons=4, n_slow=2, n_tasks=2, pieces_per_task=2)
GRU_SMALL = dict(n_daemons=4, n_train_tasks=4, n_measure_tasks=2)
# the keys phase 2 adds when it rides the scoring service
SERVING_KEYS = {"serving_backend", "serving_batches", "serving_rows_scored", "evaluator_batch_occupancy"}


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    # each package's daemons start its process-wide stack sampler and leave
    # it running, as a daemon process would; stop both once the module is
    # done so their sweeps do not tax the files run after it in this process
    yield
    t_profiling.stop()
    j_profiling.stop()


@pytest.fixture(autouse=True)
def quiet_fit_legs(caplog):
    # the GNN leg (no topology) and a short GRU leg log their refusal with
    # a traceback in both packages; that is the expected path here
    caplog.set_level(logging.CRITICAL)


@pytest.mark.parametrize("seed", [7, 11])
def test_make_origins_writes_the_reference_payloads(tmp_path, seed):
    got = tab._make_origins(str(tmp_path / "port"), "shared", 3, 1024, 4, random.Random(seed))
    want = jab._make_origins(str(tmp_path / "ref"), "shared", 3, 1024, 4, random.Random(seed))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.startswith("file://") and g.rsplit("/", 1)[1] == w.rsplit("/", 1)[1]
        with open(g[len("file://"):], "rb") as a, open(w[len("file://"):], "rb") as b:
            body = a.read()
            assert body == b.read() and len(body) == 4096


@pytest.fixture(scope="module")
def reference_ab(tmp_path_factory):
    """The reference's tier-1 A/B (its numpy scorer in the serving slot)."""
    return jab.run_ab(jab.ABConfig(serving_backend="numpy", **TIER1), workdir=str(tmp_path_factory.mktemp("ref-ab")))


def test_run_ab_rides_the_scoring_service_on_the_device(tmp_path, reference_ab):
    installed = []
    out = tab.run_ab(tab.ABConfig(device="cpu", **TIER1), workdir=str(tmp_path), installed=installed)
    assert out["serving_backend"] == "mlp"  # the kind the service served
    assert out["serving_batches"] > 0 and out["serving_rows_scored"] > 0, out
    assert out["pieces_default"] == out["pieces_ml"] == reference_ab["pieces_default"] > 0, (out, reference_ab)
    assert set(out) == set(reference_ab) and SERVING_KEYS <= set(out)
    assert [(arm, kind, type(s)) for arm, kind, s in installed] == [("ml", "mlp", MLPScorer)]
    assert installed[0][2].device.type == "cpu"
    json.dumps(out)


def test_run_ab_with_serving_off_keeps_the_per_call_rung(tmp_path, reference_ab):
    installed = []
    out = tab.run_ab(tab.ABConfig(device="cpu", serving_backend="off", **TIER1), workdir=str(tmp_path),
                     installed=installed)
    assert set(out) == set(reference_ab) - SERVING_KEYS
    assert out["pieces_default"] == out["pieces_ml"] == reference_ab["pieces_default"] > 0, (out, reference_ab)
    assert [(arm, kind, type(s)) for arm, kind, s in installed] == [("ml", "mlp", MLPScorer)]
    assert installed[0][2].device.type == "cpu"


def test_an_idle_scoring_service_in_phase_2_raises(tmp_path, monkeypatch):
    # the service never takes a decision: phase 2 would silently measure the
    # per-call rung, so the harness must fail loudly
    monkeypatch.setattr(t_serving.ScoringService, "available", lambda self: False)
    with pytest.raises(RuntimeError, match="scoring service unused"):
        tab.run_ab(tab.ABConfig(device="cpu", **TIER1), workdir=str(tmp_path))


def test_a_failed_refresh_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(t_refresher.ModelRefresher, "refresh_once", lambda self: False)
    with pytest.raises(RuntimeError, match="refresh failed"):
        tab.run_ab(tab.ABConfig(device="cpu", **TIER1), workdir=str(tmp_path))


def test_run_gru_ab_installs_the_gru_and_counts_the_reference_pieces(tmp_path):
    installed = []
    out = tab.run_gru_ab(tab.GruABConfig(device="cpu", **GRU_SMALL), workdir=str(tmp_path / "port"),
                         installed=installed)
    ref = jab.run_gru_ab(jab.GruABConfig(**GRU_SMALL), workdir=str(tmp_path / "ref"))
    assert out["pieces_ml"] == out["pieces_ml_gru"] == ref["pieces_ml"] == ref["pieces_ml_gru"] > 0, (out, ref)
    assert set(out) == set(ref)
    assert [(arm, kind, type(s)) for arm, kind, s in installed] == [
        ("ml", "mlp", MLPScorer), ("ml_gru", "mlp", MLPScorer), ("ml_gru", "gru", GRUScorer)
    ]
    assert {s.device.type for _, _, s in installed} == {"cpu"}


def test_main_passes_its_device_to_both_arms(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(tab, "run_ab", lambda cfg: seen.append(cfg) or {"ab": 1})
    monkeypatch.setattr(tab, "run_gru_ab", lambda cfg: seen.append(cfg) or {"gru": 1})
    tab.main(["--device", "cpu"])
    assert [type(c) for c in seen] == [tab.ABConfig, tab.GruABConfig]
    assert [c.device for c in seen] == ["cpu", "cpu"]
    assert seen[0].serving_backend == "torch"
    assert json.loads(capsys.readouterr().out) == {"ab": 1, "gru": {"gru": 1}}


@pytest.mark.parametrize(
    "call",
    [lambda d: tab.run_ab(tab.ABConfig(**TIER1), workdir=d),
     lambda d: tab.run_gru_ab(tab.GruABConfig(**GRU_SMALL), workdir=d)],
    ids=["run_ab", "run_gru_ab"],
)
def test_the_card_is_the_default_and_raises_without_one(tmp_path, call):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only machine")
    with pytest.raises(RuntimeError, match="cuda"):
        call(str(tmp_path))
    assert not list(tmp_path.iterdir())  # no phase ran


def test_only_torch_or_off_serves(tmp_path):
    with pytest.raises(ValueError, match="torch"):
        tab.run_ab(tab.ABConfig(device="cpu", serving_backend="numpy", **TIER1), workdir=str(tmp_path))


@pytest.mark.slow
def test_ml_evaluator_beats_default_p50(tmp_path):
    cfg = tab.ABConfig(
        n_daemons=6, n_slow=3, n_tasks=3, pieces_per_task=3, slow_delay_s=0.030, fast_delay_s=0.001, device="cpu"
    )
    # real wall-clock piece timing: allow one re-measurement, as the
    # reference's test does
    last = None
    for attempt in range(2):
        out = tab.run_ab(cfg, workdir=str(tmp_path / f"attempt-{attempt}"))
        assert out["pieces_default"] == out["pieces_ml"] > 0
        if (
            out["slow_parent_fraction_ml"] < out["slow_parent_fraction_default"]
            and out["p50_ml_ms"] < out["p50_default_ms"]
        ):
            return
        last = out
    assert last["slow_parent_fraction_ml"] < last["slow_parent_fraction_default"], last
    assert last["p50_ml_ms"] < last["p50_default_ms"], last


@pytest.mark.slow
def test_gru_bad_node_beats_statistics_on_degrading_parent(tmp_path):
    cfg = tab.GruABConfig(n_daemons=5, n_train_tasks=6, n_measure_tasks=3, device="cpu")
    last = None
    for attempt in range(2):  # the same wall-clock allowance as above
        out = tab.run_gru_ab(cfg, workdir=str(tmp_path / f"attempt-{attempt}"))
        assert out["pieces_ml"] == out["pieces_ml_gru"] > 0
        if out["gru_wins"]:
            return
        last = out
    assert last["degraded_parent_fraction_ml_gru"] < last["degraded_parent_fraction_ml"], last
    assert last["p50_ml_gru_ms"] < last["p50_ml_ms"], last


@pytest.mark.slow
def test_gru_from_the_reference_init_beats_statistics(tmp_path, monkeypatch):
    """The GRU fit of this scenario takes 10 optimizer steps (about 70
    sequences, batch 128), so where it lands is its random init's: from the
    port's init (``torch.Generator`` at the seed) it mostly predicts the
    label mean and flags nothing; from the reference's init tree
    (``PRNGKey`` at the seed) the port's fit flags the degraded parent as
    the reference's does."""
    import dataclasses

    import jax
    import numpy as np

    from dragonfly2_torch.trainer import training as t_training
    from dragonfly2_tpu.models import gru as j_gru

    fit = t_training.train_gru

    def from_the_reference_init(sequences, labels, config=None, **kw):
        init = j_gru.init_gru(jax.random.PRNGKey(config.seed), sequences.shape[-1], config.hidden_dims[0])
        config = dataclasses.replace(config, init=jax.tree_util.tree_map(np.asarray, init))
        return fit(sequences, labels, config=config, **kw)

    monkeypatch.setattr(t_training, "train_gru", from_the_reference_init)
    last = None
    for attempt in range(2):  # the same wall-clock allowance as above
        out = tab.run_gru_ab(tab.GruABConfig(device="cpu"), workdir=str(tmp_path / f"attempt-{attempt}"))
        assert out["pieces_ml"] == out["pieces_ml_gru"] > 0
        if out["gru_wins"]:
            return
        last = out
    assert last["degraded_parent_fraction_ml_gru"] < last["degraded_parent_fraction_ml"], last
