"""The port's serving plane (dragonfly2_torch.trainer.serving, .weights,
.scheduler.wave) against the JAX package's: the same npz bytes in both
directions, the same scores at float32 on the CPU, rankings equal to the
reference's ``rank_order`` contract, and the same bucket ladder."""

import jax
import numpy as np
import pytest
import torch

from dragonfly2_torch.schema import features as tfeatures
from dragonfly2_torch.scheduler import wave as twave
from dragonfly2_torch.trainer import serving as tserving
from dragonfly2_torch.weights import mlp_from_numpy, module_tree
from dragonfly2_tpu.models.mlp import init_mlp
from dragonfly2_tpu.scheduler import wave as jwave
from dragonfly2_tpu.schema import features as jfeatures
from dragonfly2_tpu.trainer import serving as jserving

torch.set_num_threads(1)

DIMS = [jfeatures.MLP_FEATURE_DIM, 32, 32, 1]


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.PRNGKey(0), DIMS))


def _feats(n, seed=0):
    return np.random.default_rng(seed).random((n, DIMS[0])).astype(np.float32)


def test_schema_constants_match():
    assert tfeatures.MLP_FEATURE_NAMES == jfeatures.MLP_FEATURE_NAMES
    assert tfeatures.MLP_FEATURE_DIM == jfeatures.MLP_FEATURE_DIM == 19
    assert tfeatures.GRU_FEATURE_DIM == jfeatures.GRU_FEATURE_DIM


@pytest.mark.parametrize("n", [1, 5, 40, 130])
def test_reference_bytes_score_like_the_reference(params, n):
    blob = jserving.serialize_params(params)
    port = tserving.MLPScorer(tserving.deserialize_params_auto(blob), device="cpu")
    ref = jserving.MLPScorer(jserving.deserialize_params_auto(blob))
    x = _feats(n, seed=n)
    got = port.predict(x)
    assert got.shape == (n,) and got.dtype == np.float32
    # the reference's CPU compute dtype is float32: summation order only
    np.testing.assert_allclose(got, ref.predict(x), atol=1e-5, rtol=1e-5)
    assert port.feature_dim == ref.feature_dim == DIMS[0]


@pytest.mark.parametrize("counts", [[3, 7, 12, 1, 9], [15] * 8, [1], [64, 1]])
def test_predict_ranked_is_rank_order_of_its_scores(params, counts):
    port = tserving.MLPScorer(params, device="cpu")
    ref = jserving.MLPScorer(params)
    x = _feats(sum(counts), seed=len(counts))
    if len(x) > 2:
        x[2] = x[1]  # a tie inside the first decision: row index breaks it
    seg = twave.segment_ids(counts)
    scores, order = port.predict_ranked(x, seg)
    assert np.array_equal(order, jwave.rank_order(scores, seg))
    assert np.array_equal(order, twave.rank_order(scores, seg))
    ref_scores, _ = ref.predict_ranked(x, seg)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(scores, port.predict(x), atol=0)


def test_port_bytes_load_in_the_reference(params):
    mlp = mlp_from_numpy(params, device="cpu")
    back = jserving.deserialize_params_auto(tserving.serialize_params(mlp))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # the tree the reference reads is what the module holds
    for a, b in zip(
        jax.tree_util.tree_leaves(module_tree(mlp)), jax.tree_util.tree_leaves(params)
    ):
        np.testing.assert_array_equal(a, b)
    # and the port reads its own bytes the same way the reference does
    own = tserving.deserialize_params_auto(tserving.serialize_params(mlp))
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(back)


def test_bucket_ladder_matches():
    assert tserving.BUCKET_LADDER == jserving.BUCKET_LADDER
    for n in range(0, 400):
        assert tserving.bucket_rows(n) == jserving.bucket_rows(n)
    a = np.arange(15, dtype=np.float32).reshape(5, 3)
    np.testing.assert_array_equal(tserving.pad_batch(a, 8), jserving.pad_batch(a, 8))
    assert tserving.pad_batch(a, 5) is a


def test_wave_helpers_match_reference():
    rng = np.random.default_rng(7)
    counts = [3, 1, 8, 5, 15]
    scores = rng.normal(size=sum(counts)).astype(np.float32)
    scores[4] = scores[5] = scores[3]
    seg = twave.segment_ids(counts)
    np.testing.assert_array_equal(seg, jwave.segment_ids(counts))
    np.testing.assert_array_equal(twave.rank_order(scores, seg), jwave.rank_order(scores, seg))
    for a, b in zip(twave.rank_segments(scores, counts), jwave.rank_segments(scores, counts)):
        np.testing.assert_array_equal(a, b)
    flat = twave.rank_order(scores, seg)
    for a, b in zip(twave.split_order(flat, counts), jwave.split_order(flat, counts)):
        np.testing.assert_array_equal(a, b)


def test_scorer_on_cuda_without_a_card_raises(params):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only machine")
    with pytest.raises(RuntimeError, match="cuda"):
        tserving.MLPScorer(params)  # device defaults to cuda


def test_evaluator_accepts_the_port_scorer(params):
    from dragonfly2_tpu.scheduler.evaluator import MLEvaluator

    ev = MLEvaluator()
    scorer = tserving.MLPScorer(params, device="cpu")
    ev.set_model(scorer)
    assert ev._model is scorer
