"""The port's transformer encoder (dragonfly2_torch.models.attention) against
the JAX package's ``apply_transformer`` on one JAX-initialized parameter
tree carried over with ``transformer_from_numpy``, on a ragged T = 100."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_torch.models.attention import apply_transformer as t_apply
from dragonfly2_torch.models.attention import init_transformer as t_init
from dragonfly2_torch.ops.flash import flash_attention as t_flash
from dragonfly2_torch.weights import (
    deserialize_params_auto,
    module_tree,
    serialize_params,
    transformer_from_numpy,
)
from dragonfly2_tpu.models.attention import apply_transformer, init_transformer
from dragonfly2_tpu.trainer import serving as jserving

torch.set_num_threads(1)

IN_DIM, MODEL_DIM, HEADS, LAYERS, T = 2, 32, 4, 2, 100


@pytest.fixture(scope="module")
def tree():
    params = init_transformer(jax.random.PRNGKey(0), IN_DIM, MODEL_DIM, HEADS, LAYERS)
    return jax.tree_util.tree_map(np.asarray, params)


def _x(seed=1):
    return np.random.default_rng(seed).standard_normal((2, T, IN_DIM)).astype(np.float32)


def _flash_causal(q, k, v):
    return t_flash(q, k, v, causal=True)


@pytest.mark.parametrize("attention", ["local", "flash_plain"])
@pytest.mark.parametrize(
    "dtype,atol",
    [
        ("float32", 1e-4),  # summation order only
        ("bfloat16", 2e-2),  # bf16 roundings of q/k/v/o land differently
    ],
)
def test_encoder_matches_reference(tree, attention, dtype, atol):
    x = _x()
    want = np.asarray(
        apply_transformer(
            jax.tree_util.tree_map(jnp.asarray, tree),
            jnp.asarray(x),
            compute_dtype=getattr(jnp, dtype),
        )
    )
    enc = transformer_from_numpy(tree, device="cpu")
    fn = _flash_causal if attention == "flash_plain" else None
    with torch.no_grad():
        got = t_apply(
            enc, torch.from_numpy(x), attention_fn=fn, compute_dtype=getattr(torch, dtype)
        )
    assert got.shape == (2, T, MODEL_DIM) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


def test_noncausal_encoder_matches_reference(tree):
    x = _x(seed=2)
    want = np.asarray(
        apply_transformer(
            jax.tree_util.tree_map(jnp.asarray, tree),
            jnp.asarray(x),
            causal=False,
            compute_dtype=jnp.float32,
        )
    )
    with torch.no_grad():
        got = t_apply(
            transformer_from_numpy(tree, device="cpu"), torch.from_numpy(x), causal=False,
            compute_dtype=torch.float32,
        )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_transformer_bytes_cross_both_ways(tree):
    enc = transformer_from_numpy(tree, device="cpu")
    back = jserving.deserialize_params_auto(serialize_params(enc))
    assert int(back["num_heads"]) == HEADS and int(back["head_dim"]) == MODEL_DIM // HEADS
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(
        (jax.tree_util.keystr(p), l) for p, l in jax.tree_util.tree_leaves_with_path(back)
    )
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[jax.tree_util.keystr(path)]), leaf)
    # and the reference's bytes load in the port
    again = transformer_from_numpy(
        deserialize_params_auto(jserving.serialize_params(tree)), device="cpu"
    )
    for name, p in enc.named_parameters():
        assert torch.equal(p, dict(again.named_parameters())[name])


def test_port_init_has_the_reference_tree_shape(tree):
    enc = t_init(torch.Generator().manual_seed(0), IN_DIM, MODEL_DIM, HEADS, LAYERS)
    got = module_tree(enc)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert np.shape(a) == np.shape(b)
