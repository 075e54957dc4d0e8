"""MLP parent scorer (counterpart of the reference's ``models/mlp.py``): a
regression MLP from the pair features (``schema.features.MLP_FEATURE_NAMES``)
to expected log piece cost; the scheduler's ``ml`` evaluator ranks
candidate parents by ascending predicted cost.

Weights keep the reference's ``[in, out]`` layout, and parameter names map
1:1 to the npz flat keys (``layers.0.w`` ↔ ``layers/0/w``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dragonfly2_torch.device import compute_dtype as device_compute_dtype
from dragonfly2_torch.device import matmul_f32acc


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate gelu, which is ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


class Dense(nn.Module):
    """One ``x @ w + b`` layer; ``w`` is [in, out]."""

    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out))
        self.b = nn.Parameter(torch.zeros(fan_out))


class MLP(nn.Module):
    """``dims = [in, hidden..., out]``; parameters ``layers.i.{w,b}``. A
    parameter container, like the reference's tree: ``apply_mlp`` runs
    it."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(i, o) for i, o in zip(dims[:-1], dims[1:])
        )


def init_mlp(generator: torch.Generator, dims: Sequence[int]) -> MLP:
    """He-normal weights, zero biases (the reference's ``init_mlp``
    scheme; the numbers differ, since the generators do)."""
    mlp = MLP(dims)
    with torch.no_grad():
        for layer, fan_in in zip(mlp.layers, dims[:-1]):
            layer.w.copy_(
                torch.randn(layer.w.shape, generator=generator) * (2.0 / fan_in) ** 0.5
            )
    return mlp


def apply_mlp(
    mlp: MLP,
    x: torch.Tensor,
    activation=gelu,
    compute_dtype: "torch.dtype | None" = None,
) -> torch.Tensor:
    """Forward pass; matmul inputs in ``compute_dtype`` (``None`` picks the
    device's: bfloat16 on the card, float32 on the CPU), accumulation and
    bias/activation math in float32."""
    if compute_dtype is None:
        compute_dtype = device_compute_dtype(x.device)
    h = x
    n = len(mlp.layers)
    for i, layer in enumerate(mlp.layers):
        h = matmul_f32acc(h, layer.w, compute_dtype) + layer.b.float()
        if i != n - 1:
            h = activation(h)
    return h


def score_parents(mlp: MLP, features: torch.Tensor) -> torch.Tensor:
    """[..., F] pair features → [...] predicted log piece cost (lower is a
    better parent)."""
    return apply_mlp(mlp, features)[..., 0]
