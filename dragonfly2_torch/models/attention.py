"""Transformer encoder for long piece sequences (counterpart of the
reference's ``models/attention.py``).

The encoder reads per-piece download histories [B, T, F] and returns the
encoded sequence [B, T, model_dim]. Attention goes through
``attention_fn(q, k, v)``: by default the plain ``ops.ring.local_attention``;
on the card the caller passes the CUDA flash kernels
(``ops.flash.flash_attention``), which never materialize the [T, T] scores,
or a sequence-parallel function of the rank's shards
(``ops.ring.make_ring_attention``, ``ops.ulysses.make_ulysses_attention``;
x is then this rank's [B, T/sp, F]). The encoder is differentiable end to
end with any of them: the flash path's gradient is its backward kernel, the
collectives' gradients are their transposes. Layer norm and the residual
stream stay float32; matmul inputs and q/k/v are in ``compute_dtype``.
"""

from __future__ import annotations

import torch
from torch import nn

from dragonfly2_torch.device import matmul_f32acc
from dragonfly2_torch.models.mlp import MLP, gelu, init_mlp
from dragonfly2_torch.ops.ring import local_attention


class LayerNormParams(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))


class EncoderLayer(nn.Module):
    """Parameters ``wq wk wv wo ln1.{g,b} ln2.{g,b} w1 b1 w2 b2``, weights
    [in, out] like the reference."""

    def __init__(self, model_dim: int, mlp_ratio: int = 4):
        super().__init__()
        hidden = mlp_ratio * model_dim
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(torch.zeros(model_dim, model_dim)))
        self.ln1 = LayerNormParams(model_dim)
        self.ln2 = LayerNormParams(model_dim)
        self.w1 = nn.Parameter(torch.zeros(model_dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w2 = nn.Parameter(torch.zeros(hidden, model_dim))
        self.b2 = nn.Parameter(torch.zeros(model_dim))


class TransformerEncoder(nn.Module):
    """Parameters ``embed``, ``layers.i.*`` and the stored ``head`` MLP
    (kept for the npz round trip; ``apply_transformer`` runs the encoder
    and does not apply it). ``num_heads``/``head_dim`` are plain ints, as
    in the reference's tree."""

    tree_ints = ("num_heads", "head_dim")

    def __init__(
        self,
        in_dim: int,
        model_dim: int,
        num_heads: int,
        num_layers: int,
        mlp_ratio: int = 4,
    ):
        super().__init__()
        if model_dim % num_heads:
            raise ValueError(f"model_dim {model_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = model_dim // num_heads
        self.embed = nn.Parameter(torch.zeros(in_dim, model_dim))
        self.layers = nn.ModuleList(
            EncoderLayer(model_dim, mlp_ratio) for _ in range(num_layers)
        )
        self.head = MLP([model_dim, model_dim, 1])


def init_transformer(
    generator: torch.Generator,
    in_dim: int,
    model_dim: int,
    num_heads: int,
    num_layers: int,
    mlp_ratio: int = 4,
) -> TransformerEncoder:
    """Normal weights scaled by sqrt(1/fan_in), unit/zero layer norms and
    zero biases (the reference's ``init_transformer`` scheme)."""
    enc = TransformerEncoder(in_dim, model_dim, num_heads, num_layers, mlp_ratio)

    def dense(p: nn.Parameter) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * (1.0 / p.shape[0]) ** 0.5)

    with torch.no_grad():
        dense(enc.embed)
        for layer in enc.layers:
            for p in (layer.wq, layer.wk, layer.wv, layer.wo, layer.w1, layer.w2):
                dense(p)
        enc.head = init_mlp(generator, [model_dim, model_dim, 1])
    return enc


def _layer_norm(x: torch.Tensor, p: LayerNormParams) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p.g + p.b


def apply_transformer(
    enc: TransformerEncoder,
    x: torch.Tensor,  # [B, T, F]
    attention_fn=None,
    causal: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """→ [B, T, model_dim] encoded sequence (float32).

    ``attention_fn(q, k, v) -> o`` on [B, T, H, D] tensors defaults to
    ``local_attention`` with ``causal``; a caller passing its own function
    applies its own mask."""
    nh, hd = enc.num_heads, enc.head_dim
    if attention_fn is None:

        def attention_fn(q, k, v):
            return local_attention(q, k, v, causal=causal)

    def proj(h, w):
        return matmul_f32acc(h, w, compute_dtype)

    h = proj(x, enc.embed)
    b, t, dm = h.shape
    for layer in enc.layers:
        u = _layer_norm(h, layer.ln1)
        q = proj(u, layer.wq).reshape(b, t, nh, hd).to(compute_dtype)
        k = proj(u, layer.wk).reshape(b, t, nh, hd).to(compute_dtype)
        v = proj(u, layer.wv).reshape(b, t, nh, hd).to(compute_dtype)
        o = attention_fn(q, k, v).reshape(b, t, dm)
        h = h + proj(o, layer.wo)
        u = _layer_norm(h, layer.ln2)
        ff = gelu(proj(u, layer.w1) + layer.b1.float())
        h = h + proj(ff, layer.w2) + layer.b2.float()
    return h
