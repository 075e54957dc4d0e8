"""GRU over piece-download time series (counterpart of the reference's
``models/gru.py``): a per-(task, parent) sequence of piece outcomes →
predicted next-piece log cost, and the preheat forecaster's demand
recurrence.

The cell is the reference's own, not ``torch.nn.GRU``'s: the reset gate
multiplies ``h`` *before* the hidden product (``(r * h) @ uh``), and
there is no separate hidden bias. The recurrence is a Python loop over
time steps with the reference's length mask: past a sequence's length
its state stops updating, so the final hidden is the last real step's.

Everything computes in float32 (TF32 is off, ``device.py``), the head
included. Parameter names map 1:1 to the reference's tree (``wz`` …
``bh``, ``head.layers.0.w`` ↔ ``head/layers/0/w``).
"""

from __future__ import annotations

import torch
from torch import nn

from dragonfly2_torch.models.mlp import MLP, apply_mlp, init_mlp

_GATES = ("z", "r", "h")


class GRU(nn.Module):
    """``w*`` [in, hidden], ``u*`` [hidden, hidden], ``b*`` [hidden] for
    the update (z), reset (r) and candidate (h) gates, and the head
    ``MLP([hidden, head_hidden, 1])``. A parameter container, like the
    reference's tree: ``apply_gru`` / ``predict_next_cost`` run it."""

    def __init__(self, in_dim: int, hidden_dim: int, head_hidden: int = 32):
        super().__init__()
        for g in _GATES:
            setattr(self, f"w{g}", nn.Parameter(torch.zeros(in_dim, hidden_dim)))
            setattr(self, f"u{g}", nn.Parameter(torch.zeros(hidden_dim, hidden_dim)))
            setattr(self, f"b{g}", nn.Parameter(torch.zeros(hidden_dim)))
        self.head = MLP([hidden_dim, head_hidden, 1])


def init_gru(
    generator: torch.Generator, in_dim: int, hidden_dim: int, head_hidden: int = 32
) -> GRU:
    """The reference's ``init_gru`` scheme: N(0, 1/fan_in) gate weights,
    zero biases, a He-normal head (the numbers differ, since the
    generators do)."""
    model = GRU(in_dim, hidden_dim, head_hidden)
    with torch.no_grad():
        for g in _GATES:
            for name, fan_in in ((f"w{g}", in_dim), (f"u{g}", hidden_dim)):
                p = getattr(model, name)
                p.copy_(torch.randn(p.shape, generator=generator) * (1.0 / fan_in) ** 0.5)
        head = init_mlp(generator, [hidden_dim, head_hidden, 1])
        model.head.load_state_dict(head.state_dict())
    return model


def gru_cell(model: GRU, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One step: ``h`` [B, H], ``x`` [B, F] → the next state [B, H]."""
    z = torch.sigmoid(x @ model.wz + h @ model.uz + model.bz)
    r = torch.sigmoid(x @ model.wr + h @ model.ur + model.br)
    n = torch.tanh(x @ model.wh + (r * h) @ model.uh + model.bh)
    return (1.0 - z) * n + z * h


def apply_gru(
    model: GRU, x: torch.Tensor, lengths: "torch.Tensor | None" = None
) -> "tuple[torch.Tensor, torch.Tensor]":
    """x: [B, T, F] → (hidden states [B, T, H], final hidden [B, H]).

    ``lengths`` masks padded steps: the state stops updating past a
    sequence's length, so the final hidden is the last *real* step's
    state."""
    states: "list[torch.Tensor]" = []
    final = _scan(model, x, lengths, states)
    return torch.stack(states, dim=1), final


def _scan(
    model: GRU, x: torch.Tensor, lengths: "torch.Tensor | None", states: "list | None" = None
) -> torch.Tensor:
    """The masked recurrence → the final hidden [B, H] (each step's state
    appended to ``states`` when given). The input products of all steps
    run as one matmul before the loop, and the z and r hidden products as
    one per step: the same dot products as ``gru_cell``'s, summed in its
    order, ``(x·w + h·u) + b``."""
    b, t, _ = x.shape
    x = x.float()
    hidden = model.uz.shape[0]
    h = torch.zeros((b, hidden), dtype=x.dtype, device=x.device)
    xw = x @ torch.cat([model.wz, model.wr, model.wh], dim=1)  # [B, T, 3H]
    u_zr = torch.cat([model.uz, model.ur], dim=1)
    if lengths is not None:
        keep = torch.arange(t, device=x.device)[:, None] < lengths.to(x.device)[None, :]
    for step in range(t):
        xz, xr, xh = xw[:, step].split(hidden, dim=1)
        hz, hr = (h @ u_zr).split(hidden, dim=1)
        z = torch.sigmoid(xz + hz + model.bz)
        r = torch.sigmoid(xr + hr + model.br)
        n = torch.tanh(xh + (r * h) @ model.uh + model.bh)
        h_new = (1.0 - z) * n + z * h
        h = h_new if lengths is None else torch.where(keep[step][:, None], h_new, h)
        if states is not None:
            states.append(h)
    return h


def predict_next_cost(
    model: GRU, x: torch.Tensor, lengths: "torch.Tensor | None" = None
) -> torch.Tensor:
    """[B, T, F] piece history → [B] predicted next log piece cost."""
    final = _scan(model, x, lengths)
    return apply_mlp(model.head, final, compute_dtype=torch.float32)[..., 0]
