"""Model serving: the scheduler's ``ml`` evaluator scores candidate parents
with the trained MLP (counterpart of the reference's ``trainer/serving.py``;
the GNN and GRU scorers come with later slices).

Parameters move to the device once, at construction. Every forward pads
its batch up to a rung of ``BUCKET_LADDER`` and brings the whole rung back
before slicing on the host, as the reference does.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.models.mlp import MLP, score_parents
from dragonfly2_torch.weights import (  # noqa: F401  (the reference's serving API)
    deserialize_params_auto,
    mlp_from_numpy,
    serialize_params,
)

BUCKET_LADDER = (8, 16, 32, 64)


def bucket_rows(n: int) -> int:
    """Smallest ladder rung ≥ ``n`` (multiples of the top rung above it)."""
    for b in BUCKET_LADDER:
        if n <= b:
            return b
    top = BUCKET_LADDER[-1]
    return ((n + top - 1) // top) * top


def pad_batch(a: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad axis 0 up to ``rows`` (no copy when already there)."""
    n = a.shape[0]
    if n == rows:
        return a
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[:n] = a
    return out


def score_ranked(mlp: MLP, packed: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Forward + segment-grouped rank on the device. ``packed`` is
    [rows, F+1]: the features with the segment id as a trailing float
    column. The rank is the lexsort (segment, score, row index): a stable
    sort by score, then a stable sort of that order by segment."""
    x = packed[:, :-1]
    seg = packed[:, -1]
    s = score_parents(mlp, x)
    by_score = torch.argsort(s, stable=True)
    order = by_score[torch.argsort(seg[by_score], stable=True)]
    return s, order


class MLPScorer:
    """Parent scorer around trained MLP params — the object the scheduler's
    ``MLEvaluator`` calls ``predict`` / ``predict_ranked`` on. ``params`` is
    the reference's tree (numpy, e.g. from ``deserialize_params_auto``) or
    an ``MLP``."""

    def __init__(self, params: "Any", device="cuda"):
        self.device = resolve_device(device)
        if not isinstance(params, MLP):
            params = mlp_from_numpy(params, device=self.device)
        self._mlp = params.to(self.device).requires_grad_(False)

    @property
    def feature_dim(self) -> int:
        """Input width the model was trained for (``MLEvaluator.set_model``
        refuses a scorer whose width differs from the live schema)."""
        return int(self._mlp.layers[0].w.shape[0])

    @torch.no_grad()
    def predict(self, features: np.ndarray) -> np.ndarray:
        n = features.shape[0]
        padded = pad_batch(np.asarray(features, np.float32), bucket_rows(n))
        x = torch.from_numpy(padded).to(self.device)
        return score_parents(self._mlp, x).cpu().numpy()[:n]

    @torch.no_grad()
    def predict_ranked(
        self, features: np.ndarray, seg_ids: np.ndarray
    ) -> "tuple[np.ndarray, np.ndarray]":
        """[n, F] flattened candidate rows whose non-decreasing ``seg_ids``
        mark decision boundaries → (scores [n], segment-grouped rank
        permutation [n]). Pad rows ride a sentinel segment that sorts last
        and is sliced off; the segment ids travel as a trailing float
        column, so the wave is one upload (float32 holds ids exactly up to
        2^24)."""
        n = features.shape[0]
        rows = bucket_rows(n)
        sentinel = int(seg_ids[-1]) + 1 if n else 0
        packed = np.zeros((rows, features.shape[1] + 1), np.float32)
        packed[:n, :-1] = np.asarray(features, np.float32)
        packed[:, -1] = sentinel
        packed[:n, -1] = np.asarray(seg_ids, np.float32)
        s, order = score_ranked(self._mlp, torch.from_numpy(packed).to(self.device))
        return s.cpu().numpy()[:n], order.cpu().numpy()[:n]
