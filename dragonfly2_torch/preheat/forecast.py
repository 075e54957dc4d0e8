"""Demand forecaster: the GRU over per-task demand series (counterpart of
the reference's ``preheat/forecast.py``).

The forecast is the trainer plane's GRU (``models/gru.py``) pointed at
demand features instead of piece costs: per bucket ``(log1p(count),
position)``, the head predicting the next bucket's log demand. The
horizon forecast runs autoregressively on the device — predict, write the
prediction back into the sequence, advance the length, repeat — and one
sweep moves one feature tensor to the card and one score vector back.

Shapes follow the serving conventions: the batch dimension is padded to
a ``BUCKET_LADDER`` rung and the history axis is FIXED at the rung
covering ``window + horizon``. The forecaster runs on ``device`` (the
card unless the caller asks for the CPU) and never falls back to numpy by
itself; ``forecast_demand_np`` is the plain numpy version, for
cross-checks.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.models.gru import GRU, predict_next_cost
from dragonfly2_torch.scheduler import metrics as M
from dragonfly2_torch.trainer.serving import bucket_rows, np_predict_next_cost, pad_batch
from dragonfly2_torch.trainer.train import FitConfig, train_gru
from dragonfly2_torch.weights import gru_from_numpy, module_tree

# demand features per bucket: log1p(count), normalized bucket position
DEMAND_FEATURE_DIM = 2

DEFAULT_HORIZON = 3
DEFAULT_HIDDEN = 16
DEFAULT_MIN_EXAMPLES = 8
DEFAULT_MAX_EXAMPLES = 4096


@torch.no_grad()
def _forecast_horizon(horizon: int, model: GRU, x: torch.Tensor, n: int, t_real: int) -> torch.Tensor:
    """Autoregressive ``horizon``-step demand forecast: ``x`` is the
    rung-padded ``[rows, T, F]`` feature tensor (left as it is: the writes
    go to a copy), ``n`` the real row count, ``t_real`` the real history
    length. Returns ``[rows]`` predicted downloads summed over the
    horizon."""
    x = x.clone()
    rows, t_max, _ = x.shape
    idx = torch.arange(rows, device=x.device)
    # pad rows scan from length 0 (h0 through the masked scan) and are
    # sliced off on the host; real rows all share the window's length
    lengths = torch.where(idx < n, t_real, 0).to(torch.int64)
    total = torch.zeros((rows,), dtype=x.dtype, device=x.device)
    for _ in range(horizon):
        pred = predict_next_cost(model, x, lengths)
        total = total + torch.clamp(torch.expm1(pred), min=0.0)
        pos = ((lengths + 1) / t_max).to(x.dtype)  # true division, as the reference
        x[idx, lengths, 0] = pred.to(x.dtype)
        x[idx, lengths, 1] = pos
        lengths = torch.clamp(lengths + 1, max=t_max - 1)
    return total


def _np_forecast_horizon(horizon: int, params, x, n, t_real):
    """The plain numpy version of :func:`_forecast_horizon` — identical
    math on the identical padded shapes."""
    x = np.array(x, np.float32)  # mutated below; never alias the input
    rows, t_max, _ = x.shape
    idx = np.arange(rows)
    lengths = np.where(idx < n, t_real, 0).astype(np.int32)
    total = np.zeros((rows,), np.float32)
    for _ in range(horizon):
        pred = np_predict_next_cost(params, x, lengths)
        total = total + np.maximum(np.expm1(pred), 0.0)
        pos = ((lengths + 1) / t_max).astype(np.float32)
        x[idx, lengths, 0] = pred.astype(np.float32)
        x[idx, lengths, 1] = pos
        lengths = np.minimum(lengths + 1, t_max - 1)
    return total


def demand_features(counts: np.ndarray, hist_rows: int) -> np.ndarray:
    """``[N, T]`` bucket counts → ``[N, hist_rows, F]`` GRU features
    (log1p demand, position normalized by the FIXED padded history —
    training and serving must normalize identically)."""
    n, t = counts.shape
    out = np.zeros((n, hist_rows, DEMAND_FEATURE_DIM), np.float32)
    out[:, :t, 0] = np.log1p(counts)
    out[:, :t, 1] = (np.arange(t) + 1.0) / hist_rows
    return out


class DemandForecaster:
    """Train-and-serve wrapper: ``fit`` on a demand window snapshot,
    ``forecast_demand`` per planner sweep, both on ``device``."""

    def __init__(
        self,
        window_buckets: int,
        horizon: int = DEFAULT_HORIZON,
        hidden_dim: int = DEFAULT_HIDDEN,
        epochs: int = 8,
        min_examples: int = DEFAULT_MIN_EXAMPLES,
        max_examples: int = DEFAULT_MAX_EXAMPLES,
        device="cuda",
        seed: int = 0,
    ):
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        self.window_buckets = int(window_buckets)
        self.horizon = int(horizon)
        self.hidden_dim = int(hidden_dim)
        self.epochs = int(epochs)
        self.min_examples = int(min_examples)
        self.max_examples = int(max_examples)
        self.seed = int(seed)
        self.device = resolve_device(device)
        # the history axis rung: fixed per instance so every sweep (and
        # every autoregressive write inside one) shares one shape
        self.hist_rows = bucket_rows(self.window_buckets + self.horizon)
        self.forecasts = 0
        self.fits = 0
        self._np_params = None
        self._model: "GRU | None" = None
        self._lock = threading.Lock()

    @property
    def ready(self) -> bool:
        return self._np_params is not None

    @property
    def backend(self) -> str:
        return str(self.device)

    # -- training ----------------------------------------------------------
    def fit(self, counts: np.ndarray, init=None) -> "dict | None":
        """Train the next-bucket demand predictor on a window snapshot
        (``[N, T]`` counts). Self-supervised: every prefix of every active
        series is an example labeled with its next bucket's log demand.
        ``init`` is an initial parameter tree in the reference's layout
        (``FitConfig.init``). Returns fit metrics, or None when the window
        is too quiet to train on."""
        seqs, lengths, labels = self._examples(counts)
        if len(labels) < self.min_examples:
            return None
        cfg = FitConfig(
            hidden_dims=(self.hidden_dim,),
            batch_size=min(64, len(labels)),
            epochs=self.epochs,
            seed=self.seed,
            init=init,
        )
        result = train_gru(seqs, labels, lengths=lengths, config=cfg, device=self.device)
        self._install(result.params)
        self.fits += 1
        return result.metrics

    def _examples(self, counts: np.ndarray):
        """Prefix examples on the serving grid: features over
        ``counts[:, :L]``, label ``log1p(counts[:, L])``. Quiet rows teach
        nothing and are skipped; the count is capped longest-prefix-first
        (the examples closest to the serving shape are kept)."""
        n, t = counts.shape
        xs, ls, ys = [], [], []
        feats = demand_features(counts, self.hist_rows)
        for length in range(t - 1, 0, -1):
            for i in range(n):
                if counts[i, :length].sum() <= 0:
                    continue
                xs.append(feats[i])
                ls.append(length)
                ys.append(np.log1p(counts[i, length]))
                if len(ys) >= self.max_examples:
                    break
            if len(ys) >= self.max_examples:
                break
        if not ys:
            return (
                np.zeros((0, self.hist_rows, DEMAND_FEATURE_DIM), np.float32),
                np.zeros((0,), np.int32),
                np.zeros((0,), np.float32),
            )
        return (
            np.stack(xs).astype(np.float32),
            np.asarray(ls, np.int32),
            np.asarray(ys, np.float32),
        )

    def _install(self, params) -> None:
        """``params``: a ``GRU`` or the reference's tree. The numpy tree is
        kept for the plain version, the module on the device for sweeps;
        both swap at once under the lock."""
        if isinstance(params, GRU):
            np_params = module_tree(params)
            model = params.to(self.device)
        else:
            np_params = _tree_map_np(params)
            model = gru_from_numpy(np_params, device=self.device)
        model.requires_grad_(False)
        with self._lock:
            self._np_params = np_params
            self._model = model

    def set_params(self, params) -> None:
        """Install externally trained params (tests, cross-checks)."""
        self._install(params)

    # -- serving -----------------------------------------------------------
    def forecast_demand(self, series_batch: np.ndarray) -> np.ndarray:
        """``[N, T]`` window counts → ``[N]`` predicted downloads over the
        next ``horizon`` buckets. Zeros until the first fit (a cold
        forecaster ranks nothing hot)."""
        n = int(series_batch.shape[0])
        if n == 0:
            return np.zeros((0,), np.float32)
        with self._lock:
            model = self._model
        if model is None:
            return np.zeros((n,), np.float32)
        t_real = min(int(series_batch.shape[1]), self.window_buckets)
        rows = bucket_rows(n)
        counts = np.asarray(series_batch, np.float32)
        feats = pad_batch(demand_features(counts[:, :t_real], self.hist_rows), rows)
        # the sweep's one upload and one pull: features in, the padded
        # rung's scores out
        out = _forecast_horizon(
            self.horizon, model, torch.from_numpy(feats).to(self.device), n, t_real
        ).cpu().numpy()
        self.forecasts += n
        M.PREHEAT_FORECASTS_TOTAL.inc(n)
        return out[:n]

    def forecast_demand_np(self, series_batch: np.ndarray) -> np.ndarray:
        """The plain numpy version on demand, whatever the device — the
        parity cross-check."""
        n = int(series_batch.shape[0])
        if n == 0 or self._np_params is None:
            return np.zeros((n,), np.float32)
        t_real = min(int(series_batch.shape[1]), self.window_buckets)
        counts = np.asarray(series_batch, np.float32)
        feats = demand_features(counts[:, :t_real], self.hist_rows)
        out = _np_forecast_horizon(self.horizon, self._np_params, feats, n, t_real)
        return out[:n]

    def stats(self) -> dict:
        return {
            "backend": self.backend,
            "ready": self.ready,
            "fits": self.fits,
            "forecasts": self.forecasts,
            "horizon": self.horizon,
            "hist_rows": self.hist_rows,
        }


def _tree_map_np(params):
    if isinstance(params, dict):
        return {k: _tree_map_np(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_tree_map_np(v) for v in params]
    return np.asarray(params, np.float32)
