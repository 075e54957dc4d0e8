"""Model serving (counterpart of the reference's ``trainer/serving.py``):
the scheduler's ``ml`` evaluator scores candidate parents with the trained
MLP (``MLPScorer``), the batched scoring service ranks host pairs by the
GNN's predicted RTT (``GNNScorer``), and bad-node detection and the
preheat forecaster run the GRU (``GRUScorer``, ``np_predict_next_cost``
as its plain numpy version).

Parameters move to the device once, at construction; the GNN's node
embeddings are computed there too and stay resident. Every forward pads
its batch up to a rung of ``BUCKET_LADDER`` and brings the whole rung back
before slicing on the host, as the reference does; on the card the MLP's
ranked forward replays one captured CUDA graph per rung, as the
reference's jitted forward is one call.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.models.gnn import GraphSAGE, apply_graphsage, predict_edge
from dragonfly2_torch.models.gru import GRU, predict_next_cost
from dragonfly2_torch.models.mlp import MLP, score_parents
from dragonfly2_torch.parallel.mesh import mesh_shape
from dragonfly2_torch.schema.features import GRU_FEATURE_DIM, GRU_MAX_SEQ
from dragonfly2_torch.schema.records import MAX_PIECES_PER_PARENT
from dragonfly2_torch.weights import (  # noqa: F401  (the reference's serving API)
    deserialize_params_auto,
    graphsage_from_numpy,
    gru_from_numpy,
    mlp_from_numpy,
    serialize_params,
)

BUCKET_LADDER = (8, 16, 32, 64)
# on the card, ranked batches of up to this many rows replay a captured
# graph (the ladder's rungs and the top rung's multiples); a larger batch
# runs its operations one by one
GRAPH_MAX_ROWS = 1024


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


def _ranked_rows(mlp: MLP, packed: torch.Tensor) -> torch.Tensor:
    """``score_ranked`` as one [2, rows] float32 tensor: the scores, then
    the rank permutation (exact in float32 below 2^24 rows)."""
    s, order = score_ranked(mlp, packed)
    return torch.stack([s, order.to(torch.float32)])


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
        # on the card, rows → (graph, input rows, output rows) of a
        # captured ``score_ranked``; the lock guards the shared rows
        self._graphs: dict = {}
        self._graph_lock = threading.Lock()
        if self.device.type == "cuda":
            with torch.no_grad(), self._graph_lock:
                for rows in BUCKET_LADDER + (2 * BUCKET_LADDER[-1],):
                    self._ranked_graph(rows)

    def _ranked_graph(self, rows: int) -> tuple:
        """The captured ranked forward at ``rows`` (the ladder's rungs and
        twice its top are captured with the scorer, any other at first
        use). A replay is one call, so a batch takes the interpreter lock back
        three times (upload, replay, download) instead of after each of the
        forward's few dozen operations; in a busy server each take-back can
        wait out other threads' switch interval, and a batch that waits too
        long drops its decisions a rung."""
        got = self._graphs.get(rows)
        if got is None:
            packed = torch.zeros((rows, self.feature_dim + 1), dtype=torch.float32, device=self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                _ranked_rows(self._mlp, packed)  # warm-up: the side stream's handles
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = _ranked_rows(self._mlp, packed)
                finally:
                    graph.capture_end()
            torch.cuda.current_stream(self.device).wait_stream(side)
            got = self._graphs[rows] = (graph, packed, out)
        return got

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
        if self.device.type == "cuda" and rows <= GRAPH_MAX_ROWS:
            with self._graph_lock:
                graph, rows_in, rows_out = self._ranked_graph(rows)
                rows_in.copy_(torch.from_numpy(packed))
                graph.replay()
                out = rows_out.cpu().numpy()
            return out[0, :n], out[1, :n].astype(np.int64)
        s, order = score_ranked(self._mlp, torch.from_numpy(packed).to(self.device))
        return s.cpu().numpy()[:n], order.cpu().numpy()[:n]


def _np_gelu(x: np.ndarray) -> np.ndarray:
    """The tanh-approximate gelu, in numpy."""
    return 0.5 * x * (1.0 + np.tanh(0.7978845608028654 * (x + 0.044715 * x**3)))


def _np_sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def np_predict_next_cost(params: Any, x: np.ndarray, lengths=None) -> np.ndarray:
    """The plain numpy version of ``models.gru.predict_next_cost``: the same
    masked recurrence and gelu head on ``[B, T, F]`` histories, in float32.
    ``params`` is the reference's tree (numpy)."""
    wz, uz, bz = (np.asarray(params[k], np.float32) for k in ("wz", "uz", "bz"))
    wr, ur, br = (np.asarray(params[k], np.float32) for k in ("wr", "ur", "br"))
    wh, uh, bh = (np.asarray(params[k], np.float32) for k in ("wh", "uh", "bh"))
    x = np.asarray(x, np.float32)
    b, t, _ = x.shape
    if lengths is None:
        lengths = np.full((b,), t, np.int32)
    else:
        lengths = np.asarray(lengths, np.int32)
    h = np.zeros((b, uz.shape[0]), np.float32)
    for step in range(t):
        xt = x[:, step, :]
        z = _np_sigmoid(xt @ wz + h @ uz + bz)
        r = _np_sigmoid(xt @ wr + h @ ur + br)
        n = np.tanh(xt @ wh + (r * h) @ uh + bh)
        h_new = (1.0 - z) * n + z * h
        # the state stops updating past a sequence's length
        h = np.where((step < lengths)[:, None], h_new, h)
    layers = params["head"]["layers"]
    out = h
    last = len(layers) - 1
    for i, layer in enumerate(layers):
        out = out @ np.asarray(layer["w"], np.float32) + np.asarray(layer["b"], np.float32)
        if i != last:
            out = _np_gelu(out)
    return out[:, 0]


class GNNScorer:
    """Edge-RTT predictor over a fixed probe graph: scores (src, dst) host
    pairs by predicted log RTT (seed placement, and the batched scoring
    service's GNN rung). ``params`` is the reference's tree (numpy) or a
    ``GraphSAGE``.

    The node embeddings are computed once, at construction — swap time in
    the model refresher's lifecycle — with ``apply_graphsage`` (bfloat16
    SAGE inputs on every device, as the reference) and stay on the device
    next to the parameters; a predict moves only the (src, dst) index
    vectors. With a ``mesh`` whose ``axis`` spans more than one rank the
    embed runs graph parallel (``models.gnn_sharded``): node tables
    row-sharded over the axis, so the graph never materializes on one
    device; the [N, H] embedding rows are then gathered to every rank of
    the axis (each rank serves predicts on its own)."""

    def __init__(self, params: Any, graph, mesh=None, axis: str = "gp", device="cuda"):
        self.device = resolve_device(device)
        if not isinstance(params, GraphSAGE):
            params = graphsage_from_numpy(params, device=self.device)
        self._model = params.to(self.device).requires_grad_(False)
        self._node_index = {hid: i for i, hid in enumerate(graph.node_ids)}
        with torch.no_grad():
            if mesh is not None and mesh_shape(mesh).get(axis, 1) > 1:
                self._emb = self._sharded_embed(graph, mesh, axis)
            else:
                self._emb = apply_graphsage(
                    self._model,
                    torch.from_numpy(np.asarray(graph.node_features, np.float32)).to(self.device),
                    torch.from_numpy(np.asarray(graph.neighbors)).to(self.device),
                    torch.from_numpy(np.asarray(graph.neighbor_mask)).to(self.device),
                )

    def _sharded_embed(self, graph, mesh, axis: str) -> torch.Tensor:
        """Graph-parallel embed at swap time: node tables padded to the
        shard multiple, the ring-gather SAGE forward over this rank's rows,
        then every rank's rows gathered and the padding cut (padded nodes
        self-neighbor with zero mask — inert)."""
        from dragonfly2_torch.models.gnn_sharded import (
            make_sharded_embed,
            pad_node_arrays,
            shard_graph_arrays,
        )
        from dragonfly2_torch.ops.ring import ring_all_gather

        shards = mesh_shape(mesh)[axis]
        feats, nbrs, mask = pad_node_arrays(graph, shards)
        tables = [feats, nbrs, mask]
        embed = self._model.node_embed
        if embed is not None:
            tables.append(pad_batch(embed.cpu().numpy(), feats.shape[0]))
        local = shard_graph_arrays(mesh, axis, *tables, device=self.device)
        embed_local = local[3] if embed is not None else None
        emb = make_sharded_embed(mesh, axis)(self._model, embed_local, *local[:3])
        return ring_all_gather(emb, mesh.get_group(axis))[: graph.num_nodes]

    def has_host(self, host_id: str) -> bool:
        return host_id in self._node_index

    @torch.no_grad()
    def predict_rtt_log_ms(self, src_ids: "list[str]", dst_ids: "list[str]") -> np.ndarray:
        # bucketed like every serving forward; pads point at node 0 and
        # are scored and sliced off
        n = len(src_ids)
        rows = bucket_rows(n)
        src = np.zeros((rows,), np.int64)
        dst = np.zeros((rows,), np.int64)
        src[:n] = [self._node_index[s] for s in src_ids]
        dst[:n] = [self._node_index[d] for d in dst_ids]
        pred = predict_edge(
            self._model,
            self._emb,
            torch.from_numpy(src).to(self.device),
            torch.from_numpy(dst).to(self.device),
        )
        return pred.cpu().numpy()[:n]


class GRUScorer:
    """Next-piece-cost predictor around trained GRU params — the ``ml``
    evaluator's model-based bad-node detection (a parent whose latest
    piece cost blows far past the prediction from its own history is
    flagged). ``params`` is the reference's tree (numpy) or a ``GRU``."""

    def __init__(self, params: Any, device="cuda"):
        self.device = resolve_device(device)
        if not isinstance(params, GRU):
            params = gru_from_numpy(params, device=self.device)
        self._model = params.to(self.device).requires_grad_(False)

    @torch.no_grad()
    def predict_next_log_cost(self, cost_prefixes_ms: list) -> np.ndarray:
        """[B] predicted next log1p piece cost (ms) from per-parent piece
        cost history prefixes, featurized as the offline extractor does
        (log1p cost, normalized piece position). Long histories keep their
        newest ``GRU_MAX_SEQ`` costs at their true positions, capped at the
        trained range ``GRU_MAX_SEQ / MAX_PIECES_PER_PARENT``. Pad rows are
        zero-length sequences (the scan keeps h0), sliced off."""
        b = len(cost_prefixes_ms)
        rows = bucket_rows(b)
        seqs = np.zeros((rows, GRU_MAX_SEQ, GRU_FEATURE_DIM), np.float32)
        lengths = np.zeros((rows,), np.int64)
        pos_cap = GRU_MAX_SEQ / MAX_PIECES_PER_PARENT
        for i, prefix in enumerate(cost_prefixes_ms):
            full = np.asarray(prefix, np.float64)
            start = max(0, len(full) - GRU_MAX_SEQ)
            p = full[start:]
            L = len(p)
            seqs[i, :L, 0] = np.log1p(p)
            pos = (start + np.arange(L) + 1) / MAX_PIECES_PER_PARENT
            seqs[i, :L, 1] = np.minimum(pos, pos_cap)
            lengths[i] = L
        pred = predict_next_cost(
            self._model,
            torch.from_numpy(seqs).to(self.device),
            torch.from_numpy(lengths).to(self.device),
        )
        return pred.cpu().numpy()[:b]
