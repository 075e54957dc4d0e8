"""Model fit loops (counterpart of the reference's ``trainer/train.py``):
the MLP parent scorer, the GraphSAGE edge-RTT model and the GRU
next-piece-cost model, fit with ``optax.adamw``'s update rule under the
reference's schedules.

An epoch is a Python loop of optimizer steps over minibatches already on
the device (the reference scans the epoch in one XLA call); parameters
and optimizer state update in place. Matmul inputs follow the device's
policy (``device.compute_dtype``): bfloat16 on the card, float32 on the
CPU; the GNN's SAGE layers are bfloat16 everywhere, as in the reference;
the GRU computes in float32 everywhere.

JAX's random init cannot be reproduced here, so ``FitConfig.init``
takes an initial parameter tree in the reference's layout (numpy); the
output-bias warm start is applied on top of it, as on a fresh init.

With a ``mesh`` (``parallel.mesh``; one process a rank) the fits are data
parallel over its ``dp`` axis, as the reference's: parameters replicated
(broadcast from rank 0), each rank's minibatch the rank's rows of the
global one, and the gradients of the rank means averaged over the axis in
one all-reduce per step — the gradient of the global mean loss, so a dp
step is the single-device step on the whole batch up to the order of the
sums. A batch that does not divide the axis fits replicated, and so does
``train_gnn``, as in the reference. ``train_gnn_sharded`` is graph
parallel instead: node tables and edge blocks row-sharded over a ``gp``
axis (``models.gnn_sharded``).

With ``checkpoint_dir`` set, the MLP and GNN fits snapshot (module state,
``AdamW`` state, epoch) after every epoch through
``trainer.checkpoint.FitCheckpointer`` and resume from the newest
snapshot; each epoch's shuffle is seeded by (seed, epoch), so a resumed
fit replays the uninterrupted one's schedule. A successful fit deletes
its snapshots. The GRU fit takes none, as in the reference (its shuffle
runs one generator across epochs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.models import gnn as gnn_mod
from dragonfly2_torch.models import gru as gru_mod
from dragonfly2_torch.models import mlp as mlp_mod
from dragonfly2_torch.parallel.sharding import axis_group, mean_grads, replicate
from dragonfly2_torch.utils import dflog, faults
from dragonfly2_torch.weights import graphsage_from_numpy, gru_from_numpy, mlp_from_numpy

logger = dflog.get("trainer.train")

# fault point: fires once per MLP and GNN fit epoch — a ``delay`` rule
# models a stalling device link, an ``abort`` rule a crash mid-fit
FP_FIT_STEP = faults.point("trainer.fit_step")


@dataclass
class FitConfig:
    hidden_dims: tuple[int, ...] = (128, 128)
    batch_size: int = 8192
    epochs: int = 3
    learning_rate: float = 3e-3
    weight_decay: float = 1e-4
    warmup_fraction: float = 0.1
    eval_fraction: float = 0.1
    seed: int = 0
    # elastic restart: snapshot every ``checkpoint_every`` epochs into
    # this directory and resume from the newest (trainer/checkpoint.py)
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    # initial parameter tree in the reference's layout (numpy), before
    # the output-bias warm start; None draws one from ``seed``
    init: Any = None


@dataclass
class FitResult:
    params: Any  # the fitted module, on the fit's device
    metrics: dict[str, float]
    history: list[float] = field(default_factory=list)  # per-epoch mean loss


# ---------------------------------------------------------------------------
# optimizer: optax.adamw under optax's schedules
# ---------------------------------------------------------------------------


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """``optax.linear_schedule``, in float32 as optax computes it."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(max(count, 0), transition_steps))
        frac = f32(1) - c / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int
):
    """``optax.warmup_cosine_decay_schedule`` with end value 0: linear
    warm-up over ``warmup_steps``, then a cosine from ``peak_value`` to 0
    over the remaining ``decay_steps - warmup_steps`` (``decay_steps``
    includes the warm-up), in float32 as optax computes it."""
    f32 = np.float32
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    cosine_steps = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return warmup(count)
        c = min(f32(count - warmup_steps), cosine_steps)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / cosine_steps))
        return float(f32(peak_value) * cosine)

    return schedule


class AdamW:
    """``optax.adamw(schedule, weight_decay)`` over ``params``, step for
    step in optax's float32 arithmetic: b1 0.9, b2 0.999, eps 1e-8 added
    to √v̂, bias corrections ``1 - b**t`` rounded to float32 (at t = 1,
    ``1 - 0.999`` in float32 is 1.3e-5 off the exact value, which
    ``torch.optim.AdamW``'s float64 corrections would not reproduce),
    decay on every parameter (biases included) added before the lr
    scaling. optax evaluates the schedule at the update count *before*
    the update, so the first update of a warm-up from 0 leaves the
    parameters as they are (the moments still move). The state updates
    in place, with multi-tensor ops."""

    def __init__(
        self,
        params,
        schedule: Callable[[int], float],
        weight_decay: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def state_dict(self) -> dict:
        """The optimizer's state (optax's ``ScaleByAdamState``): the
        moments and the update count."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict`` into this optimizer's tensors in place."""
        for mine, saved in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            mine.copy_(saved)
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        f32 = np.float32
        lr = self.schedule(self.count)
        self.count += 1
        grads = [p.grad for p in self.params]
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - self.b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(
            self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - self.b2)
        )
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_add_(updates, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(updates, float(f32(-lr)))
        torch._foreach_add_(self.params, updates)


def _optimizer(cfg: FitConfig, total_steps: int, params) -> AdamW:
    schedule = warmup_cosine_decay_schedule(
        0.0,
        cfg.learning_rate,
        warmup_steps=max(1, int(total_steps * cfg.warmup_fraction)),
        decay_steps=max(2, total_steps),
    )
    return AdamW(params, schedule, cfg.weight_decay)


def _split_eval(n: int, eval_fraction: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_eval = int(n * eval_fraction)
    return perm[n_eval:], perm[:n_eval]


def _batch_steps(n: int, batch: int) -> tuple[int, int, int]:
    """→ (steps, rows_used, batch) with batch clamped to the training-set
    size. Shared by every fit loop so small per-host datasets and the
    empty case behave identically everywhere."""
    if n <= 0:
        raise ValueError("no training examples (empty dataset after eval split)")
    batch = min(batch, n)
    steps = max(1, n // batch)
    return steps, steps * batch, batch


def make_epoch_fn(
    loss_fn: Callable[[Any, tuple], torch.Tensor],
    optimizer: AdamW,
    sync: "Callable[[list, torch.Tensor], torch.Tensor] | None" = None,
):
    """Whole-epoch function over [steps, batch, ...] stacked minibatches:
    one optimizer step per minibatch, parameters and state updated in
    place → the epoch's mean loss (a device scalar). ``sync(params,
    loss)``, when given, reduces the gradients across ranks before the
    update and returns the global loss (``_dp_feed``)."""

    def epoch(params, batches: tuple) -> torch.Tensor:
        losses = []
        for i in range(batches[0].shape[0]):
            loss = loss_fn(params, tuple(b[i] for b in batches))
            optimizer.zero_grad()
            loss.backward()
            if sync is not None:
                loss = sync(optimizer.params, loss)
            optimizer.step()
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    return epoch


def _dp_feed(mesh, batch: int, axis: str = "dp"):
    """→ (shard, sync) for a fit's [steps, batch, ...] minibatches over
    ``mesh[axis]``: ``shard`` keeps this rank's rows of the batch dim,
    ``sync`` averages the gradients over the axis (``mean_grads``) and
    returns the global mean loss. Without a mesh, or with a batch the axis
    does not divide (``_batch_steps`` clamps small datasets' batches), the
    fit runs replicated: every rank the whole batch, no collective."""
    if mesh is None:
        return (lambda a: a), None
    group, n, rank = axis_group(mesh, axis)
    if batch % n:
        logger.info("batch %d not divisible by %s=%d; fitting replicated", batch, axis, n)
        return (lambda a: a), None
    per = batch // n

    def shard(a):
        return a[:, rank * per : (rank + 1) * per]

    def sync(params, loss):
        return mean_grads(params, group, n, extra=loss.detach())[0] / n

    return shard, sync


def _mesh_ranks(mesh) -> int:
    return 1 if mesh is None else int(np.prod(mesh.mesh.shape))


def _mesh_min(mesh, value: int) -> int:
    """The least of every mesh rank's ``value``."""
    t = torch.tensor([value], dtype=torch.int64,
                     device="cuda" if dist.get_backend() == "nccl" else "cpu")
    for name in mesh.mesh_dim_names:
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.get_group(name))
    return int(t.item())


def _open_checkpoint(cfg: FitConfig, mesh=None):
    """→ (FitCheckpointer | None, start_epoch). Epoch ``k`` snapshots are
    taken *after* epoch k runs, so resume starts at latest+1. Over a mesh
    of several ranks each rank keeps its own snapshots
    (``<checkpoint_dir>/rank-<r>``) and every rank resumes after the
    newest epoch all of them saved."""
    if not cfg.checkpoint_dir:
        return None, 0
    from dragonfly2_torch.trainer.checkpoint import FitCheckpointer

    directory = cfg.checkpoint_dir
    if _mesh_ranks(mesh) > 1:
        directory = f"{directory}/rank-{dist.get_rank()}"
    ckpt = FitCheckpointer(directory)
    latest = ckpt.latest_epoch()
    start = latest + 1 if latest is not None else 0
    if _mesh_ranks(mesh) > 1:
        start = _mesh_min(mesh, start)
    return ckpt, start


def _resume(ckpt, start_epoch: int, model: torch.nn.Module, optimizer: AdamW) -> None:
    """Load the snapshot of epoch ``start_epoch - 1``, on the fit's device,
    into ``model`` and ``optimizer`` in place (the optimizer keeps its
    parameter list)."""
    if ckpt is None or start_epoch == 0:
        return
    _, state = ckpt.restore(start_epoch - 1, _device_of(model))
    model.load_state_dict(state["params"])
    optimizer.load_state_dict(state["opt_state"])


def _fit_state(model: torch.nn.Module, optimizer: AdamW) -> dict:
    return {"params": model.state_dict(), "opt_state": optimizer.state_dict()}


def _maybe_save_tree(ckpt, cfg: FitConfig, epoch: int, state) -> None:
    if ckpt is not None and (epoch + 1) % max(cfg.checkpoint_every, 1) == 0:
        ckpt.save(epoch, state)


def _finish_checkpoint(ckpt) -> None:
    """Successful completion: drop the run's snapshots (the next round
    must train fresh, not resume into zero epochs); a rank's directory
    leaves the run's with it once the last rank's is gone."""
    if ckpt is not None:
        ckpt.clear()
        if ckpt.directory.name.startswith("rank-"):
            try:
                ckpt.directory.parent.rmdir()
            except OSError:
                pass  # another rank's snapshots are still there


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


# ---------------------------------------------------------------------------
# MLP parent scorer (upstream trainMLP stub, training.go:92-98)
# ---------------------------------------------------------------------------


def train_mlp(
    features: np.ndarray,
    labels: np.ndarray,
    config: FitConfig | None = None,
    device="cuda",
    mesh=None,
) -> FitResult:
    """Fit the pair scorer: features [N, F] → label log piece cost [N].
    Evaluation metrics are MSE/MAE on the held-out split, what the
    manager stores with an MLP upload. With ``mesh``, data parallel over
    its ``dp`` axis (every rank calls it with the same arguments)."""
    cfg = config or FitConfig()
    dev = resolve_device(device)
    n, f = features.shape
    train_idx, eval_idx = _split_eval(n, cfg.eval_fraction, cfg.seed)
    steps, used, batch = _batch_steps(len(train_idx), cfg.batch_size)

    if cfg.init is not None:
        mlp = mlp_from_numpy(cfg.init, device=dev)
    else:
        gen = torch.Generator().manual_seed(cfg.seed)
        mlp = mlp_mod.init_mlp(gen, [f, *cfg.hidden_dims, 1]).to(dev)
    # warm-start the output bias at the label mean — the regression head
    # starts unbiased instead of spending its first epochs drifting there
    with torch.no_grad():
        mlp.layers[-1].b.fill_(float(labels.mean()))
    if mesh is not None:
        replicate(mesh, mlp)

    optimizer = _optimizer(cfg, steps * cfg.epochs, mlp.parameters())

    def loss_fn(p, batch):
        x, y = batch
        pred = mlp_mod.score_parents(p, x)
        return torch.mean((pred - y) ** 2)

    shard, sync = _dp_feed(mesh, batch)
    epoch_fn = make_epoch_fn(loss_fn, optimizer, sync)
    ckpt, start_epoch = _open_checkpoint(cfg, mesh)
    _resume(ckpt, start_epoch, mlp, optimizer)
    history: list[float] = []
    for epoch in range(start_epoch, cfg.epochs):
        FP_FIT_STEP()
        # per-epoch rng: a resumed run replays the exact shuffle schedule
        rng = np.random.default_rng(cfg.seed + 1 + epoch)
        order = train_idx[rng.permutation(len(train_idx))][:used]
        xb = torch.from_numpy(shard(features[order].reshape(steps, batch, f))).to(dev)
        yb = torch.from_numpy(shard(labels[order].reshape(steps, batch))).to(dev)
        history.append(float(epoch_fn(mlp, (xb, yb))))
        _maybe_save_tree(ckpt, cfg, epoch, _fit_state(mlp, optimizer))

    metrics = evaluate_mlp(mlp, features[eval_idx], labels[eval_idx]) if len(eval_idx) else {}
    _finish_checkpoint(ckpt)
    return FitResult(params=mlp, metrics=metrics, history=history)


@torch.no_grad()
def evaluate_mlp(params, features: np.ndarray, labels: np.ndarray) -> dict[str, float]:
    x = torch.from_numpy(np.ascontiguousarray(features)).to(_device_of(params))
    pred = mlp_mod.score_parents(params, x).cpu().numpy()
    err = pred - labels
    return {"mse": float(np.mean(err**2)), "mae": float(np.mean(np.abs(err)))}


# ---------------------------------------------------------------------------
# GraphSAGE edge-RTT (upstream trainGNN stub, training.go:82-88)
# ---------------------------------------------------------------------------


@dataclass
class GNNFitConfig(FitConfig):
    hidden_dims: tuple[int, ...] = (64, 64)
    batch_size: int = 2048  # edges per step
    epochs: int = 60  # probe graphs are small; the embedding table needs steps
    learning_rate: float = 2e-2


def _init_gnn(graph, cfg: GNNFitConfig, device) -> gnn_mod.GraphSAGE:
    """GraphSAGE init with the head bias warm-started at the mean edge
    log-RTT."""
    if len(graph.edge_src) == 0:
        raise ValueError("probe graph has no edges to train on")
    if cfg.init is not None:
        model = graphsage_from_numpy(cfg.init, device=device)
    else:
        gen = torch.Generator().manual_seed(cfg.seed)
        model = gnn_mod.init_graphsage(
            gen, graph.node_features.shape[1], cfg.hidden_dims, num_nodes=graph.num_nodes
        ).to(device)
    with torch.no_grad():
        model.head.layers[-1].b.fill_(float(graph.edge_rtt_log_ms.mean()))
    return model


def _graph_tensors(graph, device) -> tuple:
    return (
        torch.from_numpy(graph.node_features).to(device),
        torch.from_numpy(graph.neighbors).to(device),
        torch.from_numpy(graph.neighbor_mask).to(device),
    )


def train_gnn(graph, config: GNNFitConfig | None = None, device="cuda", mesh=None) -> FitResult:
    """Fit GraphSAGE on a ``schema.features.ProbeGraph``: predict per-edge
    log-RTT from host embeddings. With ``mesh`` the parameters start
    replicated and every rank runs the whole fit, as the reference's
    (which feeds its edge batches unsharded).

    Evaluation reports MSE/MAE plus precision/recall/f1 on the derived
    binary task "edge is faster than the median RTT" — the tuple the
    manager stores with a GNN upload."""
    cfg = config or GNNFitConfig()
    dev = resolve_device(device)
    e = len(graph.edge_src)
    train_idx, eval_idx = _split_eval(e, cfg.eval_fraction, cfg.seed)
    model = _init_gnn(graph, cfg, dev)
    if mesh is not None:
        replicate(mesh, model)
    node_features, neighbors, neighbor_mask = _graph_tensors(graph, dev)

    steps, used, batch = _batch_steps(len(train_idx), cfg.batch_size)
    optimizer = _optimizer(cfg, steps * cfg.epochs, model.parameters())

    def loss_fn(p, b):
        src, dst, y = b
        pred = gnn_mod.forward_edge_rtt(p, node_features, neighbors, neighbor_mask, src, dst)
        return torch.mean((pred - y) ** 2)

    # the reference puts the edge batches unsharded: every rank runs the
    # whole fit (train_gnn_sharded is the graph's parallel path)
    epoch_fn = make_epoch_fn(loss_fn, optimizer)
    ckpt, start_epoch = _open_checkpoint(cfg, mesh)
    _resume(ckpt, start_epoch, model, optimizer)
    history: list[float] = []
    for epoch in range(start_epoch, cfg.epochs):
        # the reference's GNN loop has no fault point; the port's fires it
        # as the MLP's does, so the crash drill reaches the longest fit
        FP_FIT_STEP()
        rng = np.random.default_rng(cfg.seed + 1 + epoch)
        order = train_idx[rng.permutation(len(train_idx))][:used]
        sb = torch.from_numpy(graph.edge_src[order].reshape(steps, batch)).to(dev)
        db = torch.from_numpy(graph.edge_dst[order].reshape(steps, batch)).to(dev)
        yb = torch.from_numpy(graph.edge_rtt_log_ms[order].reshape(steps, batch)).to(dev)
        history.append(float(epoch_fn(model, (sb, db, yb))))
        _maybe_save_tree(ckpt, cfg, epoch, _fit_state(model, optimizer))

    metrics: dict[str, float] = {}
    if len(eval_idx):
        metrics = evaluate_gnn(model, graph, eval_idx)
    _finish_checkpoint(ckpt)
    return FitResult(params=model, metrics=metrics, history=history)


def train_gnn_sharded(
    graph,
    mesh,
    axis: str = "gp",
    config: GNNFitConfig | None = None,
    device="cuda",
) -> FitResult:
    """Graph-parallel GraphSAGE fit: node feature and embedding tables and
    edge blocks row-sharded over ``mesh[axis]``, neighbor and endpoint rows
    over the ring (``models.gnn_sharded``). Per-rank memory is O(N/ranks)
    — the path for probe graphs too large for one device. One full-batch
    step an epoch over every training edge (the eval edges weigh 0), from
    the same init as ``train_gnn``; the evaluation runs through the
    sharded forward. Every rank of the axis calls it; each returns the
    same unpadded parameters, ``GraphSAGE``'s tree."""
    from dragonfly2_torch.models import gnn_sharded as gs

    cfg = config or GNNFitConfig()
    dev = resolve_device(device)
    e = len(graph.edge_src)
    group, shards, rank = axis_group(mesh, axis)
    _, eval_idx = _split_eval(e, cfg.eval_fraction, cfg.seed)
    model = _init_gnn(graph, cfg, dev)
    replicate(mesh, model)

    nf, nbrs, mask, src_all, dst_all, y_all, w_all = gs.pad_graph(graph, shards)
    # hold out the eval edges by zeroing their loss weight: shapes stay
    # static, sharding stays even
    w_all[eval_idx] = 0.0
    arrays = gs.shard_graph_arrays(mesh, axis, nf, nbrs, mask, src_all, dst_all, y_all, w_all,
                                   device=dev)
    # the node embedding table sharded over the axis; dense weights
    # replicated (the module keeps them, its own table set aside)
    embed = None
    if model.node_embed is not None:
        table = gs.pad_rows(model.node_embed.detach().cpu().numpy(), shards)
        (local,) = gs.shard_graph_arrays(mesh, axis, table, device=dev)
        embed = torch.nn.Parameter(local)
        model.node_embed = None
    params = list(model.parameters()) + ([embed] if embed is not None else [])
    dense_params = list(model.parameters())

    loss_fn = gs.make_sharded_loss(mesh, axis)
    optimizer = _optimizer(cfg, cfg.epochs, params)

    def state():
        return {"dense": model.state_dict(), "embed": embed, "opt_state": optimizer.state_dict()}

    ckpt, start_epoch = _open_checkpoint(cfg, mesh)
    if ckpt is not None and start_epoch > 0:
        _, saved = ckpt.restore(start_epoch - 1, dev)
        model.load_state_dict(saved["dense"])
        if embed is not None:
            with torch.no_grad():
                embed.copy_(saved["embed"])
        optimizer.load_state_dict(saved["opt_state"])

    history: list[float] = []
    for epoch in range(start_epoch, cfg.epochs):
        loss = loss_fn(model, embed, *arrays)
        optimizer.zero_grad()
        loss.backward()
        # each rank's replicated weights hold their part of the gradient
        mean_grads(dense_params, group, 1)
        optimizer.step()
        history.append(float(loss.detach()))
        _maybe_save_tree(ckpt, cfg, epoch, state())
    _finish_checkpoint(ckpt)

    metrics: dict[str, float] = {}
    if len(eval_idx):
        # eval through the sharded forward too: the graph need not fit one
        # device; the ranks' edge blocks are gathered in rank order
        with torch.no_grad():
            fwd = gs.make_sharded_forward(mesh, axis)
            local_pred = fwd(model, embed, *arrays[:5])
            pred = _gather_rows(local_pred, group, shards)[:e].cpu().numpy()[eval_idx]
        metrics = _edge_metrics(
            pred, graph.edge_rtt_log_ms[eval_idx], float(np.median(graph.edge_rtt_log_ms))
        )

    if embed is not None:
        with torch.no_grad():
            table = _gather_rows(embed.detach(), group, shards)[: graph.num_nodes]
        model.node_embed = torch.nn.Parameter(table.clone())
    return FitResult(params=model, metrics=metrics, history=history)


def _gather_rows(local: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's row shard, concatenated in rank order."""
    from dragonfly2_torch.ops.ring import ring_all_gather

    return ring_all_gather(local.contiguous(), group) if n > 1 else local


def _edge_metrics(pred: np.ndarray, y: np.ndarray, thresh: float) -> dict[str, float]:
    """MSE/MAE + precision/recall/f1 on "edge faster than median RTT" —
    the evaluation tuple the manager stores with a GNN upload."""
    err = pred - y
    actual_fast = y < thresh
    pred_fast = pred < thresh
    tp = float(np.sum(pred_fast & actual_fast))
    fp = float(np.sum(pred_fast & ~actual_fast))
    fn = float(np.sum(~pred_fast & actual_fast))
    precision = tp / max(tp + fp, 1.0)
    recall = tp / max(tp + fn, 1.0)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {
        "mse": float(np.mean(err**2)),
        "mae": float(np.mean(np.abs(err))),
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


@torch.no_grad()
def evaluate_gnn(params, graph, edge_idx: np.ndarray) -> dict[str, float]:
    dev = _device_of(params)
    pred = gnn_mod.forward_edge_rtt(
        params,
        *_graph_tensors(graph, dev),
        torch.from_numpy(graph.edge_src[edge_idx]).to(dev),
        torch.from_numpy(graph.edge_dst[edge_idx]).to(dev),
    ).cpu().numpy()
    return _edge_metrics(
        pred, graph.edge_rtt_log_ms[edge_idx], float(np.median(graph.edge_rtt_log_ms))
    )


# ---------------------------------------------------------------------------
# GRU piece time-series
# ---------------------------------------------------------------------------


def train_gru(
    sequences: np.ndarray,  # [N, T, F]
    labels: np.ndarray,  # [N]
    lengths: "np.ndarray | None" = None,
    mesh=None,
    config: FitConfig | None = None,
    device="cuda",
) -> FitResult:
    """Fit the next-piece-cost predictor over piece history sequences.
    Evaluation metrics are MSE/MAE on the held-out split. With ``mesh``,
    data parallel over its ``dp`` axis. ``checkpoint_dir`` takes no
    snapshot here, as in the reference (ROADMAP §C)."""
    cfg = config or FitConfig(hidden_dims=(64,), batch_size=256, epochs=5)
    dev = resolve_device(device)
    n, t, f = sequences.shape
    train_idx, eval_idx = _split_eval(n, cfg.eval_fraction, cfg.seed)
    if lengths is None:
        lengths = np.full((n,), t, np.int32)

    if cfg.init is not None:
        model = gru_from_numpy(cfg.init, device=dev)
    else:
        gen = torch.Generator().manual_seed(cfg.seed)
        model = gru_mod.init_gru(gen, f, cfg.hidden_dims[0]).to(dev)
    # warm-start the head's output bias at the label mean
    with torch.no_grad():
        model.head.layers[-1].b.fill_(float(labels.mean()))
    if mesh is not None:
        replicate(mesh, model)

    steps, used, batch = _batch_steps(len(train_idx), cfg.batch_size)
    optimizer = _optimizer(cfg, steps * cfg.epochs, model.parameters())

    def loss_fn(p, b):
        x, y, ln = b
        pred = gru_mod.predict_next_cost(p, x, ln)
        return torch.mean((pred - y) ** 2)

    shard, sync = _dp_feed(mesh, batch)
    epoch_fn = make_epoch_fn(loss_fn, optimizer, sync)
    history: list[float] = []
    rng = np.random.default_rng(cfg.seed + 1)
    for _ in range(cfg.epochs):
        order = train_idx[rng.permutation(len(train_idx))][:used]
        xb = torch.from_numpy(shard(sequences[order].reshape(steps, batch, t, f))).to(dev)
        yb = torch.from_numpy(shard(labels[order].reshape(steps, batch))).to(dev)
        lb = torch.from_numpy(shard(lengths[order].reshape(steps, batch).astype(np.int64))).to(dev)
        history.append(float(epoch_fn(model, (xb, yb, lb))))

    metrics: dict[str, float] = {}
    if len(eval_idx):
        metrics = evaluate_gru(model, sequences[eval_idx], labels[eval_idx], lengths[eval_idx])
    return FitResult(params=model, metrics=metrics, history=history)


@torch.no_grad()
def evaluate_gru(
    params, sequences: np.ndarray, labels: np.ndarray, lengths: np.ndarray
) -> dict[str, float]:
    dev = _device_of(params)
    pred = gru_mod.predict_next_cost(
        params,
        torch.from_numpy(np.ascontiguousarray(sequences)).to(dev),
        torch.from_numpy(np.asarray(lengths, np.int64)).to(dev),
    ).cpu().numpy()
    err = pred - labels
    return {"mse": float(np.mean(err**2)), "mae": float(np.mean(np.abs(err)))}
