"""Streaming ingestion: bytes on disk → decode → device feed → trained
params, in bounded host memory with decode, transfer and compute
overlapped (counterpart of the reference's ``trainer/ingest.py``).

The Train stream lands dataset files on the trainer's disk in one of two
payload formats, sniffed from the file's magic bytes:

- binary columnar blocks (``schema/wire.py``): producer threads mmap
  block-aligned spans, verify checksums and cast the precomputed pair
  tensors to the staging dtype;
- CSV (the old-peer fallback): producer threads drive the fused C++
  CSV→tensor decoder (``schema/native.py``) over newline-aligned spans
  (ctypes releases the GIL while it parses).

The packing thread (the caller) fills fixed-size superbatches in pinned
host buffers and hands them to a two-stage device leg: a TRANSFER thread
that copies each buffer to the card on a side CUDA stream and waits for
the copy, and a STEP thread that runs the optimizer steps. Superbatch
N+1's copy overlaps step N (``StreamStats.h2d_overlap_s``).

A host buffer is reused only after the step that read it has finished
on the device (the reference's rule: on the CPU the "copy" is the buffer
itself), and the packing thread refuses a buffer whose copy has not
completed.

With a ``mesh`` the fit is data parallel over its ``dp`` axis, one
process a rank: every rank runs the same producers over the same spans
and consumes their shards in one fixed order (the stream is
deterministic, so every rank packs the same superbatches), copies only
its row shard of each to its device (``parallel.sharding.
shard_superbatch``: one put per superbatch per rank) and averages the
gradients over the axis before each update. The decode is duplicated on
every rank; only the upload and the step are split.

Memory bound: the shard queue holds ≤ ``queue_depth`` decoded blocks plus
a six-buffer packing pool (one packing, up to three queued or in
transfer, up to two staged for the step) and a capped eval holdout —
independent of file size.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.models import mlp as mlp_mod
from dragonfly2_torch.parallel.sharding import axis_group, mean_grads, replicate, shard_superbatch
from dragonfly2_torch.schema import native, wire
from dragonfly2_torch.schema.features import MLP_FEATURE_DIM
from dragonfly2_torch.trainer import metrics as M
from dragonfly2_torch.trainer.train import AdamW, _mesh_min, linear_schedule
from dragonfly2_torch.utils import dflog, flight, profiling
from dragonfly2_torch.weights import mlp_from_numpy

logger = dflog.get("trainer.ingest")

# flight-recorder events: the per-superbatch h2d/step split, the
# end-of-stream milestone with the whole decode/transfer/compute
# attribution, and the stall verdicts the watchdogs reach
EV_SUPERBATCH = flight.event_type("trainer.superbatch")
EV_STREAM_DONE = flight.event_type("trainer.stream_done")
EV_STALL = flight.event_type("trainer.stall")

# phase ledger: the StreamStats wall split as live phases
PH_DECODE_WAIT = profiling.phase_type("trainer.decode_wait")
PH_BUFFER_WAIT = profiling.phase_type("trainer.buffer_wait")
PH_H2D = profiling.phase_type("trainer.h2d")
PH_STEP = profiling.phase_type("trainer.step")


@dataclass
class StreamStats:
    download_records: int = 0
    pairs: int = 0
    steps: int = 0
    eval_pairs: int = 0
    wall_s: float = 0.0
    truncated: bool = False  # stopped early by a time budget
    # wall-clock split of the packing thread (the pipeline's spine):
    # decode_wait_s — blocked on the decode queue (decoders too slow);
    # buffer_wait_s — blocked on the superbatch pool (device leg too
    # slow). The remainder is packing work itself.
    decode_wait_s: float = 0.0
    buffer_wait_s: float = 0.0
    # device-leg split, one field per stage thread: h2d_s — copy issued
    # to copy complete, on the TRANSFER stage; step_s — step dispatch +
    # the prior step's completion wait, on the STEP stage;
    # h2d_overlap_s — the part of h2d_s spent while the step stage was
    # busy, i.e. transfer wall hidden behind compute
    h2d_s: float = 0.0
    step_s: float = 0.0
    h2d_overlap_s: float = 0.0
    # producer-side split, summed across the worker pool: read_s — I/O +
    # block decode + checksum; cast_s — staging-dtype conversion;
    # enqueue_s — blocked on the bounded shard queue (consumer too slow)
    read_s: float = 0.0
    cast_s: float = 0.0
    enqueue_s: float = 0.0
    # per-dispatch training losses, most recent last (bounded to the
    # final _LOSS_KEEP dispatches)
    losses: list = field(default_factory=list)
    metrics: dict = field(default_factory=dict)  # mse/mae on the holdout

    @property
    def records_per_s(self) -> float:
        return self.download_records / self.wall_s if self.wall_s else 0.0

    @property
    def h2d_overlap_pct(self) -> float:
        """Percentage of the H2D wall hidden behind device steps."""
        return round(100.0 * self.h2d_overlap_s / self.h2d_s, 1) if self.h2d_s else 0.0


_LOSS_KEEP = 1024
# superbatch buffers in the pool, and the depths of the filled (packed,
# awaiting transfer) and staged (on the device, awaiting the step) queues
_POOL_BUFFERS = 6
_FILLED_DEPTH = 3
_STAGED_DEPTH = 2


def default_workers(ncpu: int | None = None) -> int:
    """Producer pool size off host cores: leave one core for the packing
    thread and cap the pool — beyond ~6 decoders the bounded queue, not
    decode, is the limit."""
    ncpu = ncpu or os.cpu_count() or 1
    return max(1, min(6, ncpu - 1))


def stream_shards(
    paths,
    passes: int = 1,
    max_records: int | None = None,
    queue_depth: int = 8,
    chunk_bytes: int = 8 * 1024 * 1024,
    offset: int = 0,
    end: int | None = None,
    workers: int = 1,
    half: bool = False,
    stats: "StreamStats | None" = None,
    ordered: bool = False,
):
    """Generator of ``(feats, labels, total_rows)`` shards, decoded by
    background producer thread(s) through a bounded queue. ``total_rows``
    is the cumulative download-record count across everything yielded so
    far.

    The payload format is sniffed from the first file's magic bytes:
    binary columnar blocks are cast from their precomputed pair tensors;
    CSV goes through the fused native parser (``schema/native.py``) in
    ``chunk_bytes`` feeds over newline-aligned spans.

    With ``workers > 1`` the dataset splits into aligned spans across that
    many producers (``workers=0`` → ``default_workers``); shard order is
    then interleaved as the producers finish, or, with ``ordered``, taken
    from the producers in turn — one fixed order, the same on every run.
    ``offset`` (a committed round boundary in the first file) is excluded
    on every pass, and ``end`` bounds the first file's read at the
    current round boundary. ``stats``, when given, accumulates the
    producer-side read/cast/enqueue split (the native parser fuses read,
    parse and cast, so a CSV's whole cost lands in read). Abandoning the
    generator releases the producers."""
    if isinstance(paths, (str, Path)):
        paths = [paths]
    paths = list(paths)
    if not paths:
        raise ValueError("stream_shards: no input files")
    if workers <= 0:
        workers = default_workers()
    binary = wire.is_block_file(paths[0])
    if binary:
        bounded = [
            (str(p), offset if j == 0 else 0, end if j == 0 else None)
            for j, p in enumerate(paths)
        ]
        spans = wire.split_block_spans(bounded)
    else:
        spans = []
        per_file = max(1, -(-workers // len(paths)))  # ceil
        for j, p in enumerate(paths):
            spans.extend(
                native.split_file_spans(
                    p, per_file, offset=offset if j == 0 else 0, end=end if j == 0 else None
                )
            )
    if not spans:
        return  # binary file with no complete blocks past the offset
    workers = max(1, min(workers, len(spans)))
    # one queue for all producers, or one each when the order is fixed
    queues = [queue.Queue(maxsize=queue_depth) for _ in range(workers if ordered else 1)]
    stop = threading.Event()
    errors: list[BaseException] = []
    stats_lock = threading.Lock()

    def add_stage(stage: str, dt: float) -> None:
        if stats is None:
            return
        with stats_lock:
            if stage == "read":
                stats.read_s += dt
            elif stage == "cast":
                stats.cast_s += dt
            else:
                stats.enqueue_s += dt

    def csv_iter(worker_spans):
        it = native.stream_pairs_file(
            worker_spans, passes=passes, chunk_bytes=chunk_bytes, max_records=max_records,
            half=half,
        )
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            add_stage("read", time.perf_counter() - t0)
            yield item

    def produce(worker_spans, q):
        try:
            prev_rows = 0
            if binary:
                shard_iter = wire.stream_train_pairs(
                    worker_spans,
                    passes=passes,
                    max_records=max_records,
                    half=half,
                    stage_timer=add_stage,
                )
            else:
                shard_iter = csv_iter(worker_spans)
            for feats, labels, rows in shard_iter:
                item = (feats, labels, rows - prev_rows)
                prev_rows = rows
                t0 = time.perf_counter()
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                add_stage("enqueue", time.perf_counter() - t0)
                if stop.is_set():
                    return
        except BaseException as e:  # surfaced to the consumer
            errors.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    continue

    threads = []
    for w in range(workers):
        t = threading.Thread(
            target=produce,
            args=(spans[w::workers], queues[w % len(queues)]),
            name=f"trainer.ingest-decode-{w}",
            daemon=True,
        )
        t.start()
        threads.append(t)

    # producers still running behind each queue, and the queues still live
    running = [0] * len(queues)
    for w in range(len(threads)):
        running[w % len(queues)] += 1
    live = list(range(len(queues)))
    turn = 0
    total_rows = 0
    try:
        while live:
            turn %= len(live)
            qi = live[turn]
            item = queues[qi].get()
            if errors:
                break  # one broken producer aborts the whole stream now
            if item is None:
                running[qi] -= 1
                if not running[qi]:
                    live.pop(turn)
                continue
            if ordered:
                turn += 1
            feats, labels, delta_rows = item
            if delta_rows:
                M.INGEST_RECORDS_TOTAL.inc(delta_rows)
            total_rows += delta_rows
            yield feats, labels, total_rows
            if max_records is not None and total_rows >= max_records:
                break
    finally:
        stop.set()
        # drain so producers blocked on put() can see the event and exit
        for q in queues:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for t in threads:
            t.join(timeout=5.0)
    if errors:
        raise errors[0]


def holdout_mask(feats: np.ndarray, labels: np.ndarray, eval_every: int) -> np.ndarray:
    """Content-hash holdout: the pairs whose hash lands in bucket 0 of
    ``eval_every``. The same pair lands in the same bucket on every pass
    (the hash reads the staging dtype's bit pattern), and the bytes are
    the reference's, so both packages hold out the same pairs."""
    u = np.uint16 if feats.dtype == np.float16 else np.uint32
    hv = feats.view(u).sum(axis=1, dtype=np.uint64)
    hv = (hv * np.uint64(2654435761) + labels.view(u)) & np.uint64(0xFFFFFFFF)
    return (hv % np.uint64(eval_every)) == 0


def _optimizer_and_loss(learning_rate: float, weight_decay: float, warmup_steps: int):
    """Shared by the single-step and k-step factories: exactly one
    definition of the schedule, optimizer and loss → (optimizer factory
    over a module's parameters, loss function). The schedule is linear
    warm-up → constant: the streaming horizon is unknown up front."""
    schedule = linear_schedule(0.0, learning_rate, max(warmup_steps, 1))

    def make_optimizer(mlp) -> AdamW:
        return AdamW(mlp.parameters(), schedule, weight_decay)

    def loss_fn(p, xb, yb):
        pred = mlp_mod.score_parents(p, xb)
        return torch.mean((pred - yb) ** 2)

    return make_optimizer, loss_fn


def _get_step(learning_rate: float, weight_decay: float, warmup_steps: int = 64, sync=None):
    """→ (optimizer factory, step). ``step(mlp, opt, xy)`` runs one
    optimizer step on a fused [B, F+1] (features ‖ label) superbatch in
    the staging dtype, upcast to float32 on the device, and returns the
    loss as a device scalar; parameters and optimizer state update in
    place. ``sync(params, loss)``, when given, reduces the gradients
    across ranks before the update and returns the global loss."""
    make_optimizer, loss_fn = _optimizer_and_loss(learning_rate, weight_decay, warmup_steps)

    def step(mlp, opt, xy):
        xy = xy.float()
        loss = loss_fn(mlp, xy[:, :MLP_FEATURE_DIM], xy[:, MLP_FEATURE_DIM])
        opt.zero_grad()
        loss.backward()
        if sync is not None:
            loss = sync(opt.params, loss)
        opt.step()
        return loss.detach()

    return make_optimizer, step


def _get_scan_step(
    learning_rate: float, weight_decay: float, k: int, warmup_steps: int = 64, sync=None
):
    """→ (optimizer factory, k-step call): ``scan_step(mlp, opt, xy)``
    runs ``k`` sequential optimizer steps over a [k, B, F+1] superbatch
    — the math of k calls of the single step — and returns the LAST
    loss, as the reference's ``lax.scan`` step does."""
    make_optimizer, step = _get_step(learning_rate, weight_decay, warmup_steps, sync)

    def scan_step(mlp, opt, xy):
        loss = None
        for i in range(k):
            loss = step(mlp, opt, xy[i])
        return loss

    return make_optimizer, scan_step


class _BufferPool:
    """The superbatch buffers: pinned host memory when the fit runs on
    the card. Each buffer remembers the event of its last host→device
    copy; ``take`` refuses a buffer whose copy has not completed (the
    rule: a buffer is never rewritten while its copy is in flight)."""

    def __init__(self, rows: int, dtype, device: torch.device):
        pin = device.type == "cuda"
        self.free: "queue.Queue" = queue.Queue()
        self.copies: dict[int, "torch.cuda.Event"] = {}
        self.checked = 0  # buffers taken back after a copy, each checked complete
        for _ in range(_POOL_BUFFERS):
            t = torch.empty((rows, MLP_FEATURE_DIM + 1), dtype=dtype, pin_memory=pin)
            self.free.put(t)

    def take(self) -> torch.Tensor:
        buf = self.free.get()
        ev = self.copies.pop(id(buf), None)
        if ev is not None:
            if not ev.query():
                raise RuntimeError("a superbatch buffer was recycled while its copy was in flight")
            self.checked += 1
        return buf

    def give(self, buf: torch.Tensor) -> None:
        self.free.put(buf)


def stream_train_mlp(
    paths,
    passes: int = 1,
    max_records: int | None = None,
    batch_size: int = 65_536,
    hidden_dims: tuple[int, ...] = (256, 256),
    learning_rate: float = 3e-3,
    weight_decay: float = 1e-4,
    queue_depth: int = 4,
    offset: int = 0,
    end: int | None = None,
    workers: int = 1,
    eval_every: int = 10,
    eval_max_batches: int = 16,
    params=None,
    mesh=None,
    transfer_dtype=np.float16,
    time_budget_s: float | None = None,
    steps_per_call: int = 1,
    device="cuda",
    init=None,
) -> tuple[object, StreamStats]:
    """Fit the MLP parent scorer directly off binary block files on disk
    → (the fitted ``MLP`` on ``device``, StreamStats with holdout mse/mae
    in ``.metrics``).

    ``params`` (a parameter tree or an ``MLP``) continues a model as it
    is; otherwise a fresh one starts from ``init`` (a tree in the
    reference's layout; None draws one from a generator seeded 0, as the
    reference seeds its key) with its output bias warm-started at the
    first shard's label mean.

    Holdout: with ``eval_every`` > 0, pairs whose content hash lands in a
    1/eval_every bucket (``holdout_mask``) are excluded from training on
    every pass and scored at the end (collection capped at
    ``eval_max_batches`` batches of pairs). Partial trailing batches are
    dropped when at least one full batch trained; a dataset smaller than
    one batch trains a single ragged step.

    ``transfer_dtype`` packs the host buffers (default float16: features
    are ratios and log-scales ≤ ~8, so halving the copy costs ~5e-4
    relative precision); the step upcasts on the device. Pass np.float32
    for exact feeds.

    ``time_budget_s`` bounds the wall clock: the stream stops consuming
    at the first shard boundary past the budget (``stats.truncated``).

    ``steps_per_call`` > 1 packs k minibatches into one [k, B, F+1]
    superbatch and runs k optimizer steps per dispatch.

    With ``mesh`` (every rank calls this with the same arguments; of their
    ``workers`` the ranks take the least) the rows of each minibatch shard
    over its ``dp`` axis: each rank copies only its row shard
    (``shard_superbatch``) and the gradients are averaged over the axis
    every step. A ``batch_size`` the axis does not divide feeds every rank
    the whole superbatch (no collective), as the reference does. Over several ranks a time budget stops all of them after the
    same step: the flag rides each step's all-reduce.

    Stall watchdogs (``utils.flight.StallWatchdog``) ride the pipeline
    and dump the flight rings while a stall is live (a device trace is
    ``Training``'s ``profile_dir``, which covers the whole round).
    """
    dev = resolve_device(device)
    k = max(1, int(steps_per_call))
    # the mesh feed: the dp group, whether the rows shard over it, and
    # whether the ranks must agree on stopping early
    group, dp, sharded, agree = None, 1, False, False
    if mesh is not None:
        group, dp, _ = axis_group(mesh, "dp")
        sharded = batch_size % dp == 0
        if not sharded:
            # a batch that does not divide the dp axis cannot shard evenly;
            # feed replicated rather than fail the fit
            logger.warning("batch_size %d not divisible by dp=%d; feeding unsharded", batch_size, dp)
        agree = time_budget_s is not None and dp > 1
    control = {"want_stop": 0.0, "stop": False}

    def sync(params, loss):
        extra = [loss.detach().float().reshape(1)] if sharded else []
        if agree:
            extra.append(torch.full((1,), control["want_stop"], device=loss.device))
        extra = torch.cat(extra)
        if sharded:
            got = mean_grads(params, group, dp, extra=extra)
        else:
            got = extra
            torch.distributed.all_reduce(got, group=group)
        if agree and float(got[-1]) > 0:
            control["stop"] = True  # every rank reads the same sum
        return got[0] / dp if sharded else loss

    step_sync = sync if sharded or agree else None
    make_optimizer, step = _get_step(learning_rate, weight_decay)
    fn = (
        _get_step(learning_rate, weight_decay, sync=step_sync)[1]
        if k == 1
        else _get_scan_step(learning_rate, weight_decay, k, sync=step_sync)[1]
    )
    batch_dim = 0 if k == 1 else 1

    def put(arg):
        if sharded:
            return shard_superbatch(mesh, arg, batch_dim=batch_dim, device=dev)
        return arg.to(dev, non_blocking=True)

    warm_bias = params is None
    if isinstance(params, torch.nn.Module):
        mlp = params.to(dev)
    elif params is not None:
        mlp = mlp_from_numpy(params, device=dev)
    elif init is not None:
        mlp = mlp_from_numpy(init, device=dev)
    else:
        gen = torch.Generator().manual_seed(0)
        mlp = mlp_mod.init_mlp(gen, [MLP_FEATURE_DIM, *hidden_dims, 1]).to(dev)
    if mesh is not None:
        replicate(mesh, mlp)
        # every rank must pack the same superbatches, and the spans and the
        # producers' turns follow the producer count, which defaults off
        # each host's cores: the ranks take the least of theirs
        workers = _mesh_min(mesh, workers if workers > 0 else default_workers())
    opt = None  # made at the first shard (after the bias warm start)

    stats = StreamStats()
    step_watch = flight.StallWatchdog("trainer.step", floor_s=0.25, event=EV_STALL)
    decode_watch = flight.StallWatchdog("trainer.decode_wait", floor_s=0.5, event=EV_STALL)
    rows_per_call = batch_size * k
    staging_dtype = torch.from_numpy(np.zeros(0, transfer_dtype)).dtype
    pool = _BufferPool(rows_per_call, staging_dtype, dev)
    filled_bufs: "queue.Queue" = queue.Queue(maxsize=_FILLED_DEPTH)
    staged_bufs: "queue.Queue" = queue.Queue(maxsize=_STAGED_DEPTH)
    disp_errors: list[BaseException] = []
    buf = pool.take()
    host = buf.numpy()
    fill = 0
    eval_cap_pairs = eval_max_batches * batch_size
    eval_x: list[np.ndarray] = []
    eval_y: list[np.ndarray] = []
    eval_collected = 0
    loss_ring: "collections.deque" = collections.deque(maxlen=_LOSS_KEEP)
    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if on_card else None

    # Two-stage device leg, one thread per stage, started together at
    # the first full superbatch:
    #
    #   transfer stage — consumes filled_bufs, copies each buffer to the
    #     device on the side stream and waits for the copy, hands
    #     (device tensor, host buffer, copy event, h2d wall) to
    #     staged_bufs. The overlap with the step stage is measured per
    #     copy against the step stage's busy clock.
    #   step stage — owns the model and optimizer from its start to its
    #     join; runs the step per staged superbatch and waits for the
    #     PREVIOUS step to finish on the device before recycling that
    #     step's host buffer.
    #
    # On error either stage keeps draining its input queue to the None
    # sentinel (recycling buffers) so the packing thread never deadlocks.
    stage_threads: "list[threading.Thread]" = []
    # step-stage busy clock (single writer: the step thread): "total"
    # sums completed busy intervals, "since" is nonzero while a step is
    # in flight; the transfer stage credits only the intersection of a
    # copy's wall with step-busy time as overlap
    step_busy = {"total": 0.0, "since": 0.0}

    def _step_busy_clock() -> float:
        t = step_busy["total"]
        since = step_busy["since"]
        if since:
            t += time.perf_counter() - since
        return t

    def _transfer_loop():
        saw_sentinel = False
        try:
            while True:
                b = filled_bufs.get()
                if b is None:
                    saw_sentinel = True
                    break
                if disp_errors:
                    pool.give(b)  # dead step stage: recycle, keep draining
                    continue
                arg = b if k == 1 else b.view(k, batch_size, -1)
                busy0 = _step_busy_clock()
                t_h = time.perf_counter()
                ev = None
                if on_card:
                    with torch.cuda.stream(copy_stream):
                        d = put(arg)
                        ev = torch.cuda.Event()
                        ev.record(copy_stream)
                    pool.copies[id(b)] = ev
                    ev.synchronize()
                else:
                    d = put(arg)  # the CPU step reads the host buffer itself
                dt_h = time.perf_counter() - t_h
                stats.h2d_s += dt_h
                stats.h2d_overlap_s += min(max(_step_busy_clock() - busy0, 0.0), dt_h)
                M.INGEST_H2D_SECONDS.observe(dt_h)
                PH_H2D.observe(dt_h)
                staged_bufs.put((d, b, ev, dt_h))
        except BaseException as e:
            disp_errors.append(e)
            while not saw_sentinel:
                b = filled_bufs.get()
                if b is None:
                    break
                pool.give(b)
        finally:
            staged_bufs.put(None)  # the step stage's only sentinel source

    def _step_loop():
        prev_done = prev_buf = None
        saw_sentinel = False
        try:
            while True:
                item = staged_bufs.get()
                if item is None:
                    saw_sentinel = True
                    break
                d, b, ev, dt_h = item
                if control["stop"]:
                    pool.give(b)  # the ranks agreed to stop: drain
                    continue
                t_s = time.perf_counter()
                step_busy["since"] = t_s
                try:
                    if ev is not None:
                        cur = torch.cuda.current_stream(dev)
                        cur.wait_event(ev)
                        d.record_stream(cur)
                    loss = fn(mlp, opt, d)
                    done = None
                    if on_card:
                        done = torch.cuda.Event()
                        done.record()
                    loss_ring.append(loss)
                    stats.steps += k
                    if prev_buf is not None:
                        if prev_done is not None:
                            prev_done.synchronize()
                        pool.give(prev_buf)
                    dt_s = time.perf_counter() - t_s
                finally:
                    step_busy["total"] += time.perf_counter() - step_busy["since"]
                    step_busy["since"] = 0.0
                stats.step_s += dt_s
                M.INGEST_STEP_SECONDS.observe(dt_s)
                PH_STEP.observe(dt_s)
                EV_SUPERBATCH(h2d_s=round(dt_h, 6), step_s=round(dt_s, 6), steps=k)
                step_watch.observe(dt_s)
                prev_done, prev_buf = done, b
            if prev_buf is not None:
                if prev_done is not None:
                    prev_done.synchronize()
                pool.give(prev_buf)
        except BaseException as e:
            disp_errors.append(e)
            if prev_buf is not None:
                pool.give(prev_buf)
            while not saw_sentinel:
                item = staged_bufs.get()
                if item is None:
                    break
                pool.give(item[1])

    half = transfer_dtype == np.float16
    budget_end = None if time_budget_s is None else t0 + time_budget_s
    # the shutdown handshake lives in a finally: an exception out of the
    # packing loop must still send the sentinel and join
    try:
        shard_iter = iter(
            stream_shards(
                paths,
                passes=passes,
                max_records=max_records,
                queue_depth=queue_depth,
                offset=offset,
                end=end,
                workers=workers,
                half=half,
                stats=stats,
                ordered=mesh is not None,
            )
        )
        while True:
            w0 = time.perf_counter()
            try:
                feats, labels, rows = next(shard_iter)
            except StopIteration:
                break
            dt_w = time.perf_counter() - w0
            stats.decode_wait_s += dt_w
            M.INGEST_DECODE_WAIT_SECONDS.observe(dt_w)
            PH_DECODE_WAIT.observe(dt_w)
            decode_watch.observe(dt_w)
            if budget_end is not None and time.perf_counter() > budget_end:
                if not agree:
                    stats.truncated = True
                    break  # generator abandonment releases the producers
                control["want_stop"] = 1.0  # stop with the other ranks
            if control["stop"]:
                stats.truncated = True
                break
            if disp_errors:
                break
            stats.download_records = rows
            stats.pairs += feats.shape[0]
            if warm_bias and labels.size:
                # warm-start the output bias at the first shard's label
                # mean (in the staging dtype, as the reference does)
                with torch.no_grad():
                    mlp.layers[-1].b.fill_(float(labels.mean()))
                warm_bias = False
            if opt is None:
                opt = make_optimizer(mlp)
            if eval_every > 0 and feats.shape[0]:
                emask = holdout_mask(feats, labels, eval_every)
                if emask.any():
                    if eval_collected < eval_cap_pairs:
                        ef = feats[emask]
                        eval_x.append(ef)
                        eval_y.append(labels[emask])
                        eval_collected += ef.shape[0]
                    feats = feats[~emask]
                    labels = labels[~emask]
            off = 0
            while off < feats.shape[0]:
                take = min(rows_per_call - fill, feats.shape[0] - off)
                host[fill : fill + take, :MLP_FEATURE_DIM] = feats[off : off + take]
                host[fill : fill + take, MLP_FEATURE_DIM] = labels[off : off + take]
                fill += take
                off += take
                if fill == rows_per_call:
                    if not stage_threads:
                        for target, role in ((_transfer_loop, "transfer"), (_step_loop, "step")):
                            t = threading.Thread(
                                target=target, name=f"trainer.ingest-{role}", daemon=True
                            )
                            t.start()
                            stage_threads.append(t)
                    w0 = time.perf_counter()
                    filled_bufs.put(buf)  # may block at queue depth
                    buf = pool.take()
                    host = buf.numpy()
                    dt_b = time.perf_counter() - w0
                    stats.buffer_wait_s += dt_b
                    M.INGEST_BUFFER_WAIT_SECONDS.observe(dt_b)
                    PH_BUFFER_WAIT.observe(dt_b)
                    fill = 0
                    if disp_errors:
                        break
    finally:
        if stage_threads:
            # one sentinel into the head of the pipeline; the transfer
            # stage forwards it, so joining in order drains both stages
            filled_bufs.put(None)
            for t in stage_threads:
                t.join()
    if disp_errors:
        raise disp_errors[0]
    stats.eval_pairs = eval_collected

    if stats.steps == 0 and fill > 0:
        # tiny dataset (< one batch): one ragged step so the fit is real
        if opt is None:
            opt = make_optimizer(mlp)
        loss_ring.append(step(mlp, opt, buf[:fill].to(dev)))
        stats.steps += 1
    stats.losses = [float(v) for v in loss_ring]
    stats.wall_s = time.perf_counter() - t0
    EV_STREAM_DONE(
        records=stats.download_records,
        pairs=stats.pairs,
        steps=stats.steps,
        wall_s=round(stats.wall_s, 3),
        decode_wait_s=round(stats.decode_wait_s, 3),
        buffer_wait_s=round(stats.buffer_wait_s, 3),
        h2d_s=round(stats.h2d_s, 3),
        h2d_overlap_s=round(stats.h2d_overlap_s, 3),
        step_s=round(stats.step_s, 3),
        read_s=round(stats.read_s, 3),
        cast_s=round(stats.cast_s, 3),
        enqueue_s=round(stats.enqueue_s, 3),
        truncated=stats.truncated,
        stalls=step_watch.stalls + decode_watch.stalls,
    )

    if eval_x:
        xe = np.concatenate(eval_x)
        ye = np.concatenate(eval_y)
        with torch.no_grad():
            x = torch.from_numpy(xe).to(dev).float()
            pred = mlp_mod.score_parents(mlp, x).cpu().numpy()
        err = pred - ye
        stats.metrics = {
            "mse": float(np.mean(err**2)),
            "mae": float(np.mean(np.abs(err))),
        }
    return mlp, stats
