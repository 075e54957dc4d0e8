#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dragonfly2_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. device and build: the card's name and power limit, then the four
   CUDA sources (both flash forwards and both flash backwards) built with
   ``nvcc`` at once (each timed), with
   ``ptxas``'s registers, spills and added wgmma fences per
   instantiation and, where
   ``cuobjdump`` sits beside ``nvcc``, the count of HGMMA (wgmma)
   instructions in the SASS of each tensor-core library (0 fails);
2. the tf32x3 kernel's pre-pass against its plain split, bit for bit (and
   timed alone at the encoder's shape); each flash kernel against the
   plain PyTorch version at every checked shape, with max|err| of O and
   LSE and the share of each limit used; at the
   encoder's shape (float32 → tf32x3, bfloat16 → sm90) and at D = 8 in
   bfloat16 (tf32x3's other role) the kernel, SDPA and the plain version
   are timed in turns beside the card's bound for the same work, and the
   CUDA kernels SDPA runs are named from a profiler trace; then each
   backward kernel against ``flash_backward_reference`` on the same (O,
   LSE, dO) at every checked shape it takes (``flash_bwd_sm90``: bfloat16
   at D in 16, 32, 64, 128, ragged T, packed views; ``flash_bwd``: float32
   at every head dim and bfloat16 at D = 8), with max|err| of dQ, dK and
   dV and the share of each limit used, and at the encoder's shape in
   bfloat16 ``flash_bwd_sm90``, ``flash_bwd`` and SDPA's backward timed in
   turns, in float32 ``flash_bwd`` and SDPA's backward, each beside the
   plain version;
3. serve leg at cluster scale: 10,000 hosts × 16 probes through the
   topology engine, one flush on the card, then waves of 256 decisions ×
   15 candidates joined (rtt affinity) and ranked by a [19, 128, 128, 1]
   MLP loaded from npz bytes — rankings against ``rank_order``, scores and
   affinities against the same port on the CPU;
4. scheduler leg at cluster scale: the same 10,000 hosts × 16 probes in
   the topology engine, a swarm of 40 tasks × 256 peers (a quarter
   succeeded, the rest running with one parent each) in the scheduler's
   resource model, and a [19, 128, 128, 1] MLP installed by the
   ``ModelRefresher`` from an in-process manager; then waves of 256
   running children through ``Scheduling.find_candidate_parents_wave`` →
   ``MLEvaluator.evaluate_wave`` → ``ScoringService`` → ``MLPScorer`` on
   the card. Every checked wave must stay on the ``serving`` rung with no
   demotion, rank each decision by ``rank_order`` of its card scores, and
   match the same waves run on the CPU (candidate sets equal, scores
   within 2e-2);
5. trainer leg: one upload round of the scheduler's record sink (1
   file × 100 MiB of binary train blocks in ``main``, 11 at the leg's
   default, ~1.8 M download records; and the serve leg's probe graph as
   ~40,000 topology records) fed through
   ``TrainerService.Train`` in 128 MiB chunks; ``Training`` as the trainer
   server builds it from its defaults fits the MLP on the streamed path
   (pinned buffers, a side-stream copy stage, 2 passes), the GNN (60
   epochs) and the GRU (its newest 10,000 sequences in ``main``,
   ``GRU_MAX_SEQUENCES`` at the leg's default) at once on the card and
   uploads all three through
   ``CreateModel`` to a manager stand-in; each holdout mse must beat the
   mean predictor's; the refresher then installs the three models — the
   GNN in the serving slot (embedded at swap time over the engine's
   export), the GRU behind bad-node detection — and scheduler waves run
   on them (rung ``serving``, ``model_kind() == "gnn"``, no demotion
   after the warm-up wave, scores as on the CPU); a reduced streamed fit
   and a reduced GRU fit are held against the CPU's (``FIT_TOL``,
   ``GRU_FIT_TOL``), and ~20 superbatches are traced for the device's
   idle share;
6. preheat leg: a ``DemandWindow`` at its defaults (1,024 tasks × 32
   buckets of 10 s) with 8 rising series among flat ones; one
   ``PreheatPlanner`` sweep fits the GRU demand forecaster inline on the
   card, forecasts every series, plans the rising ones and sends one
   ``CreateJob`` to the manager stand-in carrying their task ids and
   ``recommend_seeds_by_rtt`` over the 10,000-host engine; the forecast
   on the card is held against its numpy version (``FORECAST_TOL``), and
   ``recommend_seeds`` ranks 64 candidate hosts with the trained GNN, as
   on the CPU;
7. server leg: the port's ``SchedulerServer`` (``algorithm="ml"``) and
   ``TrainerServer`` live over gRPC in this process on the card, with a
   manager stand-in served by the port's ``glue.serve``, and the
   daemons' side in 4 processes of its own (started with ``spawn``):
   10,000 hosts announce and sync 16 seeded probes each (160,000 edges)
   through ``SyncProbes``; 40 tasks × 256 peers run their ``AnnouncePeer``
   streams at 64 at once (a back-to-source seed per task, then children
   scheduled on earlier peers through ``Scheduling`` → ``MLEvaluator`` →
   ``ScoringService`` on a seeded MLP the refresher installed); the
   announcer uploads the records and the probe snapshot to the trainer,
   whose fits land three ``CreateModel``; the refresher installs them and
   256 more children are scored by the trained GNN with the GRU behind
   bad-node detection. Every decision must be a legal parent set or a
   legitimate back-to-source, none may drop below the serving rung after
   the warm-up, each order is ``rank_order`` of its card scores, and every
   served call is rescored on the CPU (MLP within 2e-2, GNN within 5e-2);
8. encoder leg at full width: the piece-sequence transformer (model_dim
   256, 4 heads, 4 layers) on B = 2, T = 8192 with flash attention, against
   the plain ``local_attention``: once in bfloat16, which must launch
   ``flash_fwd_sm90`` once per layer and ``flash_fwd_tf32x3`` never, and
   once in float32, which must launch ``flash_fwd_tf32x3`` once per layer
   and ``flash_fwd_sm90`` never;
9. encoder-gradient leg at the same width: ``apply_transformer`` with
   ``make_ulysses_attention(..., use_kernel=True)`` over an sp = 1 NCCL
   process group, a seeded loss and ``backward()``, in bfloat16 and in
   float32: each step must launch the forward kernel and the backward
   kernel of its route (``flash_bwd_sm90`` in bfloat16, ``flash_bwd`` in
   float32) once per layer and nothing else, every gradient must be finite and
   within ``ENCODER_GRAD_TOL`` (``ENCODER_GRAD_QK_TOL`` for wq and wk) of
   the same step with ``local_attention`` under autograd; the step's wall
   and its peak memory are printed beside ``local_attention``'s.

The line before the last holds the kernels' table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. Weights and data are random, made from seeds.
"""

from __future__ import annotations

import json
import random
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dragonfly2_torch import _build
from dragonfly2_torch.models.attention import apply_transformer, init_transformer
from dragonfly2_torch.models.gru import init_gru
from dragonfly2_torch.models.mlp import init_mlp
from dragonfly2_torch.ops import flash
from dragonfly2_torch.ops.ulysses import make_ulysses_attention
from dragonfly2_torch.parallel import make_mesh
from dragonfly2_torch.preheat import planner as preheat_planner
from dragonfly2_torch.preheat.demand import DemandWindow
from dragonfly2_torch.preheat.forecast import DemandForecaster
from dragonfly2_torch.schema import records as R
from dragonfly2_torch.schema import synth, wire
from dragonfly2_torch.schema.columnar import records_to_columns
from dragonfly2_torch.schema.features import GRU_FEATURE_DIM, MLP_FEATURE_DIM, build_probe_graph
from dragonfly2_torch.scheduler import metrics as scheduler_metrics
from dragonfly2_torch.scheduler import resource as res
from dragonfly2_torch.scheduler import wave
from dragonfly2_torch.scheduler.evaluator import MLEvaluator
from dragonfly2_torch.scheduler.networktopology import NetworkTopology
from dragonfly2_torch.scheduler.model_refresher import (
    ManagerUploader,
    ModelRefresher,
    PlainRequests,
)
from dragonfly2_torch.scheduler.scheduling import Scheduling
from dragonfly2_torch.scheduler.seed_placement import recommend_seeds, recommend_seeds_by_rtt
from dragonfly2_torch.scheduler.serving import ScoringService
from dragonfly2_torch.topology import TopologyConfig, TopologyEngine
from dragonfly2_torch.trainer import metrics as M_T
from dragonfly2_torch.trainer.ingest import holdout_mask, stream_train_mlp
from dragonfly2_torch.trainer.serving import (
    GNNScorer,
    GRUScorer,
    MLPScorer,
    deserialize_params_auto,
    serialize_params,
)
from dragonfly2_torch.trainer.service import PlainMessages, TrainerService
from dragonfly2_torch.trainer.storage import TrainerStorage
from dragonfly2_torch.trainer.train import FitConfig, GNNFitConfig, _batch_steps, _split_eval, train_gru
from dragonfly2_torch.trainer.training import Training, TrainingConfig
from dragonfly2_torch.utils import flight
from dragonfly2_torch.utils.idgen import gnn_model_id_v1, gru_model_id_v1, mlp_model_id_v1, task_id_v1
from dragonfly2_torch.utils.kvstore import KVStore
from dragonfly2_torch.weights import module_tree

# NVIDIA H100 SXM data sheet, dense rates. A float32-accurate product is
# fastest as 3xTF32 on the tensor cores: three TF32 products at 495 TFLOP/s
# (the CUDA cores' float32 rate is 67 TFLOP/s).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
PEAK_BYTES_PER_S = 3.35e12
# exponentials: 16 per clock per SM on the special-function units, 3.9 T/s
# (FlashAttention-3, Shah et al. 2024; CUDA programming guide throughputs)
PEAK_EXP_PER_S = 3.9e12

# O is held per element as |o - ref| <= atol + rtol·|ref|: float32 leaves
# room for another summation order only, bfloat16 for the two f32 sums
# landing on either side of a rounding point (2^-7·|ref| is one bf16 step)
# and one step more. flash_fwd_sm90 rounds the softmax weights P to bf16
# before P·V; that moves O by at most 2^-8·(P·|V|)/l, which its limit adds
# (``flash.p_rounding_term``). LSE is float32 on both sides.
FLASH_O_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2**-6)}
P_ROUNDING = 2**-8
FLASH_LSE_TOL = 1e-4
# (B, T, H, D, causal, dtype, packed q/k/v) for flash_fwd_tf32x3: the
# reference's on-chip set in float32 and the bf16 D = 8 case, long heads
# of 16 and 128, one row and a packed projection; the encoder's float32
# shape and bf16 D = 8 at T = 8192 are checked and timed after these
TF32X3_SHAPES = [
    (2, 512, 4, 64, True, torch.float32, False),
    (2, 200, 4, 64, True, torch.float32, False),  # ragged tail
    (1, 333, 2, 32, False, torch.float32, False),  # odd length, non-causal
    (1, 96, 8, 128, True, torch.float32, False),  # short sequence, wide head
    (2, 100, 4, 8, True, torch.float32, False),
    (2, 100, 4, 8, True, torch.bfloat16, False),
    (1, 4096, 2, 16, True, torch.float32, False),
    (1, 4096, 2, 128, True, torch.float32, False),
    (1, 1, 2, 64, False, torch.float32, False),  # T = 1
    (2, 300, 4, 64, True, torch.float32, True),  # views of one [B, T, 3, H, D] projection
]
# (B, T, H, D, dtype, packed) whose tf32x3 pre-pass is held bit for bit
PREPASS_SHAPES = [
    (2, 8192, 4, 64, torch.float32, False),
    (2, 300, 4, 64, torch.float32, True),
    (1, 333, 2, 128, torch.float32, False),
    (2, 8192, 4, 8, torch.bfloat16, False),
]
# (B, T, H, D, causal, packed q/k/v) for flash_fwd_sm90 in bf16; the
# encoder's own shape is checked and timed after these
SM90_SHAPES = [
    (2, 512, 4, 64, True, False),
    (2, 512, 4, 64, False, False),
    (1, 300, 2, 128, True, False),
    (1, 333, 2, 32, False, False),  # ragged
    (1, 77, 2, 16, False, False),
    (2, 300, 4, 64, True, True),  # views of one [B, T, 3, H, D] projection
]
ENCODER = dict(in_dim=GRU_FEATURE_DIM, model_dim=256, num_heads=4, num_layers=4)
ENCODER_BT = (2, 8192)
ENCODER_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
D8_BF16 = (2, 8192, 4, 8)  # tf32x3's bf16 role at the encoder's B, T and H
KERNEL_NAMES = {
    "sm90": "flash_fwd_sm90",
    "tf32x3": "flash_fwd_tf32x3",
    "bwd": "flash_bwd",
    "bwd_sm90": "flash_bwd_sm90",
}
# the libraries whose SASS must hold wgmma (flash_bwd runs on the CUDA cores)
WGMMA_LIBRARIES = ("flash_fwd_sm90", "flash_fwd_tf32x3", "flash_bwd_sm90")
# The backward kernel's dQ, dK, dV against flash_backward_reference on the
# same (q, k, v, O, LSE, dO), per element |g - ref| <= rtol·|ref| +
# atol·max|ref| as (rtol, atol). float32: both sum up to T products in
# float32 in other orders (the plain version sits within 0.06 of this limit
# of a float64 backward on the CPU at T = 2048); bfloat16: both round the
# same float32 values, which may land on either side of a rounding point —
# one step (2^-7·|ref|) and one more. flash_bwd_sm90 also rounds P and dS
# to bf16 before the dV, dK and dQ products; that moves each gradient by at
# most 2^-8 times its term of ``flash.bwd_rounding_terms``, which its limit
# adds (pinned by a CPU emulation in tests/test_torch_flash_bwd.py).
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2**-6, 1e-5)}
# (B, T, H, D, causal, dtype, packed q/k/v): every head dim in both types,
# ragged T, causal or not, views of one packed projection, each through the
# backward kernel of its route (bf16 at D >= 16 → flash_bwd_sm90); the
# encoder's shape is checked and timed after these
BWD_SHAPES = [
    (2, 200, 4, 64, True, torch.float32, False),  # ragged tail
    (2, 200, 4, 64, True, torch.bfloat16, False),
    (1, 333, 2, 32, False, torch.float32, False),  # odd length, non-causal
    (1, 333, 2, 32, False, torch.bfloat16, False),
    (1, 96, 8, 128, True, torch.float32, False),  # short sequence, wide head
    (1, 300, 2, 128, False, torch.bfloat16, False),
    (1, 1000, 2, 128, True, torch.bfloat16, False),  # several key tiles at one warpgroup
    (2, 100, 4, 8, True, torch.float32, False),
    (2, 100, 4, 8, True, torch.bfloat16, False),  # the tf32x3 forward's bf16 role
    (1, 77, 2, 16, False, torch.bfloat16, False),
    (1, 70, 2, 16, True, torch.float32, False),
    (2, 300, 4, 64, True, torch.bfloat16, True),  # views of one [B, T, 3, H, D] projection
    (1, 4096, 2, 64, True, torch.float32, False),
]
# The encoder's gradients with flash (kernels forward and backward) against
# the same with local_attention under autograd on the card, per parameter
# as ||g - ref|| / ||ref||. float32: the kernels keep float32 limits, so
# only summation orders differ (3e-5 in a CPU emulation at T = 1024). In
# bfloat16, δ = rowsum(dO ⊙ O) reads the bf16 O, as the reference's
# _blockwise_bwd does, where autograd through local_attention takes the
# float32 P: at this init dS = P ⊙ (dP − δ) cancels to a small part of its
# terms, so O's rounding moves dQ and dK — the gradients of wq and wk —
# far more than anything else (0.21 at T = 1024 and 0.34 at T = 4096 in a
# CPU emulation of the sm90 forward, 0.01 with δ from a float32 O); every
# other parameter stays at a few 1e-3.
ENCODER_GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
ENCODER_GRAD_QK_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.75}
MLP_DIMS = [MLP_FEATURE_DIM, 128, 128, 1]  # the trainer's default MLP
# bfloat16 products on the card against float32 on the CPU
SCORE_TOL = 2e-2
# the served GNN's scores, card against CPU: the SAGE layers are bf16 on
# both, the pair head takes bf16 inputs on the card only (192 of them,
# [h_src, h_dst, h_src * h_dst]); on an H100 the gap read 0.0255–0.0294
# over 3–6 waves of ~3,800 pairs, log-ms scores near 3
GNN_SCORE_TOL = 5e-2
# one upload round of the scheduler's record sink — 10 rotated backups and
# the active file, 100 MiB each (dragonfly2_tpu/scheduler/storage.py:76-77)
# — shipped in the announcer's 128 MiB chunks (scheduler/announcer.py:38)
UPLOAD_FILES, FILE_MIB, UPLOAD_CHUNK = 11, 100, 128 << 20
TRAINER_IP, TRAINER_HOST = "10.0.0.2", "scheduler-0"
TRAINER_WORK = Path(__file__).resolve().parent / "build" / "trainer_leg"
# a streamed fit on the card (bfloat16 matmul inputs) against the same fit
# on the CPU (float32): each step's loss and the holdout mse, relative
FIT_TOL = 5e-2  # twice what bf16 inputs emulated on the CPU may move them (tests/test_torch_ingest.py)
# the GRU computes in float32 on both (TF32 off): only summation order
# differs, a few ulps a step
GRU_FIT_TOL = 1e-3
# the trainer leg's one cut: the GRU keeps the newest this many of the
# round's sequences (the default 1,000,000 would take its fit past the
# GNN's, see PERF.md); its card-vs-CPU check fits this many
GRU_MAX_SEQUENCES = 40_000
GRU_CHECK_SEQUENCES = 8192
# the preheat leg: rising series among the demand window's flat ones, the
# hosts recommend_seeds ranks with the trained GNN, and the forecast on the
# card against its numpy version (tests/test_preheat.py's limit)
PREHEAT_HOT = 8
PREHEAT_CANDIDATES = 64
FORECAST_TOL = 1e-3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int, device: torch.device) -> float:
    """Median host time of ``fn()`` ending in a device synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def flash_bound_ms(b: int, t: int, h: int, d: int, causal: bool, dtype) -> "tuple[float, str]":
    """Least time for the attention on this card, the largest of: the
    products over the type's peak rate, one exponential per (query, key)
    pair over the special-function rate, and q, k, v, o and LSE moved once
    over the memory rate."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * t * h * d * elem + 4 * b * h * t
    ops_ms = max(
        flash_flops(b, t, h, d, causal) / PEAK_FLOPS[dtype],
        b * h * flash_pairs(t, causal) / PEAK_EXP_PER_S,
    ) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def flash_pairs(t: int, causal: bool) -> int:
    """(query, key) pairs of one head: below the diagonal when causal."""
    return t * (t + 1) // 2 if causal else t * t


def flash_flops(b: int, t: int, h: int, d: int, causal: bool) -> int:
    """Two [T, T]·D products (scores and P·V) over the pairs."""
    return 4 * b * h * d * flash_pairs(t, causal)


def build_kernels() -> None:
    """Every library built at once, each timed, with ptxas's report per
    instantiation and the wgmma count of each tensor-core library's SASS."""

    def timed_load(name):
        t0 = time.perf_counter()
        _build.load(name)
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        for name, secs in pool.map(timed_load, _build.SOURCES):
            print(f"build: {name} in {secs:.1f}s")
    for name in _build.SOURCES:
        for fn, regs, spills, fences in ptxas_report(_build.build_log(name)):
            print(f"  {name} {fn}: {regs} registers, {spills}, {fences} wgmma fences added by ptxas")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.exists():
        print(f"  {cuobjdump} not found: HGMMA instructions not counted")
        return
    for name in WGMMA_LIBRARIES:
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, check=True,
        ).stdout
        hgmma = re.findall(r"\bHGMMA\.(\S+)", sass)
        kinds = sorted(set(hgmma))
        print(f"  {name}: {len(hgmma)} HGMMA instructions in its SASS ({', '.join(kinds[:6])}"
              f"{', ...' if len(kinds) > 6 else ''})")
        check(len(hgmma) > 0, f"{name} compiled without wgmma")


def ptxas_report(log: str) -> "list[tuple[str, str, str, int]]":
    """(instantiation, registers, spills, wgmma fences ptxas had to add) per
    kernel in an ``nvcc -Xptxas -v`` log; the instantiation is named by its
    kernel and its template's int and bool arguments."""
    injected: dict = {}
    for fn in re.findall(r"warpgroup\.arrive is injected .* in function '(\S+)'", log):
        injected[fn] = injected.get(fn, 0) + 1
    out, name, mangled, spills = [], "?", "", "?"
    for line in log.splitlines():
        fn = re.search(r"Function properties for (\S+)", line)
        if fn:
            mangled = fn.group(1)
            args = re.findall(r"L[ib](\d+)E", mangled)
            if "bfloat16" in mangled:
                args.append("bf16")
            name = f"{kernel_base_name(mangled)}<{','.join(args)}>"
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if sp:
            spills = f"{sp.group(1)} B spill stores, {sp.group(2)} B spill loads"
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out.append((name, regs.group(1), spills, injected.get(mangled, 0)))
    return out


def kernel_base_name(mangled: str) -> str:
    """The kernel's own name in a mangled symbol: the length-prefixed
    identifier that ends in ``kernel`` (empty when there is none)."""
    for m in re.finditer(r"(?=(\d{1,3}))", mangled):
        start = m.start() + len(m.group(1))
        ident = mangled[start : start + int(m.group(1))]
        if ident.endswith("kernel") and ident.isidentifier():
            return ident
    return ""


def random_qkv(b, t, h, d, dtype, seed, packed=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        qkv = torch.randn((b, t, 3, h, d), generator=g, device="cuda").to(dtype)
        return qkv.unbind(dim=2)
    return [torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype) for _ in range(3)]


def shape_name(q, causal=None) -> str:
    b, t, h, d = q.shape
    return (
        f"B={b} T={t} H={h} D={d}{'' if causal is None else f' causal={causal}'}"
        f" {str(q.dtype)[6:]}{'' if q.is_contiguous() else ' strided'}"
    )


def prepass_phase() -> float:
    """The tf32x3 pre-pass alone against its plain split, bit for bit, at
    every shape → its device time at the first (the encoder's), in ms."""
    prepass_ms = None
    for i, (b, t, h, d, dtype, packed) in enumerate(PREPASS_SHAPES):
        q, k, v = random_qkv(b, t, h, d, dtype, seed=300 + i, packed=packed)
        with torch.no_grad():
            got = flash.tf32x3_prepass(q, k, v)
            torch.cuda.synchronize()
            want = flash.tf32x3_prepass_reference(q, k, v)
        same = all(
            g.shape == w.shape and torch.equal(g.view(torch.int32), w.contiguous().view(torch.int32))
            for g, w in zip(got, want)
        )
        print(f"tf32x3 pre-pass {shape_name(q)}: bit for bit as its plain split: {same}")
        check(same, f"tf32x3 pre-pass {shape_name(q)} differs from tf32x3_prepass_reference")
        if prepass_ms is None:
            with torch.no_grad():
                prepass_ms = cuda_ms(lambda: flash.tf32x3_prepass(q, k, v), 20)
            print(f"tf32x3 pre-pass {shape_name(q)}: {prepass_ms:.4f} ms")
    return prepass_ms


def flash_case(q, k, v, causal, kernel: str) -> dict:
    """One kernel at one shape against the plain version, with the limit of
    that kernel → {"max_abs_err", "bound_ms", "bound_by"}."""
    b, t, h, d = q.shape
    with torch.no_grad():
        o, lse = flash.launch_kernel(q, k, v, causal, kernel)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash.flash_attention_reference(q, k, v, causal=causal)
        atol, rtol = FLASH_O_TOL[q.dtype]
        limit = atol + rtol * o_ref.float().abs()
        if kernel == "sm90":
            limit += P_ROUNDING * flash.p_rounding_term(q, k, v, causal)
    diff = (o.float() - o_ref.float()).abs()
    err_o = diff.max().item()
    o_share = (diff / limit).max().item()  # worst share of the per-element limit (<= 1 passes)
    o_rel_rms = err_o / o_ref.float().pow(2).mean().sqrt().item()
    err_lse = (lse - lse_ref).abs().max().item()
    name = f"{KERNEL_NAMES[kernel]} {shape_name(q, causal)}"
    p_term = f"+{P_ROUNDING:g}*(P|V|)/l" if kernel == "sm90" else ""
    print(
        f"{name}: max|err| O={err_o:.3g} (max|err|/rms(ref)={o_rel_rms:.3g}; per element"
        f" {o_share:.3g} of the limit {atol:g}+{rtol:g}*|ref|{p_term})"
        f" LSE={err_lse:.3g} ({err_lse / FLASH_LSE_TOL:.3g} of the limit {FLASH_LSE_TOL:g})"
    )
    check(o.shape == q.shape and o.dtype == q.dtype and torch.isfinite(o).all().item(), name)
    check(o_share <= 1.0, f"{name}: kernel's O disagrees with the plain version")
    check(err_lse <= FLASH_LSE_TOL, f"{name}: kernel's LSE disagrees with the plain version")
    bound, by = flash_bound_ms(b, t, h, d, causal, q.dtype)
    return {"max_abs_err": max(err_o, err_lse), "bound_ms": bound, "bound_by": by}


def sdpa(q, k, v, causal):
    """SDPA on [B, T, H, D] tensors already moved to its [B, H, T, D] layout."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)


def flash_times(q, k, v, causal, kernel: str, rounds: int = 3) -> dict:
    """Device times at one shape: the kernel and SDPA in turns, ``rounds``
    times (medians reported), then the plain version → {"ms",
    "library_ms", "plain_ms"}."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's layout
    ms, lib = [], []
    with torch.no_grad():
        for _ in range(rounds):
            ms.append(cuda_ms(lambda: flash.launch_kernel(q, k, v, causal, kernel), 20))
            lib.append(cuda_ms(lambda: sdpa(qt, kt, vt, causal), 20))
        plain = cuda_ms(lambda: flash.flash_attention_reference(q, k, v, causal=causal), 3)
    return {"ms": statistics.median(ms), "library_ms": statistics.median(lib), "plain_ms": plain}


def sdpa_kernels(q, k, v, causal) -> "list[str]":
    """The CUDA kernels one SDPA call runs, by name from a profiler trace."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        sdpa(qt, kt, vt, causal)
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})


def flash_phase() -> dict:
    """Every checked shape of both kernels, then the timed calls: the
    encoder's shape in bfloat16 (sm90) and in float32 (tf32x3), and
    tf32x3's bfloat16 role at D = 8 → {row: its entry of the kernels' table,
    without ``launches``}."""
    for i, (b, t, h, d, causal, dtype, packed) in enumerate(TF32X3_SHAPES):
        flash_case(*random_qkv(b, t, h, d, dtype, seed=100 + i, packed=packed), causal, "tf32x3")
    for i, (b, t, h, d, causal, packed) in enumerate(SM90_SHAPES):
        qkv = random_qkv(b, t, h, d, torch.bfloat16, seed=200 + i, packed=packed)
        flash_case(*qkv, causal, "sm90")

    b, t = ENCODER_BT
    h = ENCODER["num_heads"]
    encoder = (b, t, h, ENCODER["model_dim"] // h)
    rows = {}
    for row, kernel, shape, dtype in (
        ("sm90", "sm90", encoder, torch.bfloat16),
        ("tf32x3", "tf32x3", encoder, torch.float32),
        ("tf32x3_d8_bf16", "tf32x3", D8_BF16, torch.bfloat16),
    ):
        q, k, v = random_qkv(*shape, dtype, seed=7)
        rows[row] = {**flash_case(q, k, v, True, kernel), **flash_times(q, k, v, True, kernel)}
        r = rows[row]
        print(
            f"{KERNEL_NAMES[kernel]} {shape_name(q, True)}: kernel_ms={r['ms']:.4f}"
            f" plain_ms={r['plain_ms']:.4f} library_ms(sdpa)={r['library_ms']:.4f}"
            f" ({r['ms'] / r['library_ms']:.2f}x) bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
            f" {flash_flops(*shape, True) / r['ms'] / 1e9:.1f} TFLOP/s,"
            f" {r['bound_ms'] / r['ms']:.2%} of the bound"
        )
        try:
            names = sdpa_kernels(q, k, v, True)
        except Exception as exc:  # the trace is a reading aid; the times above stand
            names = [f"no trace: {exc}"]
        print(f"  sdpa at {shape_name(q, True)} runs: {'; '.join(names) or 'no kernel seen'}")
    return rows


def bwd_bound_ms(b: int, t: int, h: int, d: int, causal: bool, dtype) -> "tuple[float, str]":
    """Least time for the attention backward on this card, the largest of:
    five products of 2·D operations per (query, key) pair (S, dP, dV, dK,
    dQ) over the type's peak, one exponential per pair over the
    special-function rate, and q, k, v, O, dO and LSE read and dQ, dK, dV
    written once over the memory rate."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 8 * b * t * h * d * elem + 4 * b * h * t
    pairs = b * h * flash_pairs(t, causal)
    ops_ms = max(10 * d * pairs / PEAK_FLOPS[dtype], pairs / PEAK_EXP_PER_S) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bwd_inputs(q, k, v, causal, seed):
    """O and LSE from the forward kernel the path takes, and a seeded
    cotangent dO."""
    with torch.no_grad():
        o, lse = flash.launch_kernel(q, k, v, causal)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return o, lse, torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)


def bwd_case(q, k, v, causal, seed, kernel: "str | None" = None) -> dict:
    """A backward kernel at one shape against its plain version on the same
    (O, LSE, dO), with the limit of that kernel → {"max_abs_err",
    "bound_ms", "bound_by"}. ``kernel`` defaults to the shape's route."""
    b, t, h, d = q.shape
    kernel = kernel or flash.bwd_kernel_for(q.dtype, d)
    o, lse, do = bwd_inputs(q, k, v, causal, seed)
    got = flash.launch_backward(q, k, v, o, lse, do, causal, kernel=kernel)
    torch.cuda.synchronize()
    want = flash.flash_backward_reference(q, k, v, o, lse, do, causal)
    terms = (
        flash.bwd_rounding_terms(q, k, v, o, lse, do, causal) if kernel == "bwd_sm90" else (0, 0, 0)
    )
    rtol, atol = BWD_TOL[q.dtype]
    name = f"{KERNEL_NAMES[kernel]} {shape_name(q, causal)}"
    errs, shares = {}, {}
    for grad, g, w, term in zip(("dq", "dk", "dv"), got, want, terms):
        check(g.shape == q.shape and g.dtype == q.dtype and torch.isfinite(g).all().item(),
              f"{name}: {grad} shape, dtype or finiteness")
        diff = (g.float() - w.float()).abs()
        limit = rtol * w.float().abs() + atol * w.float().abs().max() + P_ROUNDING * term
        errs[grad] = diff.max().item()
        shares[grad] = (diff / limit).max().item()
    p_term = f" + {P_ROUNDING:g}*term" if kernel == "bwd_sm90" else ""
    print(
        f"{name}: max|err| " + " ".join(f"{g}={errs[g]:.3g} ({shares[g]:.3g} of the limit)" for g in errs)
        + f" (limit {rtol:g}*|ref| + {atol:g}*max|ref|{p_term})"
    )
    check(max(shares.values()) <= 1.0, f"{name}: the backward kernel disagrees with the plain version")
    bound, by = bwd_bound_ms(b, t, h, d, causal, q.dtype)
    return {"max_abs_err": max(errs.values()), "bound_ms": bound, "bound_by": by}


def bwd_times(q, k, v, causal, kernels, rounds: int = 3) -> dict:
    """Device times of the backward at one shape: each of ``kernels`` and
    SDPA's backward (on the same inputs in its layout) in turns, ``rounds``
    times (medians reported), then the plain version → {kernel: ms,
    "library_ms", "plain_ms"}."""
    o, lse, do = bwd_inputs(q, k, v, causal, seed=8)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    out = sdpa(qt, kt, vt, causal)
    dot = do.transpose(1, 2).contiguous()

    def library():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    times = {kern: [] for kern in (*kernels, "library_ms")}
    for _ in range(rounds):
        for kern in kernels:
            # flash_bwd takes ~11 ms a call at the encoder's shape, the others < 1
            reps = 5 if kern == "bwd" else 20
            times[kern].append(
                cuda_ms(lambda: flash.launch_backward(q, k, v, o, lse, do, causal, kernel=kern), reps)
            )
        times["library_ms"].append(cuda_ms(library, 20))
    plain = cuda_ms(lambda: flash.flash_backward_reference(q, k, v, o, lse, do, causal), 2)
    return {**{key: statistics.median(ms) for key, ms in times.items()}, "plain_ms": plain}


def bwd_phase() -> dict:
    """Each backward kernel at every checked shape of its route, then at the
    encoder's shape: in bfloat16 ``flash_bwd_sm90`` (its route) and
    ``flash_bwd`` (named, for the comparison and its D = 8 role) checked and
    timed in turns with SDPA's backward, in float32 ``flash_bwd`` → {row:
    its entry of the kernels' table, without ``launches``} for the rows
    ``bwd_sm90``, ``bwd_bfloat16`` and ``bwd_float32``."""
    for i, (b, t, h, d, causal, dtype, packed) in enumerate(BWD_SHAPES):
        bwd_case(*random_qkv(b, t, h, d, dtype, seed=400 + i, packed=packed), causal, seed=500 + i)
    b, t = ENCODER_BT
    h = ENCODER["num_heads"]
    shape = (b, t, h, ENCODER["model_dim"] // h)
    rows = {}
    for dtype, kernels in ((torch.bfloat16, ("bwd_sm90", "bwd")), (torch.float32, ("bwd",))):
        q, k, v = random_qkv(*shape, dtype, seed=9)
        times = bwd_times(q, k, v, True, kernels)
        for kern in kernels:
            row = "bwd_sm90" if kern == "bwd_sm90" else f"bwd_{str(dtype)[6:]}"
            r = rows[row] = {
                **bwd_case(q, k, v, True, seed=10, kernel=kern),
                "ms": times[kern],
                "library_ms": times["library_ms"],
                "plain_ms": times["plain_ms"],
            }
            print(
                f"{KERNEL_NAMES[kern]} {shape_name(q, True)}: kernel_ms={r['ms']:.4f}"
                f" plain_ms={r['plain_ms']:.4f} library_ms(sdpa backward)={r['library_ms']:.4f}"
                f" ({r['ms'] / r['library_ms']:.2f}x) bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
                f" {10 * shape[3] * b * h * flash_pairs(t, True) / r['ms'] / 1e9:.1f} TFLOP/s"
                f" (five products), {r['bound_ms'] / r['ms']:.2%} of the bound"
            )
    return rows


PROBED_AT = 1_000_000.0  # the engines' clock: probes land a minute before


def probe_graph(hosts: int, probes: int, rng: np.random.Generator):
    """Probe measurements drawn from ``rng``: each host probes ``probes``
    distinct other hosts; the RTT follows seeded latent host coordinates
    in the unit square (the reference synth's model: 1 ms + 80 ms ×
    distance + exponential noise of mean 2 ms), so it is learnable from
    host identity → (host ids, a function that feeds them into a new
    engine on a device, the probed peers [hosts, probes] and their RTTs
    in ns). ``fed.coords`` keeps the latent coordinates, for a leg that
    makes transfers take longer between farther hosts."""
    ids = [f"host-{i:05d}" for i in range(hosts)]
    peers = np.stack([rng.choice(hosts - 1, probes, replace=False) for _ in range(hosts)])
    peers += peers >= np.arange(hosts)[:, None]  # distinct peers, no self probe
    coords = rng.uniform(0, 1, (hosts, 2))
    dist = np.linalg.norm(coords[:, None, :] - coords[peers], axis=-1)
    rtts = ((1.0 + 80.0 * dist + rng.exponential(2.0, (hosts, probes))) * 1e6).astype(np.int64)
    cfg = TopologyConfig(flush_threshold=10**9, max_pending=hosts * probes + 1)

    def fed(dev):
        eng = TopologyEngine(cfg, device=dev, clock=lambda: PROBED_AT)
        for i in range(hosts):
            for j, rtt in zip(peers[i], rtts[i]):
                eng.enqueue(ids[i], ids[int(j)], int(rtt), created_at=PROBED_AT - 60.0)
        return eng

    fed.coords = coords
    return ids, fed, peers, rtts


def serve_leg(device, hosts=10_000, probes=16, waves=(256, 15), repeats=20, seed=0) -> dict:
    """Topology flush + wave join + ranked MLP scoring on ``device``, held
    against the same port on the CPU."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ids, fed, _, _ = probe_graph(hosts, probes, rng)
    now = PROBED_AT
    eng = fed(device)
    t0 = time.perf_counter()
    eng.flush(now=now)
    sync(device)
    first_flush_ms = (time.perf_counter() - t0) * 1e3
    refresh_ms = wall_ms(lambda: eng.flush(now=now), 3, device)
    check(eng._D.device.type == device.type, "D is not on the engine's device")
    stats = eng.stats()
    check(stats["edges"] == hosts * probes, "edges lost in the flush")
    print(
        f"serve[{device}]: flush of {stats['edges']} edges / {stats['hosts']} hosts"
        f" first_ms={first_flush_ms:.1f} refresh_ms={refresh_ms:.1f}"
    )

    mlp = init_mlp(torch.Generator().manual_seed(seed), MLP_DIMS)
    blob = serialize_params(mlp)
    scorer = MLPScorer(deserialize_params_auto(blob), device=device)
    check(scorer.feature_dim == MLP_FEATURE_DIM, "scorer feature_dim")

    W, C = waves
    children = rng.integers(0, hosts, W)
    cands = np.stack([rng.choice(hosts, C, replace=False) for _ in range(W)])
    src = [ids[c] for c in np.repeat(children, C)]
    dst = [ids[p] for p in cands.reshape(-1)]
    dst[::97] = ["host-unknown"] * len(dst[::97])  # the 0.0 missing value
    host_stats = rng.random((W * C, MLP_FEATURE_DIM - 1)).astype(np.float32)
    counts = [C] * W
    seg = wave.segment_ids(counts)

    def decide():
        aff = eng.rtt_affinity_pairs(src, dst)
        feats = np.concatenate([host_stats, aff[:, None]], axis=1)
        scores, order = scorer.predict_ranked(feats, seg)
        return aff, feats, scores, order, wave.split_order(order, counts)

    aff, feats, scores, order, rankings = decide()
    check(np.array_equal(order, wave.rank_order(scores, seg)), "rankings differ from rank_order")
    check(len(rankings) == W and all(sorted(r) == list(range(C)) for r in rankings), "rankings")
    check(np.isfinite(scores).all() and scores.shape == (W * C,), "scores not finite")
    wave_ms = wall_ms(decide, repeats, device)
    join_ms = wall_ms(lambda: eng.rtt_affinity_pairs(src, dst), repeats, device)
    score_ms = wall_ms(lambda: scorer.predict_ranked(feats, seg), repeats, device)
    print(
        f"serve[{device}]: wave {W}x{C} rows={W * C} wave_ms={wave_ms:.3f}"
        f" (join_ms={join_ms:.3f} score_ms={score_ms:.3f})"
    )
    out = {
        "flush_first_ms": first_flush_ms,
        "flush_refresh_ms": refresh_ms,
        "wave_ms": wave_ms,
        "join_ms": join_ms,
        "score_ms": score_ms,
        "rows": W * C,
        "edges": stats["edges"],
    }
    if device.type == "cuda":
        cpu_eng = fed("cpu")
        cpu_eng.flush(now=now)
        cpu_aff = cpu_eng.rtt_affinity_pairs(src, dst)
        cpu_scores = MLPScorer(deserialize_params_auto(blob), device="cpu").predict(feats)
        aff_err = float(np.abs(aff - cpu_aff).max())
        score_err = float(np.abs(scores - cpu_scores).max())
        print(
            f"serve: max|aff - cpu|={aff_err:.3g} (tol 1e-5)"
            f" max|score(bf16) - cpu(f32)|={score_err:.3g} (tol 2e-2)"
        )
        check(aff_err <= 1e-5, "affinities differ from the CPU engine")
        check(score_err <= 2e-2, "scores differ from the CPU scorer")
        check(float((aff > 0).mean()) > 0.9, "affinity column mostly missing")
        out.update(aff_err=aff_err, score_err=score_err)
    return out


@dataclass
class _Model:
    """The fields the refresher reads of the manager's ``Model`` message."""

    model_id: str
    type: str
    version: int
    state: str
    updated_at_ns: int
    created_at_ns: int


class _Manager:
    """In-process stand-in for the manager's model registry and job queue:
    ``CreateModel`` stores a model as the next version of its id, active
    at once (the manager's activation step is an operator's),
    ``ListModels`` lists each id at its newest version, ``GetModelWeights``
    returns a stored model's npz bytes and ``CreateJob`` keeps the job's
    request. Called in-process it answers with plain records; with
    ``pb2`` (the manager's generated module) it answers with its messages,
    and ``served`` puts it behind a gRPC server — with the scheduler
    registration, keepalive and job-lease RPCs the scheduler server calls —
    on the port's own ``glue.serve``."""

    def __init__(self, pb2=None):
        self.created = {}  # model_id → its newest CreateModel request
        self.versions = {}  # model_id → its newest version
        self.stamps = {}  # model_id → creation order of its newest version
        self.jobs = []  # the CreateJob requests, in order
        self.calls = {}  # RPC name → times called
        self.pb2 = pb2
        self._seq = 0  # creation order: a newer upload is the newer activation
        self._lock = threading.Lock()

    def _called(self, name):
        with self._lock:
            self.calls[name] = self.calls.get(name, 0) + 1

    def CreateModel(self, request, context=None):
        self._called("CreateModel")
        with self._lock:
            mid = request.model_id
            self.created[mid] = request
            self.versions[mid] = self.versions.get(mid, 0) + 1
            self._seq += 1
            self.stamps[mid] = self._seq
            version = self.versions[mid]
        if self.pb2 is not None:
            return self.pb2.Model(model_id=mid, type=request.type, version=version, state="active")
        return None

    def ListModels(self, request, context=None):
        self._called("ListModels")
        with self._lock:
            rows = [(r, self.versions[m], self.stamps[m]) for m, r in self.created.items()]
        if self.pb2 is not None:
            return self.pb2.ListModelsResponse(models=[
                self.pb2.Model(model_id=r.model_id, type=r.type, version=v, state="active",
                               created_at_ns=n, updated_at_ns=n)
                for r, v, n in rows
            ])
        return SimpleNamespace(models=[_Model(r.model_id, r.type, v, "active", n, n) for r, v, n in rows])

    def GetModelWeights(self, request, context=None):
        self._called("GetModelWeights")
        with self._lock:
            known = self.versions.get(request.model_id) == request.version
            req = self.created.get(request.model_id)
        check(known, "unknown model asked for")
        if self.pb2 is not None:
            return self.pb2.ModelWeights(model_id=req.model_id, version=request.version,
                                         type=req.type, weights=req.weights)
        return SimpleNamespace(weights=req.weights)

    def CreateJob(self, request, context=None):
        self._called("CreateJob")
        with self._lock:
            self.jobs.append(request)
            n = len(self.jobs)
        if self.pb2 is not None:
            return self.pb2.Job(id=n, type=request.type, state="pending")
        return SimpleNamespace(id=n)

    # the scheduler server's registration, keepalive and job lease
    def UpdateScheduler(self, request, context=None):
        self._called("UpdateScheduler")
        return self.pb2.Scheduler(hostname=request.hostname, ip=request.ip, port=request.port,
                                  scheduler_cluster_id=request.scheduler_cluster_id)

    def KeepAlive(self, request_iterator, context=None):
        self._called("KeepAlive")
        for _ in request_iterator:
            pass
        return self.pb2.Empty()

    def ListPendingJobs(self, request, context=None):
        self._called("ListPendingJobs")
        return self.pb2.ListPendingJobsResponse()

    def UpdateJobResult(self, request, context=None):
        self._called("UpdateJobResult")
        return self.pb2.Job(id=request.id, state=request.state)

    def served(self):
        """This stand-in behind a gRPC server on the port's ``glue.serve``
        → (server, "127.0.0.1:<port>"). The manager RPCs it does not answer
        abort with UNIMPLEMENTED."""
        import grpc

        from dragonfly2_torch.rpc import glue, protos

        self.pb2 = protos.load("manager_pb2")
        stand_in = self

        class _Service:
            def __getattr__(self, name):
                impl = getattr(stand_in, name, None)
                if impl is not None:
                    return impl

                def unimplemented(request, context):
                    context.abort(grpc.StatusCode.UNIMPLEMENTED, f"the stand-in has no {name}")

                return unimplemented

        server, port = glue.serve({glue.MANAGER_SERVICE: _Service()})
        return server, f"127.0.0.1:{port}"


class _RecordingEvaluator(MLEvaluator):
    """The ``ml`` evaluator, keeping the last wave's candidate sets."""

    def evaluate_wave(self, children, candidate_sets, total_piece_counts):
        self.last_sets = [list(c) for c in candidate_sets]
        return super().evaluate_wave(children, candidate_sets, total_piece_counts)


class _RecordingService(ScoringService):
    """The scoring service, keeping the last wave's features and what it
    handed back: per decision (scores, ranking)."""

    def score_wave(self, features, pairs, counts, budget_s=None):
        out = super().score_wave(features, pairs, counts, budget_s=budget_s)
        self.last = (np.asarray(features, np.float32), out)
        return out


def device_busy(fn) -> "tuple[float, float | None]":
    """One ``fn()`` under ``torch.profiler`` → (its host wall in ms, the
    summed durations of the CUDA kernels and copies it ran, in ms; None
    when the trace holds no device activity)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = sum(
        e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    return wall_ms, (busy_us / 1e3 if busy_us else None)


def build_swarm(ids, tasks: int, peers: int, rng: np.random.Generator):
    """The scheduler's resource model over the hosts ``ids``: host stats in
    their valid ranges (about 1 host in 50 a seed peer), ``tasks`` image
    layers of ``peers`` peers each on distinct hosts; a quarter of each
    task's peers have succeeded, the rest are running with one succeeded
    parent each → (resource, the running peers)."""
    n = len(ids)
    resource = res.Resource()
    seed_hosts = rng.random(n) < 1 / 50
    for i, hid in enumerate(ids):
        h = res.Host(
            id=hid,
            type=res.HostType.SUPER if seed_hosts[i] else res.HostType.NORMAL,
            hostname=hid,
            ip=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}",
            port=65000,
            download_port=65002,
        )
        h.cpu.logical_count = h.cpu.physical_count = 32
        h.cpu.percent = float(rng.uniform(0, 100))
        h.cpu.process_percent = float(rng.uniform(0, h.cpu.percent))
        h.memory.total = 64 << 30
        h.memory.used_percent = float(rng.uniform(5, 95))
        h.memory.available = int(h.memory.total * (1 - h.memory.used_percent / 100))
        h.network.tcp_connection_count = int(rng.integers(0, 2000))
        h.network.upload_tcp_connection_count = int(rng.integers(0, 200))
        h.network.location = f"cn|r{rng.integers(4)}|z{rng.integers(8)}|rack{rng.integers(64)}"
        h.network.idc = f"idc-{rng.integers(16)}"
        h.disk.used_percent = float(rng.uniform(5, 95))
        h.disk.inodes_used_percent = float(rng.uniform(1, 60))
        h.upload_count = int(rng.integers(0, 500))
        h.upload_failed_count = int(rng.integers(0, h.upload_count // 10 + 1))
        resource.host_manager.store(h)
    hosts = resource.host_manager
    running = []
    for t in range(tasks):
        task = res.Task(f"layer-{t:02d}", url=f"https://registry.example/v2/app/blobs/sha256:{t:064x}")
        task.content_length = int(rng.lognormal(np.log(48 << 20), 0.8))
        task.total_piece_count = -(-task.content_length // task.piece_length)
        task.fsm.event(res.TASK_EVENT_DOWNLOAD)
        resource.task_manager.store(task)
        done, fed = [], []
        for k, hi in enumerate(rng.choice(n, peers, replace=False)):
            peer = res.Peer(f"peer-{t:02d}-{k:03d}", task, hosts.load(ids[hi]))
            peer.fsm.event(res.PEER_EVENT_REGISTER_NORMAL)
            peer.fsm.event(res.PEER_EVENT_DOWNLOAD)
            for cost in rng.lognormal(np.log(40.0), 0.5, rng.integers(2, 9)):
                peer.append_piece_cost(float(cost))
            if k < peers // 4:
                peer.fsm.event(res.PEER_EVENT_DOWNLOAD_SUCCEEDED)
                peer.finished_pieces = set(range(task.total_piece_count))
                done.append(peer)
            else:
                peer.finished_pieces = set(range(int(rng.integers(0, task.total_piece_count))))
                fed.append(peer)
            resource.peer_manager.store(peer)
        for peer in fed:
            task.add_peer_edge(done[int(rng.integers(len(done)))], peer)
        running += fed
    return resource, running


def gnn_swap(manager, model_id, topology, service, dev) -> dict:
    """The GNN's swap-time work, timed apart from the refresher's install:
    the probe-graph export, the graph build and the embed over it on
    ``dev``; then the served GNN scored on every exported edge against the
    edge's RTT (it must beat the mean predictor: the node embedding table
    it was trained with lines up with the live graph's hosts)."""
    params = deserialize_params_auto(manager.created[model_id].weights)
    t0 = time.perf_counter()
    records = topology.export_records()
    t1 = time.perf_counter()
    graph = build_probe_graph(records_to_columns(records))
    t2 = time.perf_counter()
    GNNScorer(params, graph, device=dev)
    sync(dev)
    t3 = time.perf_counter()
    served = service._served[0]._scorer
    ids = graph.node_ids
    pred = served.predict_rtt_log_ms([ids[i] for i in graph.edge_src], [ids[i] for i in graph.edge_dst])
    y = graph.edge_rtt_log_ms
    out = {
        "gnn_export_ms": (t1 - t0) * 1e3, "gnn_graph_ms": (t2 - t1) * 1e3,
        "gnn_embed_ms": (t3 - t2) * 1e3, "gnn_nodes": graph.num_nodes,
        "gnn_edges": len(y), "gnn_served_mse": float(np.mean((pred - y) ** 2)),
        "gnn_served_mean_predictor_mse": mean_mse(y),
    }
    print(
        f"scheduler[{dev}]: gnn swap over {out['gnn_nodes']} hosts / {out['gnn_edges']} edges:"
        f" export_ms={out['gnn_export_ms']:.1f} graph_ms={out['gnn_graph_ms']:.1f}"
        f" embed_ms={out['gnn_embed_ms']:.1f}; served mse on the exported edges"
        f" {out['gnn_served_mse']:.5f} (mean predictor {out['gnn_served_mean_predictor_mse']:.5f})"
    )
    check(np.isfinite(pred).all() and out["gnn_served_mse"] < out["gnn_served_mean_predictor_mse"],
          "the served GNN does not beat the mean predictor on the live graph's edges")
    return out


def scheduler_leg(
    device, hosts=10_000, probes=16, tasks=40, peers=256, wave_size=256, waves=20, warmup=2,
    seed=0, manager=None,
) -> dict:
    """The scheduler's ``ml`` decision path on ``device``: the active MLP of
    ``manager`` (by default a stand-in holding a seeded random one)
    installed by the refresher, then ``warmup`` + ``waves`` waves of
    ``wave_size`` running children through
    ``Scheduling.find_candidate_parents_wave``. Each checked wave must be
    scored by the service (rung ``serving``, one service wave, no
    demotion, no fallback) and rank every decision by ``rank_order`` of
    its scores; on the card the same waves then run on the CPU and must
    give the same candidate sets and scores within ``SCORE_TOL``."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ids, fed, _, _ = probe_graph(hosts, probes, rng)
    resource, running = build_swarm(ids, tasks, peers, rng)
    children = [
        [running[i] for i in rng.choice(len(running), wave_size, replace=False)]
        for _ in range(warmup + waves)
    ]
    if manager is None:
        manager = _Manager()
        blob = serialize_params(init_mlp(torch.Generator().manual_seed(seed), MLP_DIMS))
        manager.CreateModel(PlainRequests().create_model("mlp-smoke", "mlp", "", "smoke", blob, {}))

    def run(dev):
        """The leg's waves on ``dev`` → per checked wave (candidate ids per
        decision, features, per-decision (scores, ranking)), and times."""
        eng = fed(dev)
        eng.flush(now=PROBED_AT)
        service = _RecordingService()
        service.start()
        try:
            evaluator = _RecordingEvaluator(topology=eng, serving=service)
            topology = NetworkTopology(KVStore(), resource.host_manager, engine=eng)
            refresher = ModelRefresher(
                manager, evaluator, serving=service, networktopology=topology, device=dev,
                requests=PlainRequests(),
            )
            t0 = time.perf_counter()
            check(refresher.refresh_once(), "the refresher installed no model")
            sync(dev)
            install_ms = (time.perf_counter() - t0) * 1e3
            # the newest model of each type is the active one
            latest = {m.type: m.model_id for m in manager.ListModels(None).models}
            served_kind = "gnn" if "gnn" in latest else "mlp"
            check(refresher.loaded_version == (latest["mlp"], 1), "another MLP installed")
            check(evaluator._model is not None and evaluator._model.device.type == dev.type,
                  "the MLP is not installed on the leg's device")
            # the refresher's installs are best-effort: a model that failed
            # to install must fail here, never pass on a lower rung
            check(service.model_kind() == served_kind,
                  f"serving {service.model_kind()!r}, not the {served_kind!r} the manager activated")
            extra = {}
            if "gnn" in latest:
                check(refresher.loaded_gnn_version == (latest["gnn"], 1), "the GNN is not installed")
                extra.update(gnn_swap(manager, latest["gnn"], topology, service, dev))
            if "gru" in latest:
                check(refresher.loaded_gru_version == (latest["gru"], 1), "the GRU is not installed")
                check(isinstance(evaluator._gru, GRUScorer) and evaluator._gru.device.type == dev.type,
                      "the GRU is not installed on the leg's device")
            sched = Scheduling(evaluator)
            fallbacks = scheduler_metrics.SERVING_FALLBACK_TOTAL
            phases = (wave.PH_WAVE_PACK, wave.PH_WAVE_SCORE)
            out, walls, rows = [], [], []
            for w, kids in enumerate(children):
                if w == warmup:
                    phase0 = [(ph.count, ph.total_s) for ph in phases]
                    batches0 = service.batches
                before = (service.waves, sum(fallbacks.labels(r).value for r in ("mlp", "base")))
                t_start = time.time_ns()
                random.seed(seed * 1000 + w)
                t0 = time.perf_counter()
                found = sched.find_candidate_parents_wave(kids)
                sync(dev)
                wall_ms = (time.perf_counter() - t0) * 1e3
                if w < warmup:
                    print(f"scheduler[{dev}]: warm-up wave {w}: {wall_ms:.1f} ms, rung {evaluator._rung!r}")
                    continue
                walls.append(wall_ms)
                feats, scored = service.last
                sets = evaluator.last_sets
                last = [
                    e for e in flight.snapshot(["scheduler"])["scheduler"]
                    if e["type"] == "scheduler.wave_evaluated" and e["ts_ns"] >= t_start
                ]
                name = f"scheduler[{dev}] wave {w}"
                check(evaluator._rung == "serving", f"{name}: rung {evaluator._rung!r}, not serving")
                check(service.waves == before[0] + 1, f"{name}: the service scored no wave")
                check(len(last) == 1 and last[0]["demoted"] == 0, f"{name}: demoted decisions {last}")
                check(
                    sum(fallbacks.labels(r).value for r in ("mlp", "base")) == before[1],
                    f"{name}: a serving fallback was counted",
                )
                check(all(ok for _, ok in found) and len(sets) == len(kids), f"{name}: a child found no parent")
                check(feats.shape == (sum(map(len, sets)), MLP_FEATURE_DIM), f"{name}: feature shape")
                for (parents, _), cands, (scores, ranking) in zip(found, sets, scored):
                    check(np.isfinite(scores).all() and len(scores) == len(cands), f"{name}: scores")
                    check(
                        np.array_equal(ranking, wave.rank_order(scores, np.zeros(len(scores)))),
                        f"{name}: a ranking differs from rank_order of its scores",
                    )
                    check(
                        [p.id for p in parents] == [cands[int(k)].id for k in ranking[:4]],
                        f"{name}: the decision is not its ranking's head",
                    )
                rows.append(feats.shape[0])
                out.append(([[p.id for p in c] for c in sets], feats, scored))
            if "gru" in latest:
                # the GRU branch of is_bad_node ran: it caches one verdict
                # per candidate it scored, and only on success
                verdicts = evaluator._gru_verdicts
                check(len(verdicts) > 0, "is_bad_node never took the GRU branch")
                extra.update(gru_verdicts=len(verdicts),
                             gru_bad=sum(1 for _, bad in verdicts.values() if bad))
            times = {
                **extra,
                "kind": served_kind,
                "install_ms": install_ms,
                "rows_per_wave": statistics.mean(rows),
                "service_batches": service.batches - batches0,
                "schedule_wave_ms": statistics.median(walls),
                "schedule_wave_mean_ms": statistics.mean(walls),
            }
            for key, ph, (n0, s0) in zip(("pack_ms", "score_ms"), phases, phase0):
                times[key] = (ph.total_s - s0) / (ph.count - n0) * 1e3
            if dev.type == "cuda":  # one more wave, traced, outside the times above
                random.seed(seed * 1000 + warmup)
                try:  # the trace is a reading aid; the checked waves stand
                    traced = device_busy(lambda: sched.find_candidate_parents_wave(children[warmup]))
                except Exception as exc:
                    traced = (None, None)
                    print(f"scheduler[{dev}]: no device trace: {exc}")
                wall_ms, busy_ms = traced
                if busy_ms is not None:
                    times.update(traced_wave_ms=wall_ms, device_busy_ms=busy_ms,
                                 device_idle_share=1 - busy_ms / wall_ms)
                    print(
                        f"scheduler[{dev}]: traced wave: {wall_ms:.2f} ms wall, device busy"
                        f" {busy_ms:.3f} ms (idle share {times['device_idle_share']:.4f})"
                    )
            return out, times
        finally:
            service.stop()

    got, times = run(device)
    decisions = waves * wave_size
    mean_cands = sum(f.shape[0] for _, f, _ in got) / decisions
    times["filter_ms"] = times["schedule_wave_mean_ms"] - times["pack_ms"] - times["score_ms"]
    print(
        f"scheduler[{device}]: {len(ids)} hosts, {tasks} tasks x {peers} peers,"
        f" {waves} waves of {wave_size}: rows/wave={times['rows_per_wave']:.1f}"
        f" (mean {mean_cands:.2f} candidates per decision) service_batches={times['service_batches']}"
        f" install_ms={times['install_ms']:.1f} schedule_wave_ms={times['schedule_wave_ms']:.2f}"
        f" (mean {times['schedule_wave_mean_ms']:.2f}: pack_ms={times['pack_ms']:.2f}"
        f" score_ms={times['score_ms']:.2f} filter_ms={times['filter_ms']:.2f})"
    )
    if mean_cands < 8:
        print(f"scheduler[{device}]: only {mean_cands:.2f} candidates per decision (fewer than 8)")
    check(mean_cands >= 8, "fewer than 8 candidates per decision")
    out = {**times, "decisions": decisions, "mean_candidates": mean_cands}
    if device.type == "cuda":
        want, _ = run(torch.device("cpu"))
        score_err = rtt_err = 0.0
        for w, ((sets, feats, scored), (cpu_sets, cpu_feats, cpu_scored)) in enumerate(zip(got, want)):
            check(sets == cpu_sets, f"wave {w}: candidate sets differ from the CPU run")
            check(np.array_equal(feats[:, :-1], cpu_feats[:, :-1]), f"wave {w}: host features differ")
            rtt_err = max(rtt_err, float(np.abs(feats[:, -1] - cpu_feats[:, -1]).max()))
            for (s, _), (cs, _) in zip(scored, cpu_scored):
                score_err = max(score_err, float(np.abs(s - cs).max()))
        tol = GNN_SCORE_TOL if times["kind"] == "gnn" else SCORE_TOL
        print(
            f"scheduler: candidate sets equal the CPU run's in {waves} waves;"
            f" max|rtt_affinity - cpu|={rtt_err:.3g} (tol 1e-5)"
            f" max|{times['kind']} score(bf16) - cpu(f32)|={score_err:.3g} (tol {tol:g})"
        )
        check(rtt_err <= 1e-5, "rtt_affinity differs from the CPU engine")
        check(score_err <= tol, "scores differ from the CPU run")
        out.update(rtt_err=rtt_err, score_err=score_err)
    return out



def topology_records(ids, peers, rtts, rng: np.random.Generator) -> list:
    """The probe graph as the scheduler's topology snapshotter writes it:
    each snapshot one ``NetworkTopologyRecord`` per host with ≤ 5 of its
    probed peers (``records.MAX_DEST_HOSTS``), snapshot after snapshot, so
    the first snapshot lists hosts and peers in the order the engine's own
    export does (the graph's node order, which the GNN's per-node
    embedding table follows); host stats seeded from ``rng``, about 1 host
    in 50 a seed peer."""
    n = len(ids)
    seeds = rng.random(n) < 1 / 50
    tcp = rng.integers(10, 2000, n)
    utcp = rng.integers(0, 500, n)

    def host(cls, i, **kw):
        return cls(
            id=ids[i], type="super" if seeds[i] else "normal", hostname=ids[i],
            ip=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}", port=65000,
            network=R.Network(
                tcp_connection_count=int(tcp[i]), upload_tcp_connection_count=int(utcp[i]),
                idc=f"idc-{i % 16}",
            ),
            **kw,
        )

    out = []
    for c in range(0, peers.shape[1], R.MAX_DEST_HOSTS):
        for i in range(n):
            dests = [
                host(R.DestHost, int(j), probes=R.ProbesRecord(average_rtt=int(rtt)))
                for j, rtt in zip(peers[i, c : c + R.MAX_DEST_HOSTS], rtts[i, c : c + R.MAX_DEST_HOSTS])
            ]
            out.append(R.NetworkTopologyRecord(
                id=f"nt-{i}-{c // R.MAX_DEST_HOSTS}", host=host(R.SrcHost, i), dest_hosts=dests,
            ))
    return out


def encode_blocks(encode, recs) -> bytes:
    """``recs`` as consecutive blocks of ``wire.BLOCK_RECORDS``, the size the
    scheduler's sink flushes."""
    step = wire.BLOCK_RECORDS
    return b"".join(encode(recs[i : i + step]) for i in range(0, len(recs), step))


def holdout_labels(blocks, eval_every: int, cap: int, total_blocks: int) -> np.ndarray:
    """The labels ``stream_train_mlp`` holds out and collects from a stream
    of ``total_blocks`` blocks that repeats ``blocks`` (decoded shards in
    stream order): every shard's ``ingest.holdout_mask`` pairs, appended
    until ``cap`` pairs are collected, as the fit collects them."""
    out, got = [], 0
    for b in range(total_blocks):
        if got >= cap:
            break
        feats, labels = blocks[b % len(blocks)]
        mask = holdout_mask(feats, labels, eval_every)
        if mask.any():
            out.append(labels[mask])
            got += int(mask.sum())
    return np.concatenate(out).astype(np.float32)


def mean_mse(y: np.ndarray) -> float:
    """MSE of the mean predictor (every prediction the labels' mean)."""
    return float(np.mean((y - y.mean()) ** 2))


def trainer_leg(
    device, files=UPLOAD_FILES, file_mib=FILE_MIB, hosts=10_000, probes=16, mlp_epochs=3,
    gnn_epochs=60, check_blocks=64, window_superbatches=20, seed=0,
    serve=dict(tasks=40, peers=256, wave_size=256, waves=3, warmup=1),
    streaming_threshold_bytes=TrainingConfig.streaming_threshold_bytes,
    group_records=2000, mlp_batch=8192, gnn_batch=2048, gru_max_sequences=GRU_MAX_SEQUENCES,
    manager=None,
) -> dict:
    """The trainer's fit path on ``device``: one upload round — ``files`` ×
    ``file_mib`` MiB of binary train blocks (2,000 seeded download records
    replicated, as ``synth.synthesize_dataset_binary`` does) and the serve
    leg's probe graph as topology blocks — fed through
    ``TrainerService.Train`` in the announcer's chunks; ``Training`` built
    as the trainer server builds it from its defaults (MLP streamed,
    2 passes, 1 worker, k = 1; GNN 60 epochs; GRU on, batch 128, 10
    epochs), with one cut: the GRU keeps the newest ``gru_max_sequences``
    (a rehearsal at a reduced size also lowers the 64 MiB streaming
    threshold, the group and the batches). All three uploads must reach
    the manager stand-in and beat the mean predictor on their holdout;
    then the refresher installs the three trained models and scheduler
    waves run on them (``scheduler_leg``): the GNN in the serving slot,
    the GRU behind bad-node detection. On the card, a reduced streamed MLP
    fit and a reduced GRU fit are held against the same fits on the CPU,
    and ~20 superbatches are traced for the device's idle share. The
    uploads land in ``manager`` (a new stand-in when None)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    shutil.rmtree(TRAINER_WORK, ignore_errors=True)
    TRAINER_WORK.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        group = encode_blocks(
            wire.encode_train_block, synth.make_download_records(group_records, seed=seed)
        )
        group_path = TRAINER_WORK / "group.dfb"
        group_path.write_bytes(group)
        group_pairs = wire.read_train_pairs(group_path)
        reps = max(1, (file_mib << 20) // len(group))
        ids, _, peers, rtts = probe_graph(hosts, probes, rng)
        topo_path = TRAINER_WORK / "topology.dfb"
        topo_path.write_bytes(encode_blocks(wire.encode_topology_block, topology_records(ids, peers, rtts, rng)))
        records = files * reps * group_pairs.num_downloads
        print(
            f"trainer[{device}]: upload round: {files} files x {reps} x {len(group)} B ="
            f" {files * reps * len(group) / 2**20:.1f} MiB of train blocks ({records} download"
            f" records, {files * reps * len(group_pairs.labels)} pairs); topology"
            f" {topo_path.stat().st_size / 2**20:.1f} MiB ({hosts} hosts x {probes} probes);"
            f" made in {time.perf_counter() - t0:.1f}s"
        )

        messages = PlainMessages()

        def chunks(kind, data):
            for off in range(0, len(data), UPLOAD_CHUNK):
                yield messages.train_request(TRAINER_IP, TRAINER_HOST, kind, data[off : off + UPLOAD_CHUNK])

        def requests():
            for _ in range(files):
                yield from chunks("train_mlp_binary", group * reps)
            yield from chunks("train_gnn_binary", topo_path.read_bytes())

        manager = manager if manager is not None else _Manager()
        # as dragonfly2_tpu/trainer/server.py:86-113 builds it from the
        # server's defaults, plus the GRU's one cut
        config = TrainingConfig(
            mlp=FitConfig(epochs=mlp_epochs, batch_size=mlp_batch),
            gnn=GNNFitConfig(epochs=gnn_epochs, batch_size=gnn_batch),
            min_download_records=1,
            min_topology_records=1,
            gru=True,
            gru_min_sequences=8,
            incremental=False,
            clear_after_train=True,
            streaming=True,
            streaming_workers=1,
            auto_mesh=True,
            profile_dir="",
            checkpoint_dir="",
            streaming_threshold_bytes=streaming_threshold_bytes,
            gru_max_sequences=gru_max_sequences,
        )
        storage = TrainerStorage(TRAINER_WORK / "storage")
        training = Training(storage, ManagerUploader(manager, PlainRequests()), config, device=device)
        service = TrainerService(storage, training, synchronous=True, messages=messages)
        fit_walls = {m: (M_T.FIT_DURATION.labels(m).total, M_T.FIT_TOTAL.labels(m, "success").value)
                     for m in ("mlp", "gnn", "gru")}
        since = time.time_ns()
        t0 = time.perf_counter()
        service.Train(requests(), None)
        sync(device)
        round_s = time.perf_counter() - t0
        events = [e for e in flight.snapshot(["trainer"])["trainer"] if e["ts_ns"] >= since]
        rounds = [e for e in events if e["type"] == "trainer.round"]
        check(len(rounds) == 1 and rounds[0]["ok"], f"the training round failed: {rounds}")
        done = [e for e in events if e["type"] == "trainer.stream_done"]
        check(len(done) == 1, "the MLP leg did not take the streamed fit")
        split = done[0]
        check(device.type == "cpu" or split["h2d_s"] > 0, "the streamed fit copied nothing to the card")
        for m, (total0, ok0) in fit_walls.items():
            check(M_T.FIT_TOTAL.labels(m, "success").value == ok0 + 1, f"no successful {m} fit")
            fit_walls[m] = M_T.FIT_DURATION.labels(m).total - total0
        mlp_up = manager.created[mlp_model_id_v1(TRAINER_IP, TRAINER_HOST)]
        gnn_up = manager.created[gnn_model_id_v1(TRAINER_IP, TRAINER_HOST)]
        gru_up = manager.created[gru_model_id_v1(TRAINER_IP, TRAINER_HOST)]
        check((mlp_up.type, gnn_up.type, gru_up.type) == ("mlp", "gnn", "gru"), "uploads of the wrong type")

        # mean predictors on the same holdouts
        cap = 16 * config.mlp.batch_size  # stream_train_mlp's eval_max_batches
        eval_every = max(2, round(1.0 / config.mlp.eval_fraction))
        blocks = [(f, l) for f, l, _ in wire.stream_train_pairs(group_path, half=True)]
        y_mlp = holdout_labels(blocks, eval_every, cap, files * reps * len(blocks) * config.streaming_passes)
        graph = build_probe_graph(wire.read_columns(topo_path), max_degree=config.gnn_max_degree)
        train_idx, eval_idx = _split_eval(len(graph.edge_src), config.gnn.eval_fraction, config.gnn.seed)
        gnn_steps = _batch_steps(len(train_idx), config.gnn.batch_size)[0] * config.gnn.epochs
        # the GRU's holdout: the round's newest gru_max_sequences (the
        # upload repeats the group's sequences), split as train_gru splits
        group_seqs = list(wire.stream_gru_sequences(group_path))
        gru_labels = np.concatenate([q.labels for q in group_seqs])
        gru_total = files * reps * len(gru_labels)
        gru_n = min(gru_total, config.gru_max_sequences)
        gru_kept = np.tile(gru_labels, -(-gru_n // len(gru_labels)))[-gru_n:]
        gru_train, gru_eval = _split_eval(gru_n, config.gru_config.eval_fraction, config.gru_config.seed)
        gru_steps = _batch_steps(len(gru_train), config.gru_config.batch_size)[0] * config.gru_config.epochs
        mlp_ev, gnn_ev, gru_ev = mlp_up.evaluation, gnn_up.evaluation, gru_up.evaluation
        out = {
            "round_s": round_s,
            "download_mib": files * reps * len(group) / 2**20,
            "mlp": {
                "fit_wall_s": fit_walls["mlp"], "records": split["records"],
                "records_per_s": split["records"] / split["wall_s"], "steps": split["steps"],
                "pairs": split["pairs"], "mse": mlp_ev.mse, "mae": mlp_ev.mae,
                "mean_predictor_mse": mean_mse(y_mlp), "holdout_pairs": len(y_mlp),
                **{k: split[k] for k in ("wall_s", "decode_wait_s", "buffer_wait_s", "h2d_s",
                                         "h2d_overlap_s", "step_s", "read_s", "cast_s", "enqueue_s")},
            },
            "gnn": {
                "fit_wall_s": fit_walls["gnn"], "records": graph.num_records,
                "records_per_s": graph.num_records / fit_walls["gnn"], "steps": gnn_steps,
                "edges": len(graph.edge_src), "nodes": graph.num_nodes, "mse": gnn_ev.mse,
                "mae": gnn_ev.mae, "precision": gnn_ev.precision, "recall": gnn_ev.recall,
                "f1": gnn_ev.f1,
                "mean_predictor_mse": mean_mse(graph.edge_rtt_log_ms[eval_idx]),
            },
            "gru": {
                "fit_wall_s": fit_walls["gru"], "sequences": gru_n, "round_sequences": gru_total,
                "steps": gru_steps, "ms_per_step": fit_walls["gru"] / gru_steps * 1e3,
                "mse": gru_ev.mse, "mae": gru_ev.mae,
                "mean_predictor_mse": mean_mse(gru_kept[gru_eval]), "holdout": len(gru_eval),
            },
        }
        m, g, q = out["mlp"], out["gnn"], out["gru"]
        print(
            f"trainer[{device}]: Train stream → fits → CreateModel in {round_s:.1f}s;"
            f" mlp: fit_wall_s={m['fit_wall_s']:.2f} (stream wall {m['wall_s']:.2f}s)"
            f" records/s={m['records_per_s']:.0f} steps={m['steps']} pairs={m['pairs']}"
            f" holdout mse={m['mse']:.5f} mae={m['mae']:.5f} (mean predictor mse"
            f" {m['mean_predictor_mse']:.5f} on {m['holdout_pairs']} pairs)"
        )
        print(
            f"trainer[{device}]: mlp split: " + " ".join(
                f"{k}={m[k]:.3f}" for k in ("decode_wait_s", "buffer_wait_s", "h2d_s",
                                             "h2d_overlap_s", "step_s", "read_s", "cast_s", "enqueue_s"))
        )
        print(
            f"trainer[{device}]: gnn: fit_wall_s={g['fit_wall_s']:.2f} records/s={g['records_per_s']:.0f}"
            f" ({g['records']} topology records) steps={g['steps']} edges={g['edges']} nodes={g['nodes']}"
            f" holdout mse={g['mse']:.5f} mae={g['mae']:.5f} precision={g['precision']:.4f}"
            f" recall={g['recall']:.4f} f1={g['f1']:.4f} (mean predictor mse {g['mean_predictor_mse']:.5f})"
        )
        print(
            f"trainer[{device}]: gru: fit_wall_s={q['fit_wall_s']:.2f} ({q['sequences']} of the round's"
            f" {q['round_sequences']} sequences, the newest kept) steps={q['steps']}"
            f" ({q['ms_per_step']:.2f} ms a step, the fit's wall over its steps, beside the other legs)"
            f" holdout mse={q['mse']:.5f} mae={q['mae']:.5f} (mean predictor mse"
            f" {q['mean_predictor_mse']:.5f} on {q['holdout']} sequences)"
        )
        for name, leg in out.items():
            if name in ("mlp", "gnn", "gru"):
                check(np.isfinite(leg["mse"]) and leg["mse"] < leg["mean_predictor_mse"],
                      f"the {name} fit does not beat the mean predictor on its holdout")

        out["serve"] = scheduler_leg(device, hosts=hosts, probes=probes, seed=seed, manager=manager, **serve)

        if device.type == "cuda":
            out["card_vs_cpu"] = card_vs_cpu(group, len(blocks), check_blocks, seed)
            out["gru_card_vs_cpu"] = gru_card_vs_cpu(group_seqs, GRU_CHECK_SEQUENCES, config.gru_config, seed)
            window = TRAINER_WORK / "window.dfb"
            per_group = len(group_pairs.labels) * (1 - 1 / eval_every)
            window.write_bytes(group * int(np.ceil(window_superbatches * mlp_batch / per_group)))
            fits = []
            wall_ms, busy_ms = device_busy(lambda: fits.append(stream_train_mlp(
                window, batch_size=mlp_batch, hidden_dims=config.mlp.hidden_dims, device=device)[1]))
            if busy_ms is not None:
                out["window"] = {"superbatches": fits[0].steps, "wall_ms": wall_ms,
                                 "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms}
                print(
                    f"trainer[{device}]: traced window of {fits[0].steps} superbatches: {wall_ms:.1f} ms"
                    f" wall, device busy {busy_ms:.2f} ms (idle share {1 - busy_ms / wall_ms:.4f})"
                )
        return out
    finally:
        shutil.rmtree(TRAINER_WORK, ignore_errors=True)


def card_vs_cpu(group: bytes, per_group: int, blocks: int, seed: int) -> dict:
    """A reduced streamed fit (``blocks`` train blocks of ``group``, which
    holds ``per_group``; one init, float32 staging, 1 worker, 2 passes) on
    the card against the same fit on the CPU: every step's loss and the
    holdout mse within ``FIT_TOL``."""
    path = TRAINER_WORK / "check.dfb"
    path.write_bytes(group * max(1, blocks // per_group))
    init = module_tree(init_mlp(torch.Generator().manual_seed(seed), MLP_DIMS))
    kw = dict(passes=2, batch_size=1024, hidden_dims=tuple(MLP_DIMS[1:-1]), workers=1,
              transfer_dtype=np.float32, init=init)
    _, card = stream_train_mlp(path, device="cuda", **kw)
    _, cpu = stream_train_mlp(path, device="cpu", **kw)
    check((card.steps, card.pairs, card.eval_pairs) == (cpu.steps, cpu.pairs, cpu.eval_pairs),
          "the card's fit saw other pairs than the CPU's")
    a, b = np.asarray(card.losses), np.asarray(cpu.losses)
    loss_err = float(np.max(np.abs(a - b) / np.abs(b)))
    mse_err = abs(card.metrics["mse"] - cpu.metrics["mse"]) / cpu.metrics["mse"]
    print(
        f"trainer: card vs CPU, {card.steps} steps of 1024 from one init: max rel |loss - cpu|"
        f"={loss_err:.3g} holdout mse {card.metrics['mse']:.5f} vs {cpu.metrics['mse']:.5f}"
        f" (rel {mse_err:.3g}; tol {FIT_TOL:g} each)"
    )
    check(loss_err <= FIT_TOL and mse_err <= FIT_TOL, "the card's fit differs from the CPU's")
    return {"steps": card.steps, "loss_rel_err": loss_err, "mse_rel_err": mse_err}


def gru_card_vs_cpu(group_seqs, n: int, fit: FitConfig, seed: int) -> dict:
    """A reduced GRU fit (the first ``n`` sequences of the upload group,
    the round's GRU config but 2 epochs, one init) on the card against the
    same fit on the CPU: each epoch's loss and the holdout mse within
    ``GRU_FIT_TOL``; the card's fit alone is timed for its ms per step."""
    seqs = np.concatenate([q.sequences for q in group_seqs])
    reps = -(-n // len(seqs))
    x = np.tile(seqs, (reps, 1, 1))[:n]
    y = np.tile(np.concatenate([q.labels for q in group_seqs]), reps)[:n]
    ln = np.tile(np.concatenate([q.lengths for q in group_seqs]), reps)[:n]
    init = module_tree(init_gru(torch.Generator().manual_seed(seed), GRU_FEATURE_DIM, fit.hidden_dims[0]))
    cfg = FitConfig(hidden_dims=fit.hidden_dims, batch_size=fit.batch_size, epochs=2, seed=fit.seed, init=init)
    steps = _batch_steps(len(_split_eval(n, cfg.eval_fraction, cfg.seed)[0]), cfg.batch_size)[0] * cfg.epochs
    train_gru(x, y, lengths=ln, config=FitConfig(hidden_dims=fit.hidden_dims, batch_size=fit.batch_size,
                                                 epochs=1, init=init), device="cuda")  # warm-up
    sync(torch.device("cuda"))
    t0 = time.perf_counter()
    card = train_gru(x, y, lengths=ln, config=cfg, device="cuda")
    sync(torch.device("cuda"))
    wall = time.perf_counter() - t0
    cpu = train_gru(x, y, lengths=ln, config=cfg, device="cpu")
    a, b = np.asarray(card.history), np.asarray(cpu.history)
    loss_err = float(np.max(np.abs(a - b) / np.abs(b)))
    mse_err = abs(card.metrics["mse"] - cpu.metrics["mse"]) / cpu.metrics["mse"]
    print(
        f"trainer: gru card vs CPU, {steps} steps of {cfg.batch_size} from one init: max rel"
        f" |loss - cpu|={loss_err:.3g} holdout mse {card.metrics['mse']:.5f} vs {cpu.metrics['mse']:.5f}"
        f" (rel {mse_err:.3g}; tol {GRU_FIT_TOL:g} each); the card's fit alone {wall:.2f}s,"
        f" {wall / steps * 1e3:.2f} ms a step"
    )
    check(loss_err <= GRU_FIT_TOL and mse_err <= GRU_FIT_TOL, "the card's GRU fit differs from the CPU's")
    return {"steps": steps, "loss_rel_err": loss_err, "mse_rel_err": mse_err, "wall_s": wall,
            "ms_per_step": wall / steps * 1e3}


def demand_window(tasks: int, hot: int, now: float, rng: np.random.Generator, **window_kw):
    """A ``DemandWindow`` (its defaults unless ``window_kw`` says otherwise)
    holding ``tasks`` task series over its whole window up to ``now``:
    ``hot`` of them rise bucket by bucket (1 to 2 × the bucket's index),
    the rest stay flat (1 + Poisson(0.5) a bucket) → (window, the hot
    series' task ids)."""
    window = DemandWindow(**window_kw)
    width, t = window.bucket_s, window.window_buckets
    check(tasks <= window.max_tasks, "more tasks than the window holds")
    counts = 1.0 + rng.poisson(0.5, (tasks, t))
    hot_rows = rng.choice(tasks, hot, replace=False)
    counts[hot_rows] = np.round(np.arange(1, t + 1) * rng.uniform(1.0, 2.0, (hot, 1)))
    urls = [f"https://registry.example/v2/app/blobs/sha256:{i:064x}" for i in range(tasks)]
    keys = [task_id_v1(u) for u in urls]
    for i in range(tasks):
        for b in np.flatnonzero(counts[i]):
            window.observe(keys[i], url=urls[i], ts=now - (t - 1 - b) * width, count=float(counts[i, b]))
    return window, {keys[i] for i in hot_rows}


def preheat_leg(
    device, manager, tasks=1024, hot=PREHEAT_HOT, hosts=10_000, probes=16,
    candidates=PREHEAT_CANDIDATES, seed=0, **window_kw,
) -> dict:
    """The preheat plane on ``device``: a ``DemandWindow`` (1,024 tasks ×
    32 buckets of 10 s at its defaults) holding ``hot`` rising series among
    flat ones, and one ``PreheatPlanner`` sweep — the forecaster's first
    fit inline, the GRU forecast of every series, the plan, and one
    ``CreateJob`` into ``manager`` whose seed ranking is
    ``recommend_seeds_by_rtt`` over the serve leg's engine. The hot series
    must be the ones planned and the job must carry their task ids. The
    forecast of every series on ``device`` is then timed and held against
    the plain numpy version (``FORECAST_TOL``). Last, ``recommend_seeds``
    ranks ``candidates`` hosts with the GNN ``manager`` holds (the trainer
    leg's, over the same probe graph), against the same on the CPU."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ids, fed, _, _ = probe_graph(hosts, probes, rng)
    resource, _ = build_swarm(ids, 0, 0, rng)
    eng = fed(device)
    eng.flush(now=PROBED_AT)
    topology = NetworkTopology(KVStore(), resource.host_manager, engine=eng)
    now = PROBED_AT
    window, hot_ids = demand_window(tasks, hot, now, rng, **window_kw)
    forecaster = DemandForecaster(window.window_buckets, device=device, seed=seed)
    planner = preheat_planner.PreheatPlanner(
        window, forecaster, manager_client=manager, topology=topology, cluster_id=1,
        budget_per_sweep=hot, requests=PlainRequests(),
    )
    # the sweep's phases (fit inside forecast, the seed ranking inside plan)
    phases = {name: getattr(preheat_planner, f"PH_{name.upper()}") for name in
              ("forecast", "fit", "plan", "rank", "place")}
    jobs0, phase0 = len(manager.jobs), {name: ph.total_s for name, ph in phases.items()}
    swept = planner.sweep_once(now=now)
    sync(device)
    phase_s = {name: ph.total_s - phase0[name] for name, ph in phases.items()}
    fit_s = phase_s["fit"]
    check(swept["outcome"] == "planned" and forecaster.fits == 1, f"the sweep planned nothing: {swept}")
    check(next(forecaster._model.parameters()).device.type == device.type, "the forecaster is not on the device")
    check(swept["forecast"] == tasks and len(manager.jobs) == jobs0 + 1, f"the sweep sent no job: {swept}")
    job = manager.jobs[-1]
    args = json.loads(job.args_json)
    planned = {spec["task_id"] for spec in args["tasks"]}
    check(job.type == "preheat" and planned == hot_ids, "the job does not carry the hot series")
    seeds = recommend_seeds_by_rtt(eng, k=planner.seed_k)
    check(len(seeds) == planner.seed_k and args["seed_ranking"] == seeds,
          "the job's seed ranking is not the engine's RTT centrality")

    keys, _, series = window.series_batch(now=now)
    scores = forecaster.forecast_demand(series)
    is_hot = np.array([k in hot_ids for k in keys])
    check(scores.shape == (tasks,) and np.isfinite(scores).all(), "forecast shape")
    check(scores[is_hot].min() > scores[~is_hot].max(), "a flat series forecast above a rising one")
    err = float(np.abs(scores - forecaster.forecast_demand_np(series)).max())
    forecast_ms = wall_ms(lambda: forecaster.forecast_demand(series), 10, device)
    plain_ms = wall_ms(lambda: forecaster.forecast_demand_np(series), 3, torch.device("cpu"))
    print(
        f"preheat[{device}]: window {tasks} tasks x {window.window_buckets} buckets of"
        f" {window.bucket_s:g}s ({hot} rising); sweep {swept['seconds'] * 1e3:.1f} ms with the first fit"
        f" inline ({fit_s:.2f}s), planned {swept['planned']} (the rising ones), one CreateJob with"
        f" seeds {[s['host_id'] for s in seeds]}; forecast of {tasks} series forecast_ms={forecast_ms:.2f}"
        f" (numpy {plain_ms:.2f}) max|card - numpy|={err:.3g} (tol {FORECAST_TOL:g}); the sweep's"
        f" phases in s: " + " ".join(f"{name}={t:.3f}" for name, t in phase_s.items())
    )
    check(err <= FORECAST_TOL, "the forecast differs from its numpy version")

    gnn = deserialize_params_auto(manager.created[gnn_model_id_v1(TRAINER_IP, TRAINER_HOST)].weights)
    pool = [ids[i] for i in rng.choice(hosts, candidates, replace=False)]
    t0 = time.perf_counter()
    best = recommend_seeds(topology, gnn, k=3, candidates=pool, device=device)
    sync(device)
    recommend_ms = (time.perf_counter() - t0) * 1e3
    want = recommend_seeds(topology, gnn, k=3, candidates=pool, device="cpu")
    means = [r["mean_predicted_rtt_log_ms"] for r in best]
    check(len(best) == 3 and {r["host_id"] for r in best} <= set(pool) and means == sorted(means),
          f"recommend_seeds: {best}")
    seed_err = max(abs(a - b["mean_predicted_rtt_log_ms"]) for a, b in zip(means, want))
    print(
        f"preheat[{device}]: recommend_seeds over {candidates} candidates with the trained GNN:"
        f" {[r['host_id'] for r in best]} in {recommend_ms:.1f} ms (the embed of {hosts} hosts"
        f" included); max|mean - cpu| at each rank {seed_err:.3g} (tol {GNN_SCORE_TOL:g})"
    )
    check(seed_err <= GNN_SCORE_TOL, "recommend_seeds on the device differs from the CPU's")
    return {
        "tasks": tasks, "buckets": window.window_buckets, "hot": hot, "sweep_ms": swept["seconds"] * 1e3,
        "fit_s": fit_s, "phase_s": phase_s, "planned": swept["planned"], "seeds": [s["host_id"] for s in seeds],
        "forecast_ms": forecast_ms, "forecast_numpy_ms": plain_ms, "forecast_err": err,
        "recommend_ms": recommend_ms, "recommend_err": seed_err,
    }


SERVER_WORK = Path(__file__).resolve().parent / "build" / "server_leg"
SERVER_IP, SERVER_HOST = "10.0.0.3", "scheduler-live"
SERVER_PIECES = 16  # pieces of every task: a seed fetches them, a child reports them
# the daemons' processes: the server's one interpreter is the bound (its
# process at ~100% of a core in a CPU run, each daemon process at ~12%),
# so 4 keep up with it and leave the host's other cores free
SERVER_DAEMON_PROCS = 4


class _ServerRecordingService(ScoringService):
    """The scoring service of a live scheduler: per served call it keeps,
    on the caller's thread, the features and host pairs it scored and what
    it answered (for ``_ServerRecordingEvaluator`` to pick up), and it
    counts the calls each batch launch took."""

    def __init__(self, config=None):
        super().__init__(config)
        self.tls = threading.local()
        self.launches = 0  # batch-loop launches
        self.launch_calls = 0  # calls those launches scored
        self.errors = []  # (monotonic s, what the service raised) per failed call

    def score_wave(self, features, pairs, counts, budget_s=None):
        try:
            out = super().score_wave(features, pairs, counts, budget_s=budget_s)
        except Exception as exc:
            self.errors.append((time.monotonic(), repr(exc)[:200]))
            raise
        self.tls.last = (np.asarray(features, np.float32).copy(), list(pairs or ()), out, self.model_kind())
        return out

    def _score_batch(self, batch, rows):
        self.launches += 1
        self.launch_calls += len(batch)
        return super()._score_batch(batch, rows)


class _ServerRecordingEvaluator(MLEvaluator):
    """The ``ml`` evaluator of a live scheduler, keeping per decision (by
    child peer id) its candidates, the ranking it returned and what the
    scoring service saw and answered for it (None when the decision
    dropped below the serving rung; the evaluator's ``_rung`` is shared by
    every handler thread, so it cannot say this per decision)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.decisions = {}
        self._lock = threading.Lock()

    def evaluate_parents(self, parents, child, total_piece_count):
        svc = self._serving
        if svc is not None:
            svc.tls.last = None
        out = super().evaluate_parents(parents, child, total_piece_count)
        rec = {
            "candidates": [p.id for p in parents],
            "ranked": [p.id for p in out],
            "served": svc.tls.last if svc is not None else None,
        }
        with self._lock:
            self.decisions[child.id] = rec
        return out


def _host_info(cp, ids, i):
    """Host ``i``'s announced info: seeded stats, a location and an idc."""
    return cp.HostInfo(
        id=ids[i], type="super" if i % 50 == 0 else "normal", hostname=ids[i],
        ip=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}", port=65000, download_port=65002,
        concurrent_upload_limit=50,
        cpu=cp.CpuStat(logical_count=32, physical_count=32, percent=float((i * 37) % 100)),
        memory=cp.MemoryStat(total=64 << 30, used_percent=float((i * 11) % 90 + 5)),
        network=cp.NetworkStat(tcp_connection_count=(i * 13) % 2000,
                               upload_tcp_connection_count=(i * 7) % 200,
                               location=f"cn|r{i % 4}|z{i % 8}", idc=f"idc-{i % 16}"),
        disk=cp.DiskStat(used_percent=float((i * 17) % 90 + 5)),
    )


def _daemon_process(conn, threads, hosts, probes, seed, hosts_of, pieces):
    """One process of daemons for the server leg, spawned so that it shares
    neither the server's interpreter lock nor its collector. It answers the
    leg's commands over ``conn``, each a list of jobs run on ``threads``
    client threads, with ``("ok", results in order)`` or ``("error",
    traceback)``: ``("dial", [address])``; ``("announce", host indices)``
    (``AnnounceHost``); ``("probes", [(host, lo, hi, created_at_ns,
    ask)])`` (one ``SyncProbes`` stream: with ``ask`` the targets it is
    named first, then the results of its seeded probes ``lo:hi``);
    ``("peers", [(task, k, host, back_to_source)])`` (one ``AnnouncePeer``
    stream → (peer id, response kind, parent ids, register-sent and
    response ``time.monotonic()``)); ``("stop", None)``. The probe graph
    is redrawn from ``seed`` as the leg drew it; ``hosts_of[t][k]`` is the
    host of task ``t``'s ``k``-th peer."""
    import queue
    import traceback

    from dragonfly2_torch.rpc import glue, protos

    sp, cp = protos.load("scheduler_pb2"), protos.load("common_pb2")
    ids, fed, probed, rtts = probe_graph(hosts, probes, np.random.default_rng(seed))
    coords = fed.coords
    infos = [None] * hosts
    conns = {}

    def info(i):
        if infos[i] is None:
            infos[i] = _host_info(cp, ids, i)
        return infos[i]

    def announce(i):
        conns["client"].AnnounceHost(sp.AnnounceHostRequest(host=info(i)))

    def sync_probes(job):
        i, lo, hi, at_ns, ask = job
        q = queue.Queue()
        responses = conns["client"].SyncProbes(iter(q.get, None))
        named = 0
        if ask:
            q.put(sp.SyncProbesRequest(host=info(i), probe_started=sp.ProbeStartedRequest()))
            named = len(next(responses).hosts)
        q.put(sp.SyncProbesRequest(host=info(i), probe_finished=sp.ProbeFinishedRequest(probes=[
            sp.ProbeResult(host_id=ids[int(j)], rtt_ns=int(r), created_at_ns=at_ns)
            for j, r in zip(probed[i][lo:hi], rtts[i][lo:hi])
        ])))
        q.put(None)
        for _ in responses:
            pass
        return named

    def run_peer(spec):
        t, k, hi, demand = spec
        task_id, peer_id = f"layer-{t:02d}", f"peer-{t:02d}-{k:03d}"
        base = dict(host_id=ids[hi], task_id=task_id, peer_id=peer_id)
        q = queue.Queue()
        stream = conns["client"].AnnouncePeer(iter(q.get, None))
        t_reg = time.monotonic()
        q.put(sp.AnnouncePeerRequest(**base, register_peer=sp.RegisterPeerRequest(
            task_id=task_id, peer_id=peer_id, url=f"https://registry.example/v2/app/blobs/{task_id}",
            need_back_to_source=demand,
        )))
        resp = next(stream)
        t_resp = time.monotonic()
        kind = resp.WhichOneof("response")
        parents = [c.peer_id for c in resp.normal_task.candidate_parents] if kind == "normal_task" else []
        # the pieces come from the head of the ranking; a piece takes
        # longer from a farther or busier parent (the probe graph's
        # latent coordinates), back to source longest
        noise = np.random.default_rng([seed, t, k]).lognormal(0.0, 0.1, pieces)
        src = parents[0] if parents else ""
        cost = np.full(pieces, 40e6) * noise
        if src:
            ph = int(hosts_of[int(src[5:7])][int(src[8:])])  # "peer-TT-KKK"
            rtt_ms = 1.0 + 80.0 * float(np.linalg.norm(coords[hi] - coords[ph]))
            # the parent's load is its announced cpu percent
            cost = (2.0 + 0.25 * rtt_ms + 0.4 * float((ph * 37) % 100)) * 1e6 * noise
        if kind == "normal_task":
            q.put(sp.AnnouncePeerRequest(**base, download_peer_started=sp.DownloadPeerStartedRequest()))
            traffic = "remote_peer"
        else:
            q.put(sp.AnnouncePeerRequest(
                **base, download_peer_back_to_source_started=sp.DownloadPeerBackToSourceStartedRequest()))
            traffic = "back_to_source"
        for n in range(pieces):
            q.put(sp.AnnouncePeerRequest(**base, download_piece_finished=sp.DownloadPieceFinishedRequest(
                piece=cp.PieceInfo(number=n, parent_id=src, offset=n << 22, length=4 << 20,
                                   traffic_type=traffic, cost_ns=int(cost[n]), created_at_ns=time.time_ns()))))
        q.put(sp.AnnouncePeerRequest(**base, download_peer_finished=sp.DownloadPeerFinishedRequest(
            content_length=pieces << 22, piece_count=pieces, cost_ns=int(cost.sum()))))
        q.put(None)
        for _ in stream:
            pass
        return peer_id, kind, parents, t_reg, t_resp

    def dial(address):
        conns["channel"] = glue.dial(address)
        conns["client"] = glue.ServiceClient(conns["channel"], glue.SCHEDULER_SERVICE)

    jobs = {"dial": dial, "announce": announce, "probes": sync_probes, "peers": run_peer}
    try:
        with ThreadPoolExecutor(threads) as pool:
            while True:
                cmd, items = conn.recv()
                if cmd == "stop":
                    break
                try:
                    conn.send(("ok", list(pool.map(jobs[cmd], items))))
                except Exception:
                    conn.send(("error", traceback.format_exc()))
    finally:
        if "channel" in conns:
            conns["channel"].close()
        conn.close()


class _Daemons:
    """``procs`` spawned daemon processes (``_daemon_process``) of
    ``threads`` client threads each. ``map(cmd, items)`` deals the items
    out round-robin, runs them in every process at once and returns the
    results in the items' order."""

    def __init__(self, procs, threads, **graph):
        import multiprocessing

        # spawn, never fork: this process holds a CUDA context
        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        for _ in range(procs):
            here, there = ctx.Pipe()
            proc = ctx.Process(target=_daemon_process, args=(there, threads), kwargs=graph, daemon=True)
            proc.start()
            there.close()
            self.conns.append(here)
            self.procs.append(proc)

    def map(self, cmd, items):
        n = len(self.conns)
        for w, conn in enumerate(self.conns):
            conn.send((cmd, items[w::n]))
        out, errors = [None] * len(items), []
        for w, conn in enumerate(self.conns):
            status, got = conn.recv()
            if status == "ok":
                out[w::n] = got
            else:
                errors.append(got)
        check(not errors, "a daemon process failed:\n" + "\n".join(errors))
        return out

    def close(self):
        for conn in self.conns:
            try:
                conn.send(("stop", None))
            except OSError:
                pass  # that process is gone already
        for proc in self.procs:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join()


def server_leg(
    device, hosts=10_000, probes=16, tasks=40, peers=256, concurrency=64,
    phase2=256, probe_rounds=3, gnn_epochs=60, mlp_batch=512, seed=0,
) -> dict:
    """The port's scheduler and trainer servers on ``device``, live over
    gRPC in this process: a manager stand-in served by the port's
    ``glue.serve``, a ``TrainerServer`` and a ``SchedulerServer``
    (``algorithm="ml"``) wired to it. The daemons' side runs in
    ``SERVER_DAEMON_PROCS`` spawned processes (``_Daemons``), gRPC clients
    speaking raw ``scheduler_pb2`` through the port's ``ServiceClient``,
    ``concurrency`` streams in all; the server's process keeps its
    interpreter and its collector as a deployment has them. ``hosts``
    hosts announce and sync ``probes`` seeded probes each, in
    ``probe_rounds`` rounds with a topology snapshot after each (a
    snapshot keeps each host's 5 newest edges, so the rounds carry the
    whole probe graph to the trainer); phase 1 runs ``tasks`` × ``peers``
    ``AnnouncePeer`` streams (one back-to-source seed per task, then
    children scheduled on earlier peers), scored by a seeded MLP the
    refresher installed; the announcer uploads phase 1's records and the
    probe snapshots to the trainer, which fits MLP, GNN and GRU and sends
    three ``CreateModel``; the refresher installs them; phase 2 runs
    ``phase2`` more children on the trained GNN, the GRU behind bad-node
    detection. Every decision is checked (a legal parent set — peers of
    the child's task registered before its answer — or a legitimate
    back-to-source) and so is the server's side (rung ``serving`` after
    warm-up, order = ``rank_order`` of its card scores), and every served
    call is rescored on the CPU. The server process's cyclic collections
    during traffic are timed (``gc.callbacks``), not changed."""
    import gc
    import inspect

    from dragonfly2_torch.rpc import glue
    from dragonfly2_torch.scheduler import server as sched_server
    from dragonfly2_torch.scheduler import serving as serving_mod
    from dragonfly2_torch.scheduler.server import SchedulerServer, SchedulerServerConfig
    from dragonfly2_torch.trainer.server import TrainerServer, TrainerServerConfig

    pieces = SERVER_PIECES
    # glue.serve's pool: one worker per open AnnouncePeer stream
    workers = inspect.signature(glue.serve).parameters["max_workers"].default
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ids, fed, _, _ = probe_graph(hosts, probes, rng)
    per_task = phase2 // tasks + 1
    hosts_of = [rng.choice(hosts, peers + per_task, replace=False) for _ in range(tasks)]
    # the daemons start first: their imports overlap the servers' build
    procs = min(SERVER_DAEMON_PROCS, concurrency)
    daemons = _Daemons(procs, concurrency // procs, hosts=hosts, probes=probes, seed=seed,
                       hosts_of=[h.tolist() for h in hosts_of], pieces=pieces)
    manager = _Manager()
    mgr_server = srv = trainer = None
    # collector generation → [collections, longest wall ms, total wall ms,
    # longest ms on the collecting thread's clock]: a collection's wall
    # counts the time other threads ran while a finalizer had released
    # the interpreter lock; its thread time is the pause it imposed
    pauses = {}
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = (time.perf_counter(), time.thread_time())
        elif "t" in started:
            t0, c0 = started.pop("t")
            ms, cpu_ms = (time.perf_counter() - t0) * 1e3, (time.thread_time() - c0) * 1e3
            st = pauses.setdefault(info["generation"], [0, 0.0, 0.0, 0.0])
            st[0], st[1], st[2], st[3] = st[0] + 1, max(st[1], ms), st[2] + ms, max(st[3], cpu_ms)

    try:
        shutil.rmtree(SERVER_WORK, ignore_errors=True)
        SERVER_WORK.mkdir(parents=True)
        mgr_server, mgr_addr = manager.served()
        seed_blob = serialize_params(init_mlp(torch.Generator().manual_seed(seed), MLP_DIMS))
        manager.CreateModel(manager.pb2.CreateModelRequest(model_id="mlp-seeded", type="mlp", weights=seed_blob))
        trainer = TrainerServer(TrainerServerConfig(
            data_dir=str(SERVER_WORK / "trainer"), manager_address=mgr_addr, device=str(device),
            telemetry_interval=0, synchronous=False, gnn_epochs=gnn_epochs, mlp_batch_size=mlp_batch,
        ))
        trainer_addr = trainer.serve()
        # the refresher and job worker poll only when asked here, and the
        # probe deltas flush once after each round: the reference's config
        # fields, set for a timed run
        cfg = SchedulerServerConfig(
            data_dir=str(SERVER_WORK / "scheduler"), hostname=SERVER_HOST, advertise_ip=SERVER_IP,
            manager_address=mgr_addr, trainer_address=trainer_addr, algorithm="ml", device=str(device),
            telemetry_interval=0, model_refresh_interval=3600.0, job_poll_interval=3600.0,
            topology_flush_threshold=hosts * probes + 1,
        )
        # the server builds its evaluator and scoring service from these names
        built = (sched_server.MLEvaluator, serving_mod.ScoringService)
        sched_server.MLEvaluator, serving_mod.ScoringService = _ServerRecordingEvaluator, _ServerRecordingService
        try:
            srv = SchedulerServer(cfg)
        finally:
            sched_server.MLEvaluator, serving_mod.ScoringService = built
        evaluator, service = srv.evaluator, srv.scoring_service
        check(isinstance(evaluator, _ServerRecordingEvaluator) and isinstance(service, _ServerRecordingService),
              "the server did not build the recording evaluator and service")
        addr = srv.serve()
        out = {"daemon_procs": procs}
        check(srv.model_refresher.loaded_version == ("mlp-seeded", 1), "the seeded MLP is not installed")
        check(service.model_kind() == "mlp", "the seeded MLP does not hold the serving slot")
        check(srv.topology_engine.device.type == device.type, "the topology engine is not on the device")
        daemons.map("dial", [addr] * procs)
        gc.callbacks.append(on_gc)

        t0 = time.perf_counter()
        daemons.map("announce", list(range(hosts)))
        announce_s = time.perf_counter() - t0
        check(len(srv.resource.host_manager.all()) == hosts, "hosts lost in AnnounceHost")

        topology_rows, named, probe_s, snapshot_s = 0, [], 0.0, 0.0
        bounds = np.linspace(0, probes, probe_rounds + 1).astype(int)
        for r, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            # a round's probes are stamped a second apart, oldest first; a
            # later round re-probes the next slice of a host's peers and
            # reports only
            at_ns = time.time_ns() - (probe_rounds - r) * 10**9
            t0 = time.perf_counter()
            named += daemons.map("probes", [(i, int(lo), int(hi), at_ns, r == 0) for i in range(hosts)])
            srv.topology_engine.flush()
            sync(device)
            t1 = time.perf_counter()
            topology_rows += srv.networktopology.snapshot()
            probe_s, snapshot_s = probe_s + t1 - t0, snapshot_s + time.perf_counter() - t1
        stats = srv.topology_engine.stats()
        check(stats["edges"] == hosts * probes, f"edges lost in SyncProbes: {stats['edges']}")
        check(all(0 < n <= 5 for n in named[:hosts]), "SyncProbes named no probe targets")
        out.update(announce_host_per_s=hosts / announce_s, announce_s=announce_s, probe_ingest_s=probe_s,
                   snapshot_s=snapshot_s, edges=stats["edges"], topology_rows=topology_rows)
        print(
            f"server[{device}]: {hosts} hosts announced in {announce_s:.2f}s"
            f" ({out['announce_host_per_s']:.0f}/s) by {procs} daemon processes; {stats['edges']} probes"
            f" through SyncProbes in {probe_rounds} rounds, each with one engine flush, in {probe_s:.2f}s;"
            f" {topology_rows} topology rows in {probe_rounds} snapshots ({snapshot_s:.2f}s)"
        )

        seen = {}  # peer id → (response kind, parent ids, register-sent s, response s)

        def run(specs):
            got = daemons.map("peers", specs)
            for pid, kind, parents, t_reg, t_resp in got:
                seen[pid] = (kind, parents, t_reg, t_resp)
            return [g[0] for g in got]

        def decide_ms(pid):
            return (seen[pid][3] - seen[pid][2]) * 1e3

        seeds = [(t, 0, int(hosts_of[t][0]), True) for t in range(tasks)]
        children = [(t, k, int(hosts_of[t][k]), False) for k in range(1, peers) for t in range(tasks)]
        later = [(t, peers + k, int(hosts_of[t][peers + k]), False)
                 for k in range(per_task) for t in range(tasks)][:phase2]

        def check_decisions(pids, phase, warm):
            """The client's and the server's view of each decision → the
            decide_ms of those after the warm-up, and how many were served.
            A decision after the warm-up that the scoring service did not
            answer is a demotion; all of them are listed, then fail."""
            name = f"server[{device}] {phase}"
            walls, served, demoted = [], 0, []
            for n, pid in enumerate(pids):
                kind, parents, _, t_resp = seen[pid]
                rec = evaluator.decisions.get(pid)
                check(kind in ("normal_task", "need_back_to_source"), f"{name}: {pid} got {kind}")
                if kind == "need_back_to_source":
                    # legitimate: the peer demanded it, or no candidate
                    # survived the filter in any retry
                    check(srv.resource.peer_manager.load(pid).need_back_to_source or rec is None,
                          f"{name}: {pid} sent back to source with parents ranked")
                    continue
                # legal: peers of the same task whose register was sent
                # before this answer came back (one clock for every
                # process), not the child, none blocklisted (the daemons
                # block no parent here)
                check(parents and pid not in parents
                      and all(p[:8] == pid[:8] and p in seen and seen[p][2] < t_resp for p in parents),
                      f"{name}: {pid} got parents that are no legal candidates: {parents}")
                check(rec is not None and parents == rec["ranked"][: len(parents)],
                      f"{name}: {pid}'s parents are not the head of its ranking")
                if n < warm:
                    continue
                walls.append(decide_ms(pid))
                if rec["served"] is None:
                    demoted.append(pid)
                    continue
                _, _, scored, _ = rec["served"]
                scores, ranking = scored[0]
                check(np.isfinite(scores).all() and len(scores) == len(rec["candidates"]), f"{name}: scores")
                check(np.array_equal(ranking, wave.rank_order(scores, np.zeros(len(scores)))),
                      f"{name}: {pid}'s ranking is not rank_order of its scores")
                check([rec["candidates"][int(j)] for j in ranking] == rec["ranked"],
                      f"{name}: {pid}'s order is not its ranking")
                served += 1
            if demoted:
                print(f"{name}: {len(demoted)} decisions demoted below the serving rung, e.g."
                      f" {demoted[:5]}; the service raised: {service.errors[:5]}; the server's"
                      f" collections so far (generation: count, longest wall ms, total wall ms,"
                      f" longest thread ms): {pauses}")
            check(not demoted, f"{name}: {len(demoted)} decisions demoted after the warm-up")
            return walls, served

        def phase_stats(walls, wall_s, decisions, served, launches0, phase):
            launches = service.launches - launches0[0]
            calls = service.launch_calls - launches0[1]
            st = {
                "decisions": decisions, "served": served, "wall_s": wall_s,
                "decisions_per_s": decisions / wall_s,
                "decide_ms_p50": float(np.percentile(walls, 50)), "decide_ms_p99": float(np.percentile(walls, 99)),
                "launches": launches, "calls_per_launch": calls / launches if launches else 0.0,
            }
            print(
                f"server[{device}] {phase}: {decisions} decisions in {wall_s:.2f}s"
                f" ({st['decisions_per_s']:.1f}/s) at {concurrency} streams on the server's"
                f" {workers} gRPC workers; decide_ms p50={st['decide_ms_p50']:.2f}"
                f" p99={st['decide_ms_p99']:.2f} over {len(walls)} after the warm-up (register sent →"
                f" response); {served} served; {launches} scoring launches, {st['calls_per_launch']:.2f}"
                f" calls each"
            )
            return st

        # phase 1: the seeds go back to source, then the children
        t0 = time.perf_counter()
        run(seeds)
        check(all(seen[f"peer-{t:02d}-000"][0] == "need_back_to_source" for t in range(tasks)),
              "a seed peer was not sent back to source")
        l0 = (service.launches, service.launch_calls)
        warm = concurrency
        done = run(children[:warm])
        traced = children[warm : warm + 4 * concurrency]
        if device.type == "cuda":
            wall_ms, busy_ms = device_busy(lambda: done.extend(run(traced)))
            check(busy_ms is not None, f"server[{device}]: the traced decisions ran nothing on the card")
            out.update(traced_decisions=len(traced), traced_wall_ms=wall_ms, device_busy_ms=busy_ms,
                       device_idle_share=1 - busy_ms / wall_ms)
            print(
                f"server[{device}]: traced {len(traced)} decisions of phase 1: {wall_ms:.1f} ms wall,"
                f" device busy {busy_ms:.2f} ms (idle share {out['device_idle_share']:.4f})"
            )
        else:
            done.extend(run(traced))
        done.extend(run(children[warm + len(traced) :]))
        phase1_s = time.perf_counter() - t0
        walls, served = check_decisions(done, "phase 1", warm)
        out["phase1"] = phase_stats(walls, phase1_s, len(done) + tasks, served, l0, "phase 1")
        out["phase1"]["warmup_decide_ms_max"] = max(decide_ms(p) for p in done[:warm])
        check(service.model_kind() == "mlp", "phase 1 was not served by the MLP")

        # upload → fits → CreateModel × 3 → install
        uploads0 = manager.calls.get("CreateModel", 0)
        srv.storage.flush()
        records = Path(cfg.data_dir) / "records"
        blocks = sorted((records / "blocks").glob("download*.dfb"))
        labels = np.concatenate([wire.read_train_pairs(p).labels for p in blocks])
        gru_labels = np.concatenate([q.labels for p in blocks for q in wire.stream_gru_sequences(p)])
        upload_bytes = sum(p.stat().st_size for p in (records / "blocks").glob("*.dfb"))
        t0 = time.perf_counter()
        check(srv.announcer.train_once(), "the announcer uploaded nothing")
        upload_s = time.perf_counter() - t0
        deadline = time.time() + 900
        while manager.calls.get("CreateModel", 0) < uploads0 + 3 and time.time() < deadline:
            time.sleep(0.05)
        round_s = time.perf_counter() - t0
        check(manager.calls.get("CreateModel", 0) == uploads0 + 3, "the trainer sent no three CreateModel")
        ups = {t: manager.created[f(SERVER_IP, SERVER_HOST)] for t, f in
               (("mlp", mlp_model_id_v1), ("gnn", gnn_model_id_v1), ("gru", gru_model_id_v1))}
        graph = build_probe_graph(records_to_columns(srv.networktopology.export_records()))
        _, eval_idx = _split_eval(len(graph.edge_src), GNNFitConfig.eval_fraction, GNNFitConfig.seed)
        # the GNN's holdout is the trainer's own split of the same graph;
        # the MLP's and the GRU's mean predictors are over all their labels
        means = {"mlp": mean_mse(labels), "gnn": mean_mse(graph.edge_rtt_log_ms[eval_idx]),
                 "gru": mean_mse(gru_labels)}
        for t, up in ups.items():
            check(up.type == t, f"the {t} upload has type {up.type}")
            print(f"server[{device}]: trained {t}: holdout mse={up.evaluation.mse:.5f}"
                  f" (mean predictor {means[t]:.5f})")
            check(np.isfinite(up.evaluation.mse) and up.evaluation.mse < means[t],
                  f"the {t} fit does not beat the mean predictor")
        t0 = time.perf_counter()
        check(srv.model_refresher.refresh_once(), "the refresher installed nothing")
        sync(device)
        install_ms = (time.perf_counter() - t0) * 1e3
        r = srv.model_refresher
        for t, got in (("mlp", r.loaded_version), ("gnn", r.loaded_gnn_version), ("gru", r.loaded_gru_version)):
            want = (ups[t].model_id, manager.versions[ups[t].model_id])
            check(got == want, f"the refresher loaded {t} {got}, not the upload {want}")
        check(service.model_kind() == "gnn", "the trained GNN does not hold the serving slot")
        out.update(upload_mib=upload_bytes / 2**20, upload_s=upload_s, round_s=round_s, install_ms=install_ms,
                   download_pairs=len(labels),
                   mse={t: ups[t].evaluation.mse for t in ups}, mean_predictor_mse=means)
        print(
            f"server[{device}]: announcer → TrainerServer over gRPC: {out['upload_mib']:.2f} MiB of blocks"
            f" ({len(labels)} pairs, {topology_rows} topology rows) streamed in {upload_s:.2f}s;"
            f" round_s={round_s:.1f} (upload → three CreateModel); install_ms={install_ms:.1f}"
        )

        # phase 2: more children, on the trained GNN with the GRU filter
        l0 = (service.launches, service.launch_calls)
        t0 = time.perf_counter()
        done2 = run(later)
        phase2_s = time.perf_counter() - t0
        warm2 = min(concurrency, len(done2) // 4)
        walls, served = check_decisions(done2, "phase 2", warm2)
        out["phase2"] = phase_stats(walls, phase2_s, len(done2), served, l0, "phase 2")
        out["phase2"]["warmup_decide_ms_max"] = max(decide_ms(p) for p in done2[:warm2])
        check(service.model_kind() == "gnn", "phase 2 was not served by the GNN")
        check(len(evaluator._gru_verdicts) > 0, "is_bad_node never took the GRU branch")

        # every served call rescored on the CPU
        cpu = {"seeded": MLPScorer(deserialize_params_auto(seed_blob), device="cpu"),
               "trained": MLPScorer(deserialize_params_auto(ups["mlp"].weights), device="cpu"),
               "gnn": GNNScorer(deserialize_params_auto(ups["gnn"].weights), graph, device="cpu")}
        errs = {"mlp": 0.0, "gnn": 0.0}
        phase1 = set(done)
        for pid in done + done2:
            rec = evaluator.decisions.get(pid)
            if rec is None or rec["served"] is None:
                continue
            feats, pairs, scored, kind = rec["served"]
            if kind == "mlp":
                want = cpu["seeded" if pid in phase1 else "trained"].predict(feats)
            else:
                want = cpu["gnn"].predict_rtt_log_ms([a for a, _ in pairs], [b for _, b in pairs])
            errs[kind] = max(errs[kind], float(np.abs(scored[0][0] - want).max()))
        print(
            f"server[{device}]: served scores against the CPU: max|mlp - cpu|={errs['mlp']:.3g}"
            f" (tol {SCORE_TOL:g}) max|gnn - cpu|={errs['gnn']:.3g} (tol {GNN_SCORE_TOL:g})"
        )
        check(errs["mlp"] <= SCORE_TOL, "served MLP scores differ from the CPU")
        check(errs["gnn"] <= GNN_SCORE_TOL, "served GNN scores differ from the CPU")
        out.update(score_err=errs, gru_verdicts=len(evaluator._gru_verdicts),
                   gc_pauses={g: {"collections": c, "longest_ms": m, "total_ms": s, "longest_thread_ms": t}
                              for g, (c, m, s, t) in sorted(pauses.items())})
        print(f"server[{device}]: the server process's collections from the announces on"
              f" (generation: count, longest wall ms, total wall ms, longest thread ms): "
              + "; ".join(f"{g}: {c}, {m:.1f}, {s:.1f}, {t:.1f}" for g, (c, m, s, t) in sorted(pauses.items())))
        return out
    finally:
        if on_gc in gc.callbacks:
            gc.callbacks.remove(on_gc)
        daemons.close()
        if srv is not None:
            srv.stop()
        if trainer is not None:
            trainer.stop()
        if mgr_server is not None:
            mgr_server.stop(0)
        shutil.rmtree(SERVER_WORK, ignore_errors=True)


def encoder_inputs(batch: int, seq: int, in_dim: int, seed: int) -> torch.Tensor:
    """Seeded piece histories [B, T, F]: a piece's log cost and its position."""
    rng = np.random.default_rng(seed)
    x = np.zeros((batch, seq, in_dim), np.float32)
    x[..., 0] = np.log1p(rng.lognormal(np.log(40.0), 0.8, (batch, seq)))  # piece cost
    x[..., 1] = (np.arange(seq) + 1) / seq  # piece position
    return torch.from_numpy(x)


def encoder_leg(
    device, batch=ENCODER_BT[0], seq=ENCODER_BT[1], cfg=ENCODER, seed=0, dtype=torch.bfloat16
) -> dict:
    """The encoder forward with flash attention in ``dtype``, against
    ``local_attention`` on the same weights; on the card every layer must
    launch the kernel ``flash.kernel_for`` names, and no other."""
    device = torch.device(device)
    enc = init_transformer(torch.Generator().manual_seed(seed), **cfg)
    enc = enc.to(device).requires_grad_(False)
    x = encoder_inputs(batch, seq, cfg["in_dim"], seed).to(device)

    def flash_causal(q, k, v):
        return flash.flash_attention(q, k, v, causal=True)

    def forward():
        with torch.no_grad():
            return apply_transformer(enc, x, attention_fn=flash_causal, compute_dtype=dtype)

    flash.reset_launches()
    out = forward()
    sync(device)
    launches = dict(flash.LAUNCHES_BY)
    taken = flash.kernel_for(dtype, cfg["model_dim"] // cfg["num_heads"])
    expected = {kern: 0 for kern in launches}
    if device.type == "cuda":
        expected[taken] = cfg["num_layers"]
    check(launches == expected, f"flash launches {launches}, expected {expected}")
    with torch.no_grad():
        ref = apply_transformer(enc, x, causal=True, compute_dtype=dtype)
    err = (out - ref).abs().max().item()
    tol = ENCODER_TOL[dtype]
    name = f"encoder[{device}, {str(dtype)[6:]}]"
    print(f"{name}: B={batch} T={seq} out={tuple(out.shape)} launches={launches}"
          f" max|flash - local|={err:.3g} (tol {tol:g})")
    check(out.shape == (batch, seq, cfg["model_dim"]), "encoder output shape")
    check(torch.isfinite(out).all().item(), "encoder output not finite")
    check(err <= tol, "encoder with flash differs from local_attention")
    fwd_ms = wall_ms(forward, 3, device)
    local_ms = wall_ms(
        lambda: apply_transformer(enc, x, causal=True, compute_dtype=dtype), 3, device
    )
    print(f"{name}: forward_ms={fwd_ms:.2f} (with local_attention {local_ms:.2f})")
    return {
        "kernel": taken,
        "launches": launches[taken],
        "launches_by": launches,
        "err": err,
        "forward_ms": fwd_ms,
        "local_forward_ms": local_ms,
    }


def encoder_grad_leg(
    device, batch=ENCODER_BT[0], seq=ENCODER_BT[1], cfg=ENCODER, seed=0, dtype=torch.bfloat16
) -> dict:
    """The encoder trained through the flash kernels: ``apply_transformer``
    with Ulysses attention (``use_kernel``) over an sp = 1 process group
    (NCCL on the card, gloo on the CPU), a seeded loss, ``backward()``. On
    the card every layer must launch its forward kernel and the backward
    kernel once, and nothing else; every parameter's gradient is held
    against the same step with ``local_attention`` under autograd."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1
    )
    try:
        mesh = make_mesh(sp=1)
        ulysses = make_ulysses_attention(mesh, "sp", causal=True, use_kernel=True)
        enc = init_transformer(torch.Generator().manual_seed(seed), **cfg).to(device)
        x = encoder_inputs(batch, seq, cfg["in_dim"], seed).to(device)
        w = torch.randn(
            (batch, seq, cfg["model_dim"]), generator=torch.Generator().manual_seed(seed + 1)
        ).to(device)

        def step(attention_fn):
            enc.zero_grad(set_to_none=True)
            out = apply_transformer(enc, x, attention_fn=attention_fn, causal=True, compute_dtype=dtype)
            ((out * w).sum() / out.numel()).backward()
            return out

        flash.reset_launches()
        out = step(ulysses)
        sync(device)
        launches = dict(flash.LAUNCHES_BY)
        grads = {n: p.grad.clone() for n, p in enc.named_parameters() if p.grad is not None}
        expected = {kern: 0 for kern in launches}
        if device.type == "cuda":
            head_dim = cfg["model_dim"] // cfg["num_heads"]
            expected[flash.kernel_for(dtype, head_dim)] = cfg["num_layers"]
            expected[flash.bwd_kernel_for(dtype, head_dim)] = cfg["num_layers"]
        check(launches == expected, f"flash launches {launches}, expected {expected}")
        check(out.shape == (batch, seq, cfg["model_dim"]) and torch.isfinite(out).all().item(),
              "encoder output shape or finiteness")
        check(all(torch.isfinite(g).all().item() for g in grads.values()), "a gradient is not finite")
        step(None)
        ref = {n: p.grad for n, p in enc.named_parameters() if p.grad is not None}
        check(grads.keys() == ref.keys(), "flash and local_attention train different parameters")
        errs = {n: ((grads[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)).item() for n in ref}
        qk = [n for n in errs if n.endswith((".wq", ".wk"))]
        worst = max(errs[n] for n in errs if n not in qk)
        worst_qk = max(errs[n] for n in qk)
        tol, tol_qk = ENCODER_GRAD_TOL[dtype], ENCODER_GRAD_QK_TOL[dtype]
        name = f"encoder_grad[{device}, {str(dtype)[6:]}]"
        print(
            f"{name}: B={batch} T={seq} launches={launches}; ||g_flash - g_local||/||g_local||:"
            f" worst {worst:.3g} (tol {tol:g}), wq/wk worst {worst_qk:.3g} (tol {tol_qk:g}); "
            + " ".join(f"{n}={e:.3g}" for n, e in errs.items() if n.startswith("layers.0.") or n == "embed")
        )
        check(worst <= tol and worst_qk <= tol_qk, f"{name}: gradients differ from local_attention's")

        result = {
            "kernel": flash.kernel_for(dtype, cfg["model_dim"] // cfg["num_heads"]),
            "launches_by": launches,
            "grad_rel_err": worst,
            "grad_rel_err_qk": worst_qk,
            "fwd_bwd_ms": wall_ms(lambda: step(ulysses), 3, device),
            "local_fwd_bwd_ms": wall_ms(lambda: step(None), 3, device),
        }
        if device.type == "cuda":
            for key, fn in (("peak_gib", ulysses), ("local_peak_gib", None)):
                enc.zero_grad(set_to_none=True)
                torch.cuda.reset_peak_memory_stats(device)
                step(fn)
                sync(device)
                result[key] = torch.cuda.max_memory_allocated(device) / 2**30
        print(
            f"{name}: fwd_bwd_ms={result['fwd_bwd_ms']:.2f} (with local_attention"
            f" {result['local_fwd_bwd_ms']:.2f}); peak memory"
            f" {result.get('peak_gib', float('nan')):.3f} GiB (with local_attention"
            f" {result.get('local_peak_gib', float('nan')):.3f} GiB)"
        )
        return result
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    walls = {}  # phase → its host wall in s

    def leg(name, fn, *args, attention=False, **kw):
        """One phase, timed; a leg with no attention launches no flash kernel."""
        flash.reset_launches()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[name] = time.perf_counter() - t0
        print(f"chip_smoke: {name} took {walls[name]:.1f} s")
        check(attention or flash.LAUNCHES == 0, f"the {name} leg runs no attention")
        return out

    leg("build", build_kernels, attention=True)
    prepass_ms = leg("prepass", prepass_phase, attention=True)
    rows = leg("flash", flash_phase, attention=True)
    bwd_rows = leg("bwd", bwd_phase, attention=True)

    serve = leg("serve", serve_leg, "cuda")
    scheduler = leg("scheduler", scheduler_leg, "cuda")
    manager = _Manager()
    # the server leg's cluster cannot be cut, so the trainer leg is: its
    # upload at 1 file of 100 MiB (11 before the server leg) and its GRU
    # at the newest 10,000 sequences (40,000)
    trainer = leg("trainer", trainer_leg, "cuda", manager=manager, files=1, gru_max_sequences=10_000)
    preheat = leg("preheat", preheat_leg, "cuda", manager)
    server = leg("server", server_leg, "cuda")
    encoders = {
        kern: leg(f"encoder_{kern}", encoder_leg, "cuda", dtype=dtype, attention=True)
        for kern, dtype in (("sm90", torch.bfloat16), ("tf32x3", torch.float32))
    }
    for kern, out in encoders.items():
        check(out["kernel"] == kern, f"the {out['kernel']} kernel took the {kern} leg")
    grad_legs = {
        name: leg(f"encoder_grad_{name}", encoder_grad_leg, "cuda", dtype=dtype, attention=True)
        for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32))
    }

    print(json.dumps({
        "serve": serve,
        "scheduler": scheduler,
        "trainer": trainer,
        "preheat": preheat,
        "server": server,
        "encoder": encoders,
        "encoder_grad": grad_legs,
        "tf32x3_d8_bf16": rows["tf32x3_d8_bf16"],
        "tf32x3_prepass_ms": prepass_ms,
        "walls_s": walls,
    }))
    kernels = [
        {
            "name": KERNEL_NAMES[kern],
            "route": "cuda",
            "source": f"dragonfly2_torch/csrc/{KERNEL_NAMES[kern]}.cu",
            "replaces": "dragonfly2_tpu/ops/flash.py:133",
            "launches": encoders[kern]["launches"],
            **{key: rows[kern][key] for key in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        for kern in ("sm90", "tf32x3")
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": f"dragonfly2_torch/csrc/{KERNEL_NAMES[kern]}.cu",
            "replaces": "dragonfly2_tpu/ops/flash.py:185",
            "launches": grad_legs[leg]["launches_by"][kern],
            **{key: bwd_rows[row][key] for key in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        # flash_bwd[bfloat16] is flash_bwd's bf16 D = 8 role, timed at the
        # encoder's shape for the comparison: the path launches it no time
        for name, kern, leg, row in (
            ("flash_bwd_sm90", "bwd_sm90", "bfloat16", "bwd_sm90"),
            ("flash_bwd[float32]", "bwd", "float32", "bwd_float32"),
            ("flash_bwd[bfloat16]", "bwd", "bfloat16", "bwd_bfloat16"),
        )
    ]
    for source in {k["source"] for k in kernels}:
        check(sum(k["launches"] for k in kernels if k["source"] == source) > 0,
              f"{source}: a kernel of the path was never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
