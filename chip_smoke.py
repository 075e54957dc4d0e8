#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dragonfly2_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. device and build: the card's name and power limit, then both flash
   kernels' CUDA sources built with ``nvcc`` at once (each timed), with
   ``ptxas``'s registers, spills and added wgmma fences per
   instantiation and, where
   ``cuobjdump`` sits beside ``nvcc``, the count of HGMMA (wgmma)
   instructions in each library's SASS (0 fails);
2. the tf32x3 kernel's pre-pass against its plain split, bit for bit (and
   timed alone at the encoder's shape); each flash kernel against the
   plain PyTorch version at every checked shape, with max|err| of O and
   LSE and the share of each limit used; at the
   encoder's shape (float32 → tf32x3, bfloat16 → sm90) and at D = 8 in
   bfloat16 (tf32x3's other role) the kernel, SDPA and the plain version
   are timed in turns beside the card's bound for the same work, and the
   CUDA kernels SDPA runs are named from a profiler trace;
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
5. encoder leg at full width: the piece-sequence transformer (model_dim
   256, 4 heads, 4 layers) on B = 2, T = 8192 with flash attention, against
   the plain ``local_attention``: once in bfloat16, which must launch
   ``flash_fwd_sm90`` once per layer and ``flash_fwd_tf32x3`` never, and
   once in float32, which must launch ``flash_fwd_tf32x3`` once per layer
   and ``flash_fwd_sm90`` never.

The line before the last holds the kernels' table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. Weights and data are random, made from seeds.
"""

from __future__ import annotations

import json
import random
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dragonfly2_torch import _build
from dragonfly2_torch.models.attention import apply_transformer, init_transformer
from dragonfly2_torch.models.mlp import init_mlp
from dragonfly2_torch.ops import flash
from dragonfly2_torch.schema.features import GRU_FEATURE_DIM, MLP_FEATURE_DIM
from dragonfly2_torch.scheduler import metrics as scheduler_metrics
from dragonfly2_torch.scheduler import resource as res
from dragonfly2_torch.scheduler import wave
from dragonfly2_torch.scheduler.evaluator import MLEvaluator
from dragonfly2_torch.scheduler.model_refresher import ModelRefresher, PlainRequests
from dragonfly2_torch.scheduler.scheduling import Scheduling
from dragonfly2_torch.scheduler.serving import ScoringService
from dragonfly2_torch.topology import TopologyConfig, TopologyEngine
from dragonfly2_torch.trainer.serving import (
    MLPScorer,
    deserialize_params_auto,
    serialize_params,
)
from dragonfly2_torch.utils import flight

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
KERNEL_NAMES = {"sm90": "flash_fwd_sm90", "tf32x3": "flash_fwd_tf32x3"}
MLP_DIMS = [MLP_FEATURE_DIM, 128, 128, 1]  # the trainer's default MLP
# bfloat16 products on the card against float32 on the CPU
SCORE_TOL = 2e-2


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
    """Both libraries built at once, each timed, with ptxas's report per
    instantiation and the wgmma count of each library's SASS."""

    def timed_load(name):
        t0 = time.perf_counter()
        _build.load(name)
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_NAMES)) as pool:
        for name, secs in pool.map(timed_load, KERNEL_NAMES.values()):
            print(f"build: {name} in {secs:.1f}s")
    for name in KERNEL_NAMES.values():
        for fn, regs, spills, fences in ptxas_report(_build.build_log(name)):
            print(f"  {name} {fn}: {regs} registers, {spills}, {fences} wgmma fences added by ptxas")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.exists():
        print(f"  {cuobjdump} not found: HGMMA instructions not counted")
        return
    for name in KERNEL_NAMES.values():
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


PROBED_AT = 1_000_000.0  # the engines' clock: probes land a minute before


def probe_graph(hosts: int, probes: int, rng: np.random.Generator):
    """Probe measurements drawn from ``rng``: each host probes ``probes``
    distinct other hosts, RTTs log-normal around 20 ms → (host ids, a
    function that feeds them into a new engine on a device)."""
    ids = [f"host-{i:05d}" for i in range(hosts)]
    peers = np.stack([rng.choice(hosts - 1, probes, replace=False) for _ in range(hosts)])
    peers += peers >= np.arange(hosts)[:, None]  # distinct peers, no self probe
    rtts = rng.lognormal(np.log(20e6), 0.6, (hosts, probes)).astype(np.int64)
    cfg = TopologyConfig(flush_threshold=10**9, max_pending=hosts * probes + 1)

    def fed(dev):
        eng = TopologyEngine(cfg, device=dev)
        for i in range(hosts):
            for j, rtt in zip(peers[i], rtts[i]):
                eng.enqueue(ids[i], ids[int(j)], int(rtt), created_at=PROBED_AT - 60.0)
        return eng

    return ids, fed


def serve_leg(device, hosts=10_000, probes=16, waves=(256, 15), repeats=20, seed=0) -> dict:
    """Topology flush + wave join + ranked MLP scoring on ``device``, held
    against the same port on the CPU."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ids, fed = probe_graph(hosts, probes, rng)
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
    """In-process stand-in for the manager's model registry: one active MLP
    whose weights are ``blob`` (npz bytes)."""

    def __init__(self, blob: bytes):
        self.model = _Model("mlp-smoke", "mlp", 1, "active", 1, 1)
        self.blob = blob

    def ListModels(self, request):
        return SimpleNamespace(models=[self.model])

    def GetModelWeights(self, request):
        check((request.model_id, request.version) == ("mlp-smoke", 1), "unknown model asked for")
        return SimpleNamespace(weights=self.blob)


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


def scheduler_leg(
    device, hosts=10_000, probes=16, tasks=40, peers=256, wave_size=256, waves=20, warmup=2, seed=0
) -> dict:
    """The scheduler's ``ml`` decision path on ``device``: a model installed
    by the refresher, then ``warmup`` + ``waves`` waves of ``wave_size``
    running children through ``Scheduling.find_candidate_parents_wave``.
    Each checked wave must be scored by the service (rung ``serving``, one
    service wave, no demotion, no fallback) and rank every decision by
    ``rank_order`` of its scores; on the card the same waves then run on
    the CPU and must give the same candidate sets and scores within
    ``SCORE_TOL``."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ids, fed = probe_graph(hosts, probes, rng)
    resource, running = build_swarm(ids, tasks, peers, rng)
    children = [
        [running[i] for i in rng.choice(len(running), wave_size, replace=False)]
        for _ in range(warmup + waves)
    ]
    blob = serialize_params(init_mlp(torch.Generator().manual_seed(seed), MLP_DIMS))

    def run(dev):
        """The leg's waves on ``dev`` → per checked wave (candidate ids per
        decision, features, per-decision (scores, ranking)), and times."""
        eng = fed(dev)
        eng.flush(now=PROBED_AT)
        service = _RecordingService()
        service.start()
        try:
            evaluator = _RecordingEvaluator(topology=eng, serving=service)
            refresher = ModelRefresher(
                _Manager(blob), evaluator, serving=service, device=dev, requests=PlainRequests()
            )
            t0 = time.perf_counter()
            check(refresher.refresh_once(), "the refresher installed no model")
            install_ms = (time.perf_counter() - t0) * 1e3
            check(service.model_kind() == "mlp" and evaluator._model is not None, "model not installed")
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
            times = {
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
        print(
            f"scheduler: candidate sets equal the CPU run's in {waves} waves;"
            f" max|rtt_affinity - cpu|={rtt_err:.3g} (tol 1e-5)"
            f" max|score(bf16) - cpu(f32)|={score_err:.3g} (tol {SCORE_TOL:g})"
        )
        check(rtt_err <= 1e-5, "rtt_affinity differs from the CPU engine")
        check(score_err <= SCORE_TOL, "scores differ from the CPU run")
        out.update(rtt_err=rtt_err, score_err=score_err)
    return out


def encoder_leg(
    device, batch=ENCODER_BT[0], seq=ENCODER_BT[1], cfg=ENCODER, seed=0, dtype=torch.bfloat16
) -> dict:
    """The encoder forward with flash attention in ``dtype``, against
    ``local_attention`` on the same weights; on the card every layer must
    launch the kernel ``flash.kernel_for`` names, and no other."""
    device = torch.device(device)
    enc = init_transformer(torch.Generator().manual_seed(seed), **cfg)
    enc = enc.to(device).requires_grad_(False)
    rng = np.random.default_rng(seed)
    x = np.zeros((batch, seq, cfg["in_dim"]), np.float32)
    x[..., 0] = np.log1p(rng.lognormal(np.log(40.0), 0.8, (batch, seq)))  # piece cost
    x[..., 1] = (np.arange(seq) + 1) / seq  # piece position
    x = torch.from_numpy(x).to(device)

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

    build_kernels()
    prepass_ms = prepass_phase()
    rows = flash_phase()

    flash.reset_launches()
    serve = serve_leg("cuda")
    check(flash.LAUNCHES == 0, "the serve leg runs no attention")
    flash.reset_launches()
    scheduler = scheduler_leg("cuda")
    check(flash.LAUNCHES == 0, "the scheduler leg runs no attention")
    encoders = {
        kern: encoder_leg("cuda", dtype=dtype)
        for kern, dtype in (("sm90", torch.bfloat16), ("tf32x3", torch.float32))
    }
    for kern, leg in encoders.items():
        check(leg["kernel"] == kern, f"the {leg['kernel']} kernel took the {kern} leg")

    print(json.dumps({
        "serve": serve,
        "scheduler": scheduler,
        "encoder": encoders,
        "tf32x3_d8_bf16": rows["tf32x3_d8_bf16"],
        "tf32x3_prepass_ms": prepass_ms,
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
    ]
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
