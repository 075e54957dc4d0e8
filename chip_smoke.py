#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dragonfly2_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. device and build: the card's name and power limit, then the flash
   kernel's CUDA source built with ``nvcc`` (timed);
2. the flash kernel against its plain PyTorch version at every checked
   shape, with max|err| of O and LSE, kernel / plain / SDPA times and the
   card's bound for the same work;
3. serve leg at cluster scale: 10,000 hosts × 16 probes through the
   topology engine, one flush on the card, then waves of 256 decisions ×
   15 candidates joined (rtt affinity) and ranked by a [19, 128, 128, 1]
   MLP loaded from npz bytes — rankings against ``rank_order``, scores and
   affinities against the same port on the CPU;
4. encoder leg at full width: the piece-sequence transformer (model_dim
   256, 4 heads, 4 layers) on B = 2, T = 8192 in bfloat16 with the flash
   kernel as its attention, against the plain ``local_attention``; the
   kernel's launch count must grow by one per layer.

The line before the last holds the kernels' table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. Weights and data are random, made from seeds.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dragonfly2_torch import _build
from dragonfly2_torch.models.attention import apply_transformer, init_transformer
from dragonfly2_torch.models.mlp import init_mlp
from dragonfly2_torch.ops import flash
from dragonfly2_torch.schema.features import GRU_FEATURE_DIM, MLP_FEATURE_DIM
from dragonfly2_torch.scheduler import wave
from dragonfly2_torch.topology import TopologyConfig, TopologyEngine
from dragonfly2_torch.trainer.serving import (
    MLPScorer,
    deserialize_params_auto,
    serialize_params,
)

# NVIDIA H100 SXM data sheet, dense rates
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# O is held per element as |o - ref| <= atol + rtol·|ref|: float32 leaves
# room for another summation order only, bfloat16 for the two f32 sums
# landing on either side of a rounding point (2^-7·|ref| is one bf16 step)
# and one step more. LSE is float32 on both sides, whatever the inputs.
FLASH_O_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2**-6)}
FLASH_LSE_TOL = 1e-4
# (B, T, H, D, causal, dtype): the reference's on-chip set, a D=8 and a
# D=16 case, and the encoder's own shape last
FLASH_SHAPES = [
    (2, 512, 4, 64, True, torch.float32),
    (2, 200, 4, 64, True, torch.float32),  # ragged tail
    (1, 333, 2, 32, False, torch.float32),  # odd length, non-causal
    (2, 512, 4, 64, False, torch.bfloat16),
    (1, 96, 8, 128, True, torch.float32),  # short sequence, wide head
    (2, 100, 4, 8, True, torch.float32),
    (1, 77, 2, 16, False, torch.bfloat16),
]
ENCODER = dict(in_dim=GRU_FEATURE_DIM, model_dim=256, num_heads=4, num_layers=4)
ENCODER_BT = (2, 8192)


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
    """Least time for the attention on this card: operations over the
    type's peak rate against q, k, v, o and LSE moved once over the
    memory rate."""
    pairs = t * (t + 1) // 2 if causal else t * t
    ops = 4 * b * h * d * pairs
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * t * h * d * elem + 4 * b * h * t
    ops_ms = ops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def flash_case(b, t, h, d, causal, dtype, seed, timed: bool) -> dict:
    """One shape: kernel against the plain version (and SDPA's time)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (
        torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype) for _ in range(3)
    )
    with torch.no_grad():
        o, lse = flash.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash.flash_attention_reference(q, k, v, causal=causal)
    atol, rtol = FLASH_O_TOL[dtype]
    diff = (o.float() - o_ref.float()).abs()
    err_o = diff.max().item()
    # worst share of the per-element limit used (<= 1 passes)
    o_ratio = (diff / (atol + rtol * o_ref.float().abs())).max().item()
    o_rel_rms = err_o / o_ref.float().pow(2).mean().sqrt().item()
    err_lse = (lse - lse_ref).abs().max().item()
    name = f"flash B={b} T={t} H={h} D={d} causal={causal} {str(dtype)[6:]}"
    print(
        f"{name}: max|err| O={err_o:.3g} (max|err|/rms(ref)={o_rel_rms:.3g};"
        f" per element {o_ratio:.3g} of the limit {atol:g}+{rtol:g}*|ref|)"
        f" LSE={err_lse:.3g} (limit {FLASH_LSE_TOL:g})"
    )
    check(o.shape == q.shape and o.dtype == dtype and torch.isfinite(o).all().item(), name)
    check(o_ratio <= 1.0, f"{name}: kernel's O disagrees with the plain version")
    check(err_lse <= FLASH_LSE_TOL, f"{name}: kernel's LSE disagrees with the plain version")
    out = {"max_abs_err": max(err_o, err_lse)}
    bound, by = flash_bound_ms(b, t, h, d, causal, dtype)
    out.update(bound_ms=bound, bound_by=by)
    if timed:
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's layout
        with torch.no_grad():
            out["ms"] = cuda_ms(lambda: flash.flash_attention(q, k, v, causal=causal), 10)
            out["plain_ms"] = cuda_ms(
                lambda: flash.flash_attention_reference(q, k, v, causal=causal), 3
            )
            out["library_ms"] = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal
                ),
                20,
            )
        print(
            f"{name}: kernel_ms={out['ms']:.4f} plain_ms={out['plain_ms']:.4f}"
            f" library_ms(sdpa)={out['library_ms']:.4f} bound_ms={bound:.4f} ({by})"
        )
    return out


def serve_leg(device, hosts=10_000, probes=16, waves=(256, 15), repeats=20, seed=0) -> dict:
    """Topology flush + wave join + ranked MLP scoring on ``device``, held
    against the same port on the CPU."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ids = [f"host-{i:05d}" for i in range(hosts)]
    peers = np.stack([rng.choice(hosts - 1, probes, replace=False) for _ in range(hosts)])
    peers += peers >= np.arange(hosts)[:, None]  # distinct peers, no self probe
    rtts = rng.lognormal(np.log(20e6), 0.6, (hosts, probes)).astype(np.int64)
    now = 1_000_000.0
    cfg = TopologyConfig(flush_threshold=10**9, max_pending=hosts * probes + 1)

    def fed(dev):
        eng = TopologyEngine(cfg, device=dev)
        for i in range(hosts):
            for j, rtt in zip(peers[i], rtts[i]):
                eng.enqueue(ids[i], ids[int(j)], int(rtt), created_at=now - 60.0)
        return eng

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

    mlp = init_mlp(torch.Generator().manual_seed(seed), [MLP_FEATURE_DIM, 128, 128, 1])
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


def encoder_leg(device, batch=ENCODER_BT[0], seq=ENCODER_BT[1], cfg=ENCODER, seed=0) -> dict:
    """The encoder forward with the flash kernel as its attention, against
    ``local_attention`` on the same weights."""
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
            return apply_transformer(enc, x, attention_fn=flash_causal, compute_dtype=torch.bfloat16)

    flash.LAUNCHES = 0
    out = forward()
    sync(device)
    launches = flash.LAUNCHES
    expected = cfg["num_layers"] if device.type == "cuda" else 0
    check(launches == expected, f"flash launches {launches}, expected {expected}")
    with torch.no_grad():
        ref = apply_transformer(enc, x, causal=True, compute_dtype=torch.bfloat16)
    err = (out - ref).abs().max().item()
    print(f"encoder[{device}]: B={batch} T={seq} out={tuple(out.shape)} launches={launches}"
          f" max|flash - local|={err:.3g} (tol 5e-2)")
    check(out.shape == (batch, seq, cfg["model_dim"]), "encoder output shape")
    check(torch.isfinite(out).all().item(), "encoder output not finite")
    check(err <= 5e-2, "encoder with flash differs from local_attention")
    fwd_ms = wall_ms(forward, 3, device)
    local_ms = wall_ms(
        lambda: apply_transformer(enc, x, causal=True, compute_dtype=torch.bfloat16), 3, device
    )
    print(f"encoder[{device}]: forward_ms={fwd_ms:.2f} (with local_attention {local_ms:.2f})")
    return {"launches": launches, "err": err, "forward_ms": fwd_ms, "local_forward_ms": local_ms}


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

    t0 = time.perf_counter()
    _build.load("flash_fwd")
    print(f"build: flash_fwd in {time.perf_counter() - t0:.1f}s")
    for line in _build.build_log("flash_fwd").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  flash_fwd: {line.strip()}")

    for i, shape in enumerate(FLASH_SHAPES):
        flash_case(*shape, seed=100 + i, timed=False)
    b, t = ENCODER_BT
    h = ENCODER["num_heads"]
    d = ENCODER["model_dim"] // h
    main_shape = flash_case(b, t, h, d, True, torch.bfloat16, seed=7, timed=True)

    flash.LAUNCHES = 0
    serve = serve_leg("cuda")
    check(flash.LAUNCHES == 0, "the serve leg runs no attention")
    encoder = encoder_leg("cuda")

    print(json.dumps({"serve": serve, "encoder": encoder}))
    kernel = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "dragonfly2_torch/csrc/flash_fwd.cu",
        "replaces": "dragonfly2_tpu/ops/flash.py:133",
        "launches": encoder["launches"],
        **{k: main_shape[k] for k in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }
    print(json.dumps({"kernels": [kernel]}))
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
