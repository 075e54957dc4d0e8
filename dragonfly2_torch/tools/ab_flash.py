"""Time one of the tree's flash kernels against another build of a flash
source on one card, in turns, beside SDPA.

    python -m dragonfly2_torch.tools.ab_flash --other path/to/flash_fwd_sm90.cu
    python -m dragonfly2_torch.tools.ab_flash --kernel tf32x3 --other path/to/flash_fwd.cu

The other source (for example a file from a parent commit's checkout) is
built with the same ``nvcc`` flags into ``--build-dir`` and called through
whichever C entry it exports: ``df_flash_fwd_sm90``,
``df_flash_fwd_tf32x3``, or ``df_flash_fwd`` (the earlier float32 kernel
on the CUDA cores, which took a dtype code and no scratch). At each of the
``--kernel``'s shapes both run on the same inputs: their outputs are
compared, then they are timed with CUDA events in the order other, tree,
tree, other, SDPA, for ``--rounds`` rounds, and the medians are printed
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from dragonfly2_torch import _build
from dragonfly2_torch.ops import flash

# (B, T, H, D, causal, dtype) per kernel of the tree: the encoder's call first
SHAPES = {
    "sm90": [
        (2, 8192, 4, 64, True, torch.bfloat16),
        (2, 8192, 4, 64, False, torch.bfloat16),
        (1, 8192, 4, 128, True, torch.bfloat16),
        (4, 4096, 8, 32, True, torch.bfloat16),
    ],
    "tf32x3": [
        (2, 8192, 4, 64, True, torch.float32),
        (2, 8192, 4, 64, False, torch.float32),
        (1, 8192, 4, 128, True, torch.float32),
        (4, 4096, 8, 32, True, torch.float32),
        (2, 8192, 4, 8, True, torch.bfloat16),
    ],
}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entries a flash source may export, with their argument types
ENTRIES = {
    **{sym: flash._ARGTYPES[sym] for sym in ("df_flash_fwd_sm90", "df_flash_fwd_tf32x3")},
    "df_flash_fwd": [_P] * 5 + [_I] * 6 + [_L] * 9 + [_P],
}


def build_other(src: Path, build_dir: Path):
    """→ (C entry name, ctypes function, nvcc's report) of the build of
    ``src``."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / f"lib{src.stem}_other.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    handle = ctypes.CDLL(str(lib))
    for sym, argtypes in ENTRIES.items():
        if hasattr(handle, sym):
            fn = getattr(handle, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            return sym, fn, proc.stdout
    raise RuntimeError(f"{src} exports none of {sorted(ENTRIES)}")


def other_runner(sym: str, fn):
    """A call of the other build on [B, T, H, D] CUDA tensors → (O, LSE)."""

    def run(q, k, v, causal):
        b, t, h, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b, h, t), device=q.device)
        dtype = flash._DTYPE_CODE[q.dtype]
        if sym == "df_flash_fwd_sm90":
            head = [b, t, h, d]
            strides = [flash._tma_strides(x) for x in (q, k, v)]
        else:
            strides = [x.stride()[:3] for x in (q, k, v)]
            if sym == "df_flash_fwd":
                head = [b, t, h, d, dtype]
            else:
                scratch = flash._prepass_buffers(q)
                head = [x.data_ptr() for x in scratch] + [b, t, h, d, dtype]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), *head,
                 int(causal), *strides[0], *strides[1], *strides[2],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other build's {sym} launch failed: error {err}")
        return o, lse

    return run


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="the other flash source (.cu)")
    ap.add_argument("--kernel", choices=sorted(SHAPES), default="sm90",
                    help="the tree's kernel to time, and so the shapes")
    ap.add_argument("--build-dir", type=Path, default=_build.BUILD_DIR / "ab")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_flash: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    sym, fn, _ = build_other(args.other, args.build_dir)
    run_other = other_runner(sym, fn)
    print(f"tree: {flash._LIBRARY[args.kernel]}; other: {sym} from {args.other}")

    for b, t, h, d, causal, dtype in SHAPES[args.kernel]:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype) for _ in range(3))

        def run_tree():
            return flash.launch_kernel(q, k, v, causal, args.kernel)

        with torch.no_grad():
            o1, l1 = run_other(q, k, v, causal)
            o2, l2 = run_tree()
            torch.cuda.synchronize()
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            ms_other, ms_tree, ms_sdpa = [], [], []
            for _ in range(args.rounds):
                ms_other.append(cuda_ms(lambda: run_other(q, k, v, causal)))
                ms_tree.append(cuda_ms(run_tree))
                ms_tree.append(cuda_ms(run_tree))
                ms_other.append(cuda_ms(lambda: run_other(q, k, v, causal)))
                ms_sdpa.append(cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal)))
        a, c, s = map(statistics.median, (ms_other, ms_tree, ms_sdpa))
        print(
            f"B={b} T={t} H={h} D={d} causal={causal} {str(dtype)[6:]}: max|O other - tree|="
            f"{(o1.float() - o2.float()).abs().max().item():.3g} max|LSE diff|="
            f"{(l1 - l2).abs().max().item():.3g}; other {a:.4f} ms, tree {c:.4f} ms"
            f" ({c / a - 1:+.1%}), sdpa {s:.4f} ms (tree/sdpa {c / s:.3f})"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
