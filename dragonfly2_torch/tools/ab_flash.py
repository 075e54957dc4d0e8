"""Time the tree's ``flash_fwd_sm90`` against another version of its source
on one card, in turns, beside SDPA.

    python -m dragonfly2_torch.tools.ab_flash --other path/to/flash_fwd_sm90.cu

The other source (for example the file from a parent commit's checkout)
is built with the same ``nvcc`` flags into ``--build-dir``. At each shape
both builds run on the same inputs: their outputs are compared, then they
are timed with CUDA events in the order other, tree, tree, other, SDPA,
for ``--rounds`` rounds, and the medians are printed with the card's name
and power limit. Both builds must export ``df_flash_fwd_sm90`` with the
same arguments.
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

# (B, T, H, D, causal): the encoder's call first
SHAPES = [
    (2, 8192, 4, 64, True),
    (2, 8192, 4, 64, False),
    (1, 8192, 4, 128, True),
    (4, 4096, 8, 32, True),
]


def build_other(src: Path, build_dir: Path):
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / "libflash_fwd_sm90_other.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    fn = ctypes.CDLL(str(lib)).df_flash_fwd_sm90
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    ap.add_argument("--other", type=Path, required=True, help="the other flash_fwd_sm90.cu")
    ap.add_argument("--build-dir", type=Path, default=_build.BUILD_DIR / "ab")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_flash: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    other = build_other(args.other, args.build_dir)

    def run_other(q, k, v, causal):
        b, t, h, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b, h, t), device=q.device)
        strides = [flash._tma_strides(x) for x in (q, k, v)]
        err = other(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    b, t, h, d, int(causal), *strides[0], *strides[1], *strides[2],
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other build's launch failed: error {err}")
        return o, lse

    for b, t, h, d, causal in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((b, t, h, d), generator=g, device="cuda").bfloat16() for _ in range(3))
        with torch.no_grad():
            o1, l1 = run_other(q, k, v, causal)
            o2, l2 = flash.launch_kernel(q, k, v, causal, "sm90")
            torch.cuda.synchronize()
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            ms_other, ms_tree, ms_sdpa = [], [], []
            for _ in range(args.rounds):
                ms_other.append(cuda_ms(lambda: run_other(q, k, v, causal)))
                ms_tree.append(cuda_ms(lambda: flash.launch_kernel(q, k, v, causal, "sm90")))
                ms_tree.append(cuda_ms(lambda: flash.launch_kernel(q, k, v, causal, "sm90")))
                ms_other.append(cuda_ms(lambda: run_other(q, k, v, causal)))
                ms_sdpa.append(cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal)))
        a, c, s = map(statistics.median, (ms_other, ms_tree, ms_sdpa))
        print(
            f"B={b} T={t} H={h} D={d} causal={causal}: max|O other - tree|="
            f"{(o1.float() - o2.float()).abs().max().item():.3g} max|LSE diff|="
            f"{(l1 - l2).abs().max().item():.3g}; other {a:.4f} ms, tree {c:.4f} ms"
            f" ({c / a - 1:+.1%}), sdpa {s:.4f} ms (tree/sdpa {c / s:.3f})"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
