"""Build variants of ``csrc/flash_fwd_tf32x3.cu`` and time them against the
tree's build on one card, in turns, each held against the plain version.

    python -m dragonfly2_torch.tools.sweep_tf32x3 --config 64:32,4 --edit one-level \\
        --shape 2,8192,4,64,causal,float32

A variant is the tree's source with one change:

- ``--config D:BN,STAGES`` launches head dim D with another key tile and
  ring depth, STAGES >= 2 (D = 8 names the bfloat16 role with
  ``--dtype-8 bfloat16``);
- ``--edit NAME`` rewrites the kernel body: ``one-level`` sums P·V into
  O in one tensor-core accumulator across all key tiles (the rounding
  experiment), ``serial-s`` issues the next tile's S only after P·V has
  finished, ``one-pv`` keeps only the P_hi·V_hi product and ``no-pv``
  drops P·V (the last two are timing diagnostics whose output is wrong).

All variants are built in parallel with the library's ``nvcc`` flags
(ptxas registers and spills are printed per instantiation), then at each
``--shape`` every build runs once against the plain version (worst share
of the O limit and LSE error) and is timed with CUDA events over
``--rounds`` rounds, the order reversed every other round; medians are
printed beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from dragonfly2_torch import _build
from dragonfly2_torch.ops import flash
from dragonfly2_torch.tools import ab_flash

SOURCE = _build.CSRC_DIR / _build.SOURCES["flash_fwd_tf32x3"]
O_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2**-6)}

_PV = (
    "      WgmmaTf32<D>::rs(pv, pl[kk], dv, kk > 0);\n"
    "      if constexpr (SPLIT) WgmmaTf32<D>::rs(pv, ph[kk], VT::desc(v_lo, 0, kk), 1);\n"
    "      WgmmaTf32<D>::rs(pv, ph[kk], dv, 1);\n"
)
_ADD = "    for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(acc[i], (i & 2) ? alpha_b : alpha_a, pv[i]);\n"
_L = "    l_b = l_b * alpha_b + sum_b;\n"
# edit name → (old, new) replacements of the kernel body, each of which must match
EDITS = {
    "one-level": [
        (_PV, _PV.replace("(pv, pl[kk], dv, kk > 0)", "(acc, pl[kk], dv, 1)").replace("(pv,", "(acc,")),
        ("fence_regs<D / 2>(pv);", "fence_regs<D / 2>(acc);"),
        (_ADD, "    ;\n"),
        (_L, _L + "    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? alpha_b : alpha_a;\n"),
    ],
    "serial-s": [(
        "    if (it + 1 < n_tiles) issue_scores(it + 1);\n    wg_wait_all();\n",
        "    wg_wait_all();\n    if (it + 1 < n_tiles) {\n      fence_regs<BN / 2>(sc);\n"
        "      wg_fence();\n      issue_scores(it + 1);\n      wg_wait_all();\n    }\n",
    )],
    "one-pv": [(_PV, "      WgmmaTf32<D>::rs(pv, ph[kk], dv, kk > 0);\n")],
    "no-pv": [(_PV, "      (void)dv;\n")],
}


def variant_source(config: "str | None", edit: "str | None", dtype8: str) -> str:
    text = SOURCE.read_text()
    if config:
        d, rest = config.split(":")
        bn, stages = rest.split(",")
        split, out = ("false", "__nv_bfloat16") if d == "8" and dtype8 == "bfloat16" else ("true", "float")
        head = f"launch<{d}, "
        lines = [ln for ln in text.splitlines() if head in ln and f"{split}, {out}>" in ln]
        if len(lines) != 1:
            raise ValueError(f"no single dispatch line for D = {d} in {SOURCE.name}")
        start = lines[0].index(head)
        end = lines[0].index(">", start)
        new = lines[0][:start] + f"launch<{d}, {bn}, {stages}, {split}, {out}" + lines[0][end:]
        text = text.replace(lines[0], new)
    for old, new in EDITS.get(edit, []):
        if old not in text:
            raise ValueError(f"edit {edit}: {old.strip()[:60]!r} not in {SOURCE.name}")
        text = text.replace(old, new)
    return text


def build(name: str, text: str, build_dir: Path):
    """→ (name, run(q, k, v, causal), ptxas's registers and spills)."""
    src = build_dir / f"{name}.cu"
    src.write_text(text)
    sym, fn, log = ab_flash.build_other(src, build_dir)
    regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if re.search(r"Used \d+ registers|bytes spill stores", ln)]
    return name, ab_flash.other_runner(sym, fn), regs


def parse_shape(text: str):
    b, t, h, d, causal, dtype = text.split(",")
    return int(b), int(t), int(h), int(d), causal == "causal", getattr(torch, dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", action="append", default=[], help="D:BN,STAGES (repeatable)")
    ap.add_argument("--edit", action="append", default=[], choices=sorted(EDITS))
    ap.add_argument("--dtype-8", default="bfloat16", choices=("bfloat16", "float32"),
                    help="which D = 8 instantiation a --config 8:... changes")
    ap.add_argument("--shape", action="append", type=parse_shape, default=[],
                    help="B,T,H,D,causal|full,float32|bfloat16 (repeatable)")
    ap.add_argument("--build-dir", type=Path, default=_build.BUILD_DIR / "sweep")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_tf32x3: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    args.build_dir.mkdir(parents=True, exist_ok=True)
    wanted = [(f"cfg{c.replace(':', '_').replace(',', '_')}", c, None) for c in args.config]
    wanted += [(e.replace("-", "_"), None, e) for e in args.edit]
    with ThreadPoolExecutor(max(1, len(wanted))) as pool:
        built = list(pool.map(
            lambda w: build(w[0], variant_source(w[1], w[2], args.dtype_8), args.build_dir), wanted
        ))
    for name, _, regs in built:
        print(f"{name}: " + "; ".join(regs))
    runs = [("tree", lambda q, k, v, c: flash.launch_kernel(q, k, v, c, "tf32x3"))]
    runs += [(name, run) for name, run, _ in built]

    for b, t, h, d, causal, dtype in args.shape or [(2, 8192, 4, 64, True, torch.float32)]:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype) for _ in range(3))
        atol, rtol = O_TOL[dtype]
        times = {name: [] for name, _ in runs}
        with torch.no_grad():
            o_ref, lse_ref = flash.flash_attention_reference(q, k, v, causal)
            limit = atol + rtol * o_ref.float().abs()
            for name, run in runs:
                o, lse = run(q, k, v, causal)
                torch.cuda.synchronize()
                share = ((o.float() - o_ref.float()).abs() / limit).max().item()
                err_lse = (lse - lse_ref).abs().max().item()
                print(f"B={b} T={t} H={h} D={d} causal={causal} {str(dtype)[6:]} {name}:"
                      f" {share:.3g} of the O limit, LSE err {err_lse:.3g}")
            del o_ref, lse_ref, limit
            for r in range(args.rounds):
                for name, run in runs if r % 2 == 0 else runs[::-1]:
                    times[name].append(ab_flash.cuda_ms(lambda: run(q, k, v, causal), 10))
        for name, ms in times.items():
            print(f"B={b} T={t} H={h} D={d} causal={causal} {str(dtype)[6:]} {name}:"
                  f" {statistics.median(ms):.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
