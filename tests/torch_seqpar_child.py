"""One rank of a gloo world for tests/test_torch_seqpar.py.

    python tests/torch_seqpar_child.py <workdir> <world size> <rank>

Reads ``inputs.pkl`` from the work directory (global arrays, made by the
test from seeds), joins the world through a ``FileStore`` there, runs every
case of the port's sequence-parallel ops on this rank's shards, and writes
what it got to ``out_<rank>.pkl``. It imports torch and the port, never jax
or the JAX package.
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from dragonfly2_torch.models.attention import apply_transformer
from dragonfly2_torch.ops import flash
from dragonfly2_torch.ops.ring import make_ring_attention, ring_all_gather, ring_gather_rows
from dragonfly2_torch.ops.ulysses import make_ulysses_attention
from dragonfly2_torch.parallel import auto_dp_mesh, make_mesh, mesh_shape
from dragonfly2_torch.weights import transformer_from_numpy


def shard(x: np.ndarray, n: int, rank: int, axis: int = 1) -> torch.Tensor:
    return torch.from_numpy(np.split(x, n, axis=axis)[rank].copy())


def grads_of(fn, q, k, v):
    """(out, dq, dk, dv) of sum(fn(q, k, v)²) on this rank's shards; every
    rank's loss is its own shard's, so the gradients are the global loss's."""
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    (out.float() ** 2).sum().backward()
    return [x.detach().float().numpy() for x in (out, q.grad, k.grad, v.grad)]


def error_of(fn) -> str:
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def main() -> None:
    work, n, rank = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    inp = pickle.loads((work / "inputs.pkl").read_bytes())
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / "store"), n), rank=rank, world_size=n
    )
    out = {}
    mesh = make_mesh(sp=n)
    out["mesh"] = {
        "default": mesh_shape(make_mesh()),
        "sp-1": mesh_shape(mesh),
        "dp2": mesh_shape(make_mesh(dp=2, sp=-1)),
        "auto": mesh_shape(auto_dp_mesh()),
        "too_many": error_of(lambda: make_mesh(sp=n + 1)),
    }

    q, k, v = (shard(inp[name], n, rank) for name in ("q", "k", "v"))
    for causal in (False, True):
        ring = make_ring_attention(mesh, "sp", causal=causal)
        uly = make_ulysses_attention(mesh, "sp", causal=causal)
        with torch.no_grad():
            out[f"ring_{causal}"] = ring(q, k, v).numpy()
            out[f"ulysses_{causal}"] = uly(q, k, v).numpy()
    with torch.no_grad():
        bq, bk, bv = (x.bfloat16() for x in (q, k, v))
        out["ring_bf16"] = make_ring_attention(mesh, "sp", causal=True)(bq, bk, bv).float().numpy()
    out["ring_grad"] = grads_of(make_ring_attention(mesh, "sp", causal=True), q, k, v)
    flash.reset_launches()
    out["ulysses_kernel_grad"] = grads_of(
        make_ulysses_attention(mesh, "sp", causal=True, use_kernel=True), q, k, v
    )
    out["kernel_launches"] = flash.LAUNCHES
    out["ulysses_grad"] = grads_of(make_ulysses_attention(mesh, "sp", causal=True), q, k, v)

    out["all_gather"] = ring_all_gather(shard(inp["table"], n, rank, axis=0), mesh.get_group("sp")).numpy()
    out["gather_rows"] = ring_gather_rows(
        shard(inp["table"], n, rank, axis=0),
        shard(inp["indices"], n, rank, axis=0),
        mesh.get_group("sp"),
    ).numpy()

    odd = shard(inp["q_odd_heads"], n, rank)
    out["heads_error"] = error_of(lambda: make_ulysses_attention(mesh, "sp")(odd, odd, odd))
    out["unequal_error"] = error_of(
        lambda: make_ring_attention(mesh, "sp", causal=True)(q, k[:, : q.shape[1] // 2], v[:, : q.shape[1] // 2])
    )

    if "tree" in inp:
        enc = transformer_from_numpy(inp["tree"], device="cpu")
        x, w = shard(inp["x"], n, rank), shard(inp["w"], n, rank)
        flash.reset_launches()
        h = apply_transformer(
            enc, x, attention_fn=make_ulysses_attention(mesh, "sp", causal=True, use_kernel=True),
            compute_dtype=torch.float32,
        )
        (h * w).sum().backward()
        grads = {}
        for name, p in enc.named_parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad)
                grads[name] = p.grad.numpy()
        out["encoder"] = {"grads": grads, "out": h.detach().numpy(), "launches": flash.LAUNCHES}

    (work / f"out_{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
