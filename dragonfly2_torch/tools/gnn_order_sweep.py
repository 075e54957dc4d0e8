"""Fit the GNN at the trainer's defaults on one seeded probe graph whose
topology records come in different orders, and print each fit's holdout
mse beside the mean predictor's on the same holdout.

    python -m dragonfly2_torch.tools.gnn_order_sweep --hosts 10000 --orders 6 --drops 5

The graph is the one ``chip_smoke.py``'s legs probe: hosts at seeded
points of the unit square, each probing ``--probes`` distinct others, RTT
1 ms + 80 ms × distance + exponential noise of mean 2 ms, written as
topology records of at most 5 peers each. The first fit takes the records
in host order; each of ``--orders`` fits takes them shuffled (a
scheduler's snapshots list hosts in the order their probes arrived, which
sets the graph's node and edge order, so the order is all that differs
between two runs of the server leg); each of ``--drops`` fits takes them
shuffled with one of each host's last six probes left out, as the server
leg's third snapshot keeps 5 of a round's 6. The fits are
``train.train_gnn`` with ``GNNFitConfig()``; the card's name and power
limit are printed first.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from dragonfly2_torch.schema import records as R
from dragonfly2_torch.schema.columnar import records_to_columns
from dragonfly2_torch.schema.features import build_probe_graph
from dragonfly2_torch.trainer.train import GNNFitConfig, _split_eval, train_gnn


def probe_records(peers: np.ndarray, rtts: np.ndarray) -> list:
    """[hosts, k] probed peers and their RTTs (ns) → topology records of
    at most ``R.MAX_DEST_HOSTS`` peers, chunk by chunk over the hosts."""
    ids = [f"host-{i:05d}" for i in range(len(peers))]

    def host(cls, i, **kw):
        return cls(id=ids[i], type="normal", hostname=ids[i], ip=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}",
                   port=65000, **kw)

    out = []
    for c in range(0, peers.shape[1], R.MAX_DEST_HOSTS):
        for i in range(len(peers)):
            dests = [host(R.DestHost, int(j), probes=R.ProbesRecord(average_rtt=int(t)))
                     for j, t in zip(peers[i, c : c + R.MAX_DEST_HOSTS], rtts[i, c : c + R.MAX_DEST_HOSTS])]
            out.append(R.NetworkTopologyRecord(id=f"nt-{i}-{c}", host=host(R.SrcHost, i), dest_hosts=dests))
    return out


def fit(tag: str, cols: dict, device: str) -> dict:
    graph = build_probe_graph(cols)
    cfg = GNNFitConfig()
    _, eval_idx = _split_eval(len(graph.edge_src), cfg.eval_fraction, cfg.seed)
    y = graph.edge_rtt_log_ms[eval_idx]
    mean = float(np.mean((y - y.mean()) ** 2))
    t0 = time.perf_counter()
    got = train_gnn(graph, config=cfg, device=device)
    wall = time.perf_counter() - t0
    mse = got.metrics["mse"]
    print(f"{tag}: {len(graph.edge_src)} edges, holdout mse {mse:.5f}, mean predictor {mean:.5f}"
          f" ({mse / mean:.3f} of it), last epoch's loss {got.history[-1]:.5f}, fit {wall:.1f} s", flush=True)
    return {"tag": tag, "mse": mse, "mean": mean}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hosts", type=int, default=10_000)
    ap.add_argument("--probes", type=int, default=16)
    ap.add_argument("--orders", type=int, default=6)
    ap.add_argument("--drops", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    n = args.hosts
    rng = np.random.default_rng(args.seed)
    peers = np.stack([rng.choice(n - 1, args.probes, replace=False) for _ in range(n)])
    peers += peers >= np.arange(n)[:, None]  # distinct peers, no self probe
    coords = rng.uniform(0, 1, (n, 2))
    dist = np.linalg.norm(coords[:, None, :] - coords[peers], axis=-1)
    rtts = ((1.0 + 80.0 * dist + rng.exponential(2.0, (n, args.probes))) * 1e6).astype(np.int64)
    cols = records_to_columns(probe_records(peers, rtts))
    rows = len(cols["id"])
    out = [fit("host order", cols, args.device)]
    for k in range(args.orders):
        p = np.random.default_rng(args.seed + 100 + k).permutation(rows)
        out.append(fit(f"shuffled {k}", {key: v[p] for key, v in cols.items()}, args.device))
    last = max(args.probes - 6, 0)
    for k in range(args.drops):
        r = np.random.default_rng(args.seed + 200 + k)
        keep = np.ones(peers.shape, bool)
        keep[np.arange(n), last + r.integers(0, args.probes - last, n)] = False
        kept = records_to_columns(probe_records(peers[keep].reshape(n, -1), rtts[keep].reshape(n, -1)))
        p = r.permutation(len(kept["id"]))
        out.append(fit(f"one dropped, shuffled {k}", {key: v[p] for key, v in kept.items()}, args.device))
    shares = sorted(o["mse"] / o["mean"] for o in out)
    print(f"{len(out)} fits: holdout mse / mean predictor's, sorted: {[round(s, 4) for s in shares]};"
          f" {sum(s >= 1.0 for s in shares)} at or above 1", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
