"""dfstat — live top-like view of the cluster telemetry plane.

The manager aggregates every service's telemetry pushes
(docs/telemetry.md) and serves the rolled-up cluster state at
``/api/v1/telemetry`` on its REST port; dfstat renders it as a swarm
table, per-shard rates, trainer/daemon rows, and the SLO burn status —
the "can I see the cluster" answer the per-process /metrics endpoints
never give.

Usage:
    python -m dragonfly2_torch.tools.dfstat --manager HOST:PORT [--once]
        [--interval S] [--window 1m|5m|1h]

Without ``--once`` the view refreshes every ``--interval`` seconds
(default 2), clearing the screen between frames like top.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

# field names come from the TFIELDS census (utils/telemetry.py) — the
# same constants the manager's snapshot code keys on, so this view
# and the plane can never drift apart
from dragonfly2_torch.utils.telemetry import (
    F_CLUSTER_P2P_EFFICIENCY,
    F_CLUSTER_PEERS,
    F_CLUSTER_SCHEDULE_OPS,
    F_CLUSTER_TASKS,
    F_DAEMON_BACK_TO_SOURCE,
    F_DAEMON_FLOW_BYTES,
    F_DAEMON_FLOW_ORIGIN_BYTES,
    F_DAEMON_FLOW_P2P_BYTES,
    F_DAEMON_PIECE_BYTES,
    F_SHARD_ANNOUNCE_OPS,
    F_SHARD_DECISION_P99,
    F_SHARD_PEERS,
    F_SHARD_SCHEDULE_OPS,
    F_SHARD_SWARM_DEPTHS,
    F_SHARD_SWARM_PEERS,
    F_SHARD_SWARM_STRAGGLERS,
    F_SHARD_SWARM_TASKS,
    F_SHARD_TASKS,
    F_SWARM_DONE_PIECES,
    F_SWARM_PEERS,
    F_SWARM_SEEDERS,
    F_SWARM_STRAGGLERS,
    F_SWARM_TOTAL_PIECES,
    F_TRAINER_FIT_FRESHNESS,
    F_TRAINER_INGEST_RECORDS,
)


def fetch(manager: str, timeout: float = 5.0) -> dict:
    """GET the telemetry snapshot; ``manager`` is host:port or a full
    http:// URL of the manager REST surface."""
    base = manager if "://" in manager else f"http://{manager}"
    with urllib.request.urlopen(
        f"{base.rstrip('/')}/api/v1/telemetry", timeout=timeout
    ) as resp:
        return json.loads(resp.read())


def _table(rows: "list[list[str]]", header: "list[str]") -> "list[str]":
    widths = [
        max(len(str(r[i])) for r in [header] + rows) for i in range(len(header))
    ]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    out = [fmt.format(*header)]
    for r in rows:
        out.append(fmt.format(*(str(c) for c in r)))
    return out


def _short(s: str, n: int = 24) -> str:
    return s if len(s) <= n else s[: n - 1] + "…"


def render(snap: dict, window: str = "1m") -> str:
    """The full frame as one string (pure — tests assert on it)."""
    lines: list[str] = []
    cluster = snap.get("cluster", {})
    ops = cluster.get(F_CLUSTER_SCHEDULE_OPS, {})
    eff = (cluster.get(F_CLUSTER_P2P_EFFICIENCY) or {}).get(window)
    lines.append(
        f"dragonfly cluster  peers={cluster.get(F_CLUSTER_PEERS, 0):.0f}"
        f"  tasks={cluster.get(F_CLUSTER_TASKS, 0):.0f}"
        f"  schedule_ops/s[{window}]={ops.get(window, 0.0)}"
        f"  p2p_eff[{window}]={'-' if eff is None else f'{eff:.2f}'}"
        f"  services={len(snap.get('services', []))}"
    )

    slos = snap.get("slos", [])
    if slos:
        lines.append("")
        lines.append("SLOs")
        rows = []
        for s in slos:
            burn = s.get("burn", {})
            status = "BREACH" if s.get("breached") else "ok"
            rows.append(
                [
                    s.get("name", ""),
                    f"{s.get('objective', 0):.3g}",
                    " ".join(f"{w}={b:.2f}x" for w, b in sorted(burn.items())),
                    status,
                ]
            )
        lines += _table(rows, ["slo", "objective", "burn", "status"])

    shards = snap.get("shards", [])
    if shards:
        lines.append("")
        lines.append("scheduler shards")
        rows = [
            [
                _short(sh.get("shard", "")),
                "stale" if sh.get("stale") else "live",
                f"{sh.get(F_SHARD_SCHEDULE_OPS, {}).get(window, 0.0)}",
                f"{sh.get(F_SHARD_ANNOUNCE_OPS, {}).get(window, 0.0)}",
                f"{sh.get(F_SHARD_DECISION_P99, 0.0)}",
                f"{sh.get(F_SHARD_PEERS, 0):.0f}",
                f"{sh.get(F_SHARD_TASKS, 0):.0f}",
            ]
            for sh in shards
        ]
        lines += _table(
            rows,
            ["shard", "state", f"sched/s[{window}]", f"ann/s[{window}]",
             "p99_ms", "peers", "tasks"],
        )

    # per-shard swarm-observatory rollup (only shards that reported one)
    swarm_shards = [sh for sh in shards if F_SHARD_SWARM_TASKS in sh]
    if swarm_shards:
        lines.append("")
        lines.append("shard swarms (observatory rollup)")
        rows = []
        for sh in swarm_shards:
            depths = sh.get(F_SHARD_SWARM_DEPTHS, {}) or {}
            hist = (
                " ".join(f"{d}:{n}" for d, n in sorted(depths.items())) or "-"
            )
            rows.append(
                [
                    _short(sh.get("shard", "")),
                    f"{sh.get(F_SHARD_SWARM_TASKS, 0)}",
                    f"{sh.get(F_SHARD_SWARM_PEERS, 0)}",
                    hist,
                    f"{sh.get(F_SHARD_SWARM_STRAGGLERS, 0)}",
                ]
            )
        lines += _table(
            rows, ["shard", "tasks", "peers", "depth_hist", "stragglers"]
        )

    swarms = snap.get("swarms", [])
    if swarms:
        lines.append("")
        lines.append("task swarms")
        rows = []
        for sw in swarms[:32]:
            total = sw.get(F_SWARM_TOTAL_PIECES, 0)
            peers = max(sw.get(F_SWARM_PEERS, 0), 1)
            done = sw.get(F_SWARM_DONE_PIECES, 0)
            pct = 100.0 * done / (total * peers) if total else 0.0
            rows.append(
                [
                    _short(sw.get("task_id", ""), 32),
                    sw.get(F_SWARM_PEERS, 0),
                    sw.get(F_SWARM_SEEDERS, 0),
                    f"{done}/{total * peers or '?'} ({pct:.0f}%)" if total else str(done),
                    ",".join(_short(p, 16) for p in sw.get(F_SWARM_STRAGGLERS, [])) or "-",
                ]
            )
        lines += _table(rows, ["task", "peers", "seeders", "pieces", "stragglers"])

    trainers = snap.get("trainers", [])
    if trainers:
        lines.append("")
        lines.append("trainers")
        rows = []
        for t in trainers:
            fresh = t.get(F_TRAINER_FIT_FRESHNESS)
            rows.append(
                [
                    _short(t.get("instance", "")),
                    "stale" if t.get("stale") else "live",
                    f"{t.get(F_TRAINER_INGEST_RECORDS, {}).get(window, 0.0)}",
                    f"{fresh:.0f}s" if fresh is not None else "never",
                ]
            )
        lines += _table(
            rows, ["trainer", "state", f"ingest rec/s[{window}]", "fit age"]
        )

    daemons = snap.get("daemons", [])
    if daemons:
        lines.append("")
        lines.append("daemons")
        rows = [
            [
                _short(d.get("instance", "")),
                "stale" if d.get("stale") else "live",
                f"{d.get(F_DAEMON_PIECE_BYTES, {}).get(window, 0.0)}",
                f"{d.get(F_DAEMON_BACK_TO_SOURCE, {}).get(window, 0.0)}",
                f"{d.get(F_DAEMON_FLOW_P2P_BYTES, {}).get(window, 0.0)}",
                f"{d.get(F_DAEMON_FLOW_ORIGIN_BYTES, {}).get(window, 0.0)}",
            ]
            for d in daemons
        ]
        lines += _table(
            rows,
            ["daemon", "state", f"piece B/s[{window}]", f"b2s/s[{window}]",
             f"p2p B/s[{window}]", f"origin B/s[{window}]"],
        )

    # traffic planes: the flow ledger's per-plane provenance split,
    # summed across the daemons' reported "flows" sections
    planes: dict[str, dict] = {}
    for d in daemons:
        for plane, row in (d.get("flows", {}) or {}).get("planes", {}).items():
            agg = planes.setdefault(
                plane,
                {"origin": 0, "parent": 0, "dedup": 0, "local_cache": 0,
                 "preheat": 0, "served": 0, "upload": 0},
            )
            for prov, n in (row.get("bytes", {}) or {}).items():
                if prov in agg:
                    agg[prov] += int(n)
            agg["served"] += int(row.get("served_bytes", 0))
            agg["upload"] += int(row.get("upload_bytes", 0))
    if planes:
        lines.append("")
        lines.append("traffic planes (cumulative bytes by provenance)")
        rows = []
        for plane in sorted(planes):
            a = planes[plane]
            total = a["origin"] + a["parent"] + a["dedup"] + a["local_cache"] + a["preheat"]
            good = a["parent"] + a["dedup"] + a["local_cache"]
            rows.append(
                [
                    plane,
                    a["origin"], a["parent"], a["dedup"], a["local_cache"],
                    a["preheat"], a["served"], a["upload"],
                    f"{good / total:.2f}" if total else "-",
                ]
            )
        lines += _table(
            rows,
            ["plane", "origin", "parent", "dedup", "local$", "preheat",
             "served", "upload", "p2p_eff"],
        )
    return "\n".join(lines) + "\n"


def main(argv: "list[str] | None" = None) -> int:
    p = argparse.ArgumentParser(
        prog="dfstat",
        description="live cluster view from the manager telemetry plane",
    )
    p.add_argument(
        "--manager", required=True, metavar="HOST:PORT",
        help="manager REST address (or full http:// URL)",
    )
    p.add_argument("--once", action="store_true", help="one frame, no refresh")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument(
        "--window", default="1m", choices=("1m", "5m", "1h"),
        help="rate window rendered in the tables",
    )
    args = p.parse_args(argv)
    while True:
        try:
            frame = render(fetch(args.manager), window=args.window)
        except Exception as e:
            # --once is a probe: fail loudly. The watch mode is the
            # incident view — a manager mid-restart must not kill it,
            # so the error becomes the frame and polling continues.
            if args.once:
                print(f"dfstat: {args.manager} unreachable: {e}", file=sys.stderr)
                return 1
            frame = f"dfstat: {args.manager} unreachable: {e}  (retrying)\n"
        if args.once:
            sys.stdout.write(frame)
            return 0
        # top-like refresh: clear, home, draw
        sys.stdout.write("\x1b[2J\x1b[H" + frame)
        sys.stdout.flush()
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
