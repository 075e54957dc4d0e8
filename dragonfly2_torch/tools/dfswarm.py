"""dfswarm — render a task's live swarm tree from the observatory.

The scheduler's MetricsServer exposes the swarm observatory at
``GET /debug/swarm[?task=]`` (scheduler/swarm.py): per-peer FSM state,
primary parent, depth, piece progress, and the straggler/stuck flags.
dfswarm fetches that snapshot and draws each task's parent tree —
roots (seeds / back-to-source peers) at the top, children indented
under their primary parent, stragglers and stuck peers flagged inline
— the "who is feeding whom, and who is dragging" view a flat peer
table can't give.

Usage:
    python -m dragonfly2_torch.tools.dfswarm --scheduler HOST:METRICS_PORT
        [--task TASK_ID] [--once] [--interval S]

Without ``--once`` the view refreshes every ``--interval`` seconds,
clearing the screen between frames like dfstat.

Failover forensics (``--diff``): after a shard death, the successor's
adoption receipt (``swarm:adopt:<task>``) carries the victim's last
replica export verbatim, and the successor re-journals the adopted
swarm under its own ownership. ``--diff --kv HOST:PORT [--task ID]``
compares the two and names every missing, torn, or orphaned peer —
the "did the swarm survive the kill intact" question, answered
peer-by-peer instead of by a single counter:

    python -m dragonfly2_torch.tools.dfswarm --diff --kv 127.0.0.1:6379
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.parse
import urllib.request


def fetch(scheduler: str, task: "str | None" = None, timeout: float = 5.0) -> dict:
    """GET the observatory snapshot; ``scheduler`` is host:port of the
    scheduler's METRICS listener (or a full http:// URL)."""
    base = scheduler if "://" in scheduler else f"http://{scheduler}"
    url = f"{base.rstrip('/')}/debug/swarm"
    if task:
        url += f"?task={urllib.parse.quote(task)}"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _short(s: str, n: int = 28) -> str:
    return s if len(s) <= n else s[: n - 1] + "…"


def _flags(peer: dict) -> str:
    out = []
    if peer.get("seed"):
        out.append("seed")
    if peer.get("straggler"):
        out.append("STRAGGLER")
    if peer.get("stuck"):
        out.append("STUCK")
    return f" [{','.join(out)}]" if out else ""


def _peer_line(pid: str, peer: dict, prefix: str) -> str:
    rate = peer.get("rate")
    rate_s = f" {rate:.2f}p/s" if isinstance(rate, (int, float)) else ""
    return (
        f"{prefix}{_short(pid)}  {peer.get('state', '?')}"
        f"  pieces={peer.get('pieces', 0)}{rate_s}{_flags(peer)}"
    )


def render_task(task_id: str, view: dict) -> str:
    """One task's tree as a string (pure — tests assert on it)."""
    lines = [
        f"task {_short(task_id, 48)}  peers={view.get('peer_count', 0)}"
        f"  edges={view.get('edges', 0)}  roots={view.get('roots', 0)}"
        f"  coverage={view.get('coverage', 0.0):.2f}"
        f" ({view.get('done_pieces', 0)}/{view.get('total_pieces', 0) or '?'})"
        f"  b2s={view.get('back_to_source', 0)}"
        f"  resched={view.get('reschedules', 0)}"
        + ("" if view.get("consistent", True) else "  !INCONSISTENT")
    ]
    peers = view.get("peers", {})
    children: dict[str, list[str]] = {}
    roots = []
    for pid, p in peers.items():
        parent = p.get("parent")
        if parent is None or parent not in peers:
            roots.append(pid)
        else:
            children.setdefault(parent, []).append(pid)

    def walk(pid: str, depth: int, seen: set) -> None:
        if pid in seen:  # defensive: a torn snapshot must not hang the CLI
            lines.append("  " * depth + f"{_short(pid)}  (cycle)")
            return
        seen.add(pid)
        prefix = "  " * depth + ("└─ " if depth else "")
        lines.append(_peer_line(pid, peers[pid], prefix))
        for child in sorted(children.get(pid, [])):
            walk(child, depth + 1, seen)

    seen: set = set()
    for pid in sorted(roots):
        walk(pid, 0, seen)
    # orphans whose parent chain never reached a root (mid-reschedule)
    for pid in sorted(peers):
        if pid not in seen:
            walk(pid, 0, seen)
    return "\n".join(lines) + "\n"


def render(snap: dict) -> str:
    """The full frame: every task's tree plus the ledger totals."""
    tasks = snap.get("tasks", {})
    if not tasks:
        return "dfswarm: no tasks tracked\n"
    frames = [render_task(tid, view) for tid, view in sorted(tasks.items())]
    footer = (
        f"tasks={snap.get('task_count', 0)}  peers={snap.get('peer_count', 0)}"
        f"  edges={snap.get('edges', 0)}  stragglers={snap.get('stragglers', 0)}"
        f"  stuck={snap.get('stuck', 0)}"
        f"  consistent={snap.get('consistent', True)}\n"
    )
    return "\n".join(frames) + footer


# ---------------------------------------------------------------------------
# --diff: adopted snapshot vs the victim's last replica export
# ---------------------------------------------------------------------------


def diff_replicas(old: dict, new: dict) -> dict:
    """Compare two swarm replica payloads (the victim's last export
    ``old`` against the successor's re-journaled snapshot ``new``) and
    name what did not survive. Pure — the shard-kill soak and the tests
    call this on raw payload dicts.

    Failure classes: ``missing_peers`` (in old, gone from new),
    ``torn_peers`` (piece progress regressed, or state fell back to
    Pending), ``orphaned`` (had a parent, now has none — its feed edge
    was lost). ``moved`` (parent changed to a different live parent —
    a legal reschedule) and ``extra_peers`` (new arrivals) are
    informational. ``conserved`` checks the successor snapshot's own
    integrity identity (edges == peers − roots); ``clean`` is the
    adoption verdict the soak gates on."""
    old_peers = (old.get("obs") or {}).get("peers", {}) if old else {}
    new_peers = (new.get("obs") or {}).get("peers", {}) if new else {}
    missing, torn, orphaned, moved = [], [], [], []
    for pid, op in old_peers.items():
        np = new_peers.get(pid)
        if np is None:
            missing.append(pid)
            continue
        if int(np.get("pieces", 0)) < int(op.get("pieces", 0)) or (
            np.get("state") == "Pending" and op.get("state") != "Pending"
        ):
            torn.append(pid)
        if op.get("parent") is not None:
            if np.get("parent") is None:
                orphaned.append(pid)
            elif np.get("parent") != op.get("parent"):
                moved.append(pid)
    extra = [pid for pid in new_peers if pid not in old_peers]
    roots = sum(1 for p in new_peers.values() if p.get("parent") is None)
    conserved = int((new.get("obs") or {}).get("edges", -1)) == len(new_peers) - roots
    return {
        "missing_peers": sorted(missing),
        "torn_peers": sorted(torn),
        "orphaned": sorted(orphaned),
        "moved": sorted(moved),
        "extra_peers": sorted(extra),
        "conserved": conserved,
        "clean": conserved and not (missing or torn or orphaned),
    }


def render_diff(task_id: str, receipt: dict, new_owner: "str | None",
                d: dict) -> str:
    """One task's adoption diff as a string (pure — tests assert on it)."""
    old = receipt.get("payload") or {}
    old_peers = (old.get("obs") or {}).get("peers", {})
    lines = [
        f"adopt {_short(task_id, 48)}"
        f"  victim={receipt.get('victim', '?')}"
        f"  adopted_by={receipt.get('adopted_by', '?')}"
        f"  epoch={receipt.get('epoch', '?')} seq={receipt.get('seq', '?')}"
        f"  adopt_ms={receipt.get('adopt_ms', '?')}"
        f"  outcome={receipt.get('outcome', '?')}",
        f"  replica now owned by {new_owner or '(not re-journaled)'}",
        f"  peers: old={len(old_peers)}"
        f"  missing={len(d['missing_peers'])} torn={len(d['torn_peers'])}"
        f"  orphaned={len(d['orphaned'])} moved={len(d['moved'])}"
        f"  extra={len(d['extra_peers'])}",
    ]
    for pid in d["missing_peers"]:
        op = old_peers.get(pid, {})
        lines.append(
            f"  missing peer {_short(pid)}  (was {op.get('state', '?')}"
            f" pieces={op.get('pieces', 0)} parent={op.get('parent')})"
        )
    for pid in d["torn_peers"]:
        lines.append(f"  torn peer {_short(pid)}  (progress regressed)")
    for pid in d["orphaned"]:
        op = old_peers.get(pid, {})
        lines.append(
            f"  orphaned peer {_short(pid)}  (parent {op.get('parent')} -> none)"
        )
    for pid in d["moved"]:
        lines.append(f"  moved peer {_short(pid)}  (rescheduled parent)")
    lines.append(
        "  conservation: " + ("OK" if d["conserved"] else "VIOLATED")
    )
    lines.append("  verdict: " + ("CLEAN" if d["clean"] else "TORN"))
    return "\n".join(lines) + "\n"


def run_diff(kv_addr: str, task: "str | None") -> int:
    """Fetch receipts + current replicas from the KV and diff them.
    Exit 0 only when every diffed adoption is clean."""
    from dragonfly2_torch.utils.kvstore import (
        SWARM_REPLICA_INDEX_KEY,
        RemoteKVStore,
        make_swarm_adopt_key,
        make_swarm_replica_key,
    )

    kv = RemoteKVStore(kv_addr)
    try:
        if task:
            tids = [task]
        else:
            tids = sorted((kv.hgetall(SWARM_REPLICA_INDEX_KEY) or {}).keys())
        rc = shown = 0
        for tid in tids:
            raw = kv.get(make_swarm_adopt_key(tid))
            if not raw:
                if task:
                    print(
                        f"dfswarm: no adoption receipt for {tid}",
                        file=sys.stderr,
                    )
                    return 1
                continue
            receipt = json.loads(raw)
            row = kv.hmget(make_swarm_replica_key(tid), ["owner", "data"])
            current = None
            if row and row[1]:
                try:
                    current = json.loads(row[1])
                except ValueError:
                    current = None
            d = diff_replicas(receipt.get("payload") or {}, current or {})
            sys.stdout.write(
                render_diff(tid, receipt, row[0] if row else None, d)
            )
            shown += 1
            if not d["clean"]:
                rc = 1
        if not shown:
            print("dfswarm: no adoption receipts to diff", file=sys.stderr)
            return 1
        return rc
    finally:
        kv.close()


def main(argv: "list[str] | None" = None) -> int:
    p = argparse.ArgumentParser(
        prog="dfswarm",
        description="live swarm-tree view from a scheduler's /debug/swarm",
    )
    p.add_argument(
        "--scheduler", default=None, metavar="HOST:PORT",
        help="scheduler metrics address (or full http:// URL)",
    )
    p.add_argument("--task", default=None, help="limit to one task id")
    p.add_argument("--once", action="store_true", help="one frame, no refresh")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument(
        "--diff", action="store_true",
        help="diff adopted swarm snapshots against their victims' last"
        " replica exports (reads the KV, not the scheduler)",
    )
    p.add_argument(
        "--kv", default=None, metavar="HOST:PORT",
        help="KV address for --diff (the fleet's shared store)",
    )
    args = p.parse_args(argv)
    if args.diff:
        if not args.kv:
            p.error("--diff requires --kv")
        return run_diff(args.kv, args.task)
    if not args.scheduler:
        p.error("--scheduler is required (unless --diff)")
    while True:
        try:
            frame = render(fetch(args.scheduler, args.task))
        except Exception as e:
            if args.once:
                print(
                    f"dfswarm: {args.scheduler} unreachable: {e}", file=sys.stderr
                )
                return 1
            frame = f"dfswarm: {args.scheduler} unreachable: {e}  (retrying)\n"
        if args.once:
            sys.stdout.write(frame)
            return 0
        sys.stdout.write("\x1b[2J\x1b[H" + frame)
        sys.stdout.flush()
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
