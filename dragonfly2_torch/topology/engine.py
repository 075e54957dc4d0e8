"""TopologyEngine: the device-resident probe graph and its query surface
(counterpart of the reference's ``topology/engine.py``).

Lifecycle: ``enqueue`` (delta queue) → ``flush`` (drain, EWMA fold into the
host store, staleness purge, padded CSR build, upload, decay → k-hop →
landmark distances on the device) → queries (``est_rtt_ns``, ``neighbors``,
``rtt_affinity``, ``rtt_affinity_pairs``, ``centrality``, ``stats``) served
from the resident arrays, and ``export_records``, the probe graph as
``NetworkTopologyRecord`` rows (the GNN's swap-time embed reads it).

RTT inference (unprobed pairs): L landmark hosts (highest fresh degree)
keep min-plus distances ``D`` [node_cap, L] to every host, which stays on
the device; est_rtt(a, b) = min over landmarks of d(a,l) + d(l,b). Direct
fresh edges win over inference. The k-hop aggregate comes to the host once
per flush. Counts live in ``stats()`` and in the ``dragonfly_topology_*``
series (``topology/metrics.py``).
"""

from __future__ import annotations

import bisect
import threading
import time
import uuid
from dataclasses import dataclass

import numpy as np
import torch

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.schema import records as R
from dragonfly2_torch.topology import metrics as TM
from dragonfly2_torch.topology.csr import NS_PER_MS, AdjacencyStore
from dragonfly2_torch.topology.delta import DeltaQueue, EdgeDelta
from dragonfly2_torch.topology.kernels import INF_MS, TorchKernels
from dragonfly2_torch.trainer.serving import bucket_rows, pad_batch


@dataclass
class TopologyConfig:
    num_landmarks: int = 8
    landmark_iters: int = 3  # min-plus relaxation rounds ≈ hop radius
    khop: int = 2
    # deltas buffered before an automatic flush
    flush_threshold: int = 256
    # staleness decay: half-life for aggregation weight, hard purge age
    half_life_s: float = 30 * 60.0
    max_age_s: float = 4 * 3600.0
    max_pending: int = 100_000
    inference_cache_size: int = 8192


class TopologyEngine:
    """``clock`` is the engine's wall clock in seconds (``time.time``): a
    flush, purge or export that is given no ``now`` reads it."""

    def __init__(self, config: TopologyConfig | None = None, device="cuda", clock=time.time):
        self.cfg = config or TopologyConfig()
        self.clock = clock
        self.device = resolve_device(device)
        self.kernels = TorchKernels()
        self.store = AdjacencyStore()
        self.deltas = DeltaQueue(self.cfg.max_pending)
        self._lock = threading.RLock()
        # serializes flushes so the kernel work runs outside _lock (queries
        # keep reading the previous arrays meanwhile)
        self._flush_lock = threading.Lock()
        # host numpy CSR/COO build (neighbors() reads it directly); only
        # the copies handed to the kernels live on the device
        self._arrays: dict | None = None
        self._weights: torch.Tensor | None = None  # freshness weights
        self._D: torch.Tensor | None = None  # [node_cap, L] landmark ms
        self._khop_rtt: np.ndarray | None = None  # [node_cap] log-ms, host
        self._landmark_idx: np.ndarray | None = None
        self._flush_count = 0
        self._dropped_seen = 0
        self._last_flush_at = 0.0
        # bumped on every out-of-flush store mutation (adopt, delete_host):
        # a flush whose build predates the bump rebuilds
        self._store_version = 0
        # (src, dest) → (rtt_ns | None, provenance)
        self._cache: dict[tuple[str, str], tuple[float | None, str]] = {}
        self._cache_hits = 0
        self._cache_misses = 0
        self._kernel_pairs = 0  # rtt_affinity_pairs rows sent to the device
        self._query_lat_ms: list[float] = []  # sorted ring for p50

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------
    def enqueue(
        self, src: str, dest: str, rtt_ns: int, created_at: float | None = None
    ) -> None:
        self.deltas.put(
            EdgeDelta(src, dest, rtt_ns, created_at if created_at is not None else self.clock())
        )
        TM.DELTA_QUEUE_GAUGE.set(len(self.deltas))
        if len(self.deltas) >= self.cfg.flush_threshold:
            self.flush()

    def adopt(self, src: str, dest: str, avg_rtt_ns: float, updated_at: float) -> bool:
        """Adopt an already-EWMA'd edge (KV hydration, edges probed via
        other schedulers); newer local state wins."""
        with self._lock:
            adopted = self.store.adopt_edge(src, dest, avg_rtt_ns, updated_at)
            if adopted:
                self._store_version += 1
            return adopted

    def delete_host(self, host_id: str) -> None:
        """Edges, pending deltas and cached inferences touching the host
        all go."""
        with self._lock:
            self.deltas.discard_host(host_id)
            if self.store.purge_host(host_id):
                self._store_version += 1
                self._refresh(self.clock())
            self._cache.clear()

    # ------------------------------------------------------------------
    # flush: deltas → host store → device arrays
    # ------------------------------------------------------------------
    def flush(self, now: float | None = None) -> int:
        """Apply queued deltas and refresh the device arrays → number of
        deltas applied. The rebuild always runs (edge age advances between
        flushes). Kernel work runs outside the query lock."""
        now = self.clock() if now is None else now
        with self._flush_lock:
            t0 = time.perf_counter()
            batch = self.deltas.drain()
            with self._lock:
                for d in batch:
                    self.store.apply_probe(d.src, d.dest, d.rtt_ns, d.created_at)
                purged = self.store.purge_stale(now, self.cfg.max_age_s)
                arr = self._build_arrays(now)
                built_version = self._store_version
            computed = self._run_kernels(arr)
            with self._lock:
                if self._store_version == built_version:
                    self._swap(arr, computed)
                else:
                    # an adopt/delete_host landed mid-kernel: rebuild
                    self._refresh(now)
                self._flush_count += 1
                self._last_flush_at = now
            if purged:
                TM.STALE_PURGED_TOTAL.inc(purged)
            TM.FLUSH_TOTAL.inc()
            TM.FLUSH_LATENCY.observe(time.perf_counter() - t0)
            TM.DELTA_QUEUE_GAUGE.set(len(self.deltas))
            dropped = self.deltas.dropped
            if dropped > self._dropped_seen:
                TM.DELTA_DROPPED_TOTAL.inc(dropped - self._dropped_seen)
                self._dropped_seen = dropped
            return len(batch)

    def _refresh(self, now: float) -> None:
        """Build + kernels + swap in one step (caller holds ``_lock``)."""
        arr = self._build_arrays(now)
        self._swap(arr, self._run_kernels(arr))

    def _build_arrays(self, now: float) -> dict:
        """Padded CSR + landmark selection from the host store (caller
        holds ``_lock``)."""
        prev_ncap = len(self._arrays["row_ptr"]) - 1 if self._arrays else 0
        prev_ecap = len(self._arrays["edge_src"]) if self._arrays else 0
        arr = self.store.build_arrays(now, prev_ncap, prev_ecap)
        ncap = len(arr["row_ptr"]) - 1

        # landmarks: highest fresh-degree live hosts (degree desc, index asc)
        e = arr["num_edges"]
        deg = np.bincount(arr["edge_src"][:e], minlength=ncap) + np.bincount(
            arr["edge_dst"][:e], minlength=ncap
        )
        live = np.zeros(ncap, dtype=bool)
        live[: len(self.store.ids)] = [bool(hid) for hid in self.store.ids]
        deg = np.where(live, deg, -1)
        L = self.cfg.num_landmarks
        order = np.argsort(-deg, kind="stable")[:L]
        lm_idx = np.zeros(L, dtype=np.int32)
        lm_valid = np.zeros(L, dtype=np.float32)
        n_lm = 0
        for idx in order:
            if deg[idx] >= 0 and live[idx]:
                lm_idx[n_lm] = idx
                lm_valid[n_lm] = 1.0
                n_lm += 1
        arr["landmark_idx"] = lm_idx
        arr["landmark_valid"] = lm_valid
        arr["num_landmarks"] = n_lm
        return arr

    def _upload(self, arrays: dict) -> dict:
        """numpy → tensors on the engine's device; index arrays as int64."""
        return {
            k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v).to(
                self.device
            )
            for k, v in arrays.items()
        }

    def _run_kernels(self, arr: dict) -> dict:
        """Decay → k-hop aggregate → landmark distances, on the device."""
        ncap = len(arr["row_ptr"]) - 1
        K = self.kernels
        # symmetrized edge list for distance inference: probes are directed
        # but RTT is (to first order) symmetric, and min-plus needs to
        # traverse an edge both ways; linear ms computed on the host
        rtt_ms = np.expm1(arr["rtt_log_ms"]).astype(np.float32)
        dev = self._upload(
            {
                "src": arr["edge_src"],
                "dst": arr["edge_dst"],
                "rtt_log_ms": arr["rtt_log_ms"],
                "age_s": arr["age_s"],
                "valid": arr["valid"],
                "sym_src": np.concatenate([arr["edge_src"], arr["edge_dst"]]),
                "sym_dst": np.concatenate([arr["edge_dst"], arr["edge_src"]]),
                "sym_rtt": np.concatenate([rtt_ms, rtt_ms]),
                "sym_w": np.concatenate([arr["valid"], arr["valid"]]),
                "li": arr["landmark_idx"],
                "lv": arr["landmark_valid"],
            }
        )
        w = K.decay_weights(dev["age_s"], dev["valid"], self.cfg.half_life_s)
        khop = K.khop_rtt(
            dev["src"], dev["dst"], dev["rtt_log_ms"], w, num_nodes=ncap, k=self.cfg.khop
        )
        D = K.landmark_distances(
            dev["sym_src"], dev["sym_dst"], dev["sym_rtt"], dev["sym_w"],
            dev["li"], dev["lv"], num_nodes=ncap, iters=self.cfg.landmark_iters,
        )
        return {"weights": w, "khop": khop, "D": D}

    def _swap(self, arr: dict, computed: dict) -> None:
        """Install a finished build (caller holds ``_lock``)."""
        self._arrays = arr
        self._weights = computed["weights"]
        # the k-hop aggregate is read one element per query: one copy to
        # the host per flush, not one per query
        self._khop_rtt = computed["khop"].cpu().numpy()
        self._D = computed["D"]
        self._landmark_idx = arr["landmark_idx"][: arr["num_landmarks"]].copy()
        self._cache.clear()
        TM.EDGE_GAUGE.set(self.store.num_edges)
        TM.HOST_GAUGE.set(len(self.store.index))

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def est_rtt_ns(self, src: str, dest: str) -> int | None:
        """Best RTT estimate: direct fresh edge (EWMA) → landmark
        inference → None (host unknown or no path)."""
        return self.est_rtt_detail(src, dest)[0]

    def est_rtt_detail(self, src: str, dest: str) -> tuple[int | None, str]:
        """(rtt_ns, provenance), provenance ∈ {"self", "direct",
        "inferred", "none"}, resolved under one lock."""
        if src == dest:
            return 0, "self"
        t0 = time.perf_counter()
        with self._lock:
            key = (src, dest)
            if key in self._cache:
                self._cache_hits += 1
                TM.QUERY_TOTAL.labels("cache").inc()
                self._note_latency(t0)
                out, source = self._cache[key]
                return self._intify(out), source
            self._cache_misses += 1
            out, source = self._est_rtt_locked(src, dest)
            if len(self._cache) >= self.cfg.inference_cache_size:
                self._cache.clear()
            self._cache[key] = (out, source)
            self._note_latency(t0)
            return self._intify(out), source

    def _est_rtt_locked(self, src: str, dest: str) -> tuple[float | None, str]:
        s = self.store.index.get(src)
        d = self.store.index.get(dest)
        if s is None or d is None:
            TM.QUERY_TOTAL.labels("unknown").inc()
            return None, "none"
        edge = self.store.edges.get((s, d)) or self.store.edges.get((d, s))
        if edge is not None:
            TM.QUERY_TOTAL.labels("direct").inc()
            return float(edge[0]), "direct"
        if self._D is None:
            return None, "none"
        idx = torch.tensor([s, d], dtype=torch.int64, device=self.device)
        est_ms = float(self.kernels.est_from_landmarks(self._D, idx[:1], idx[1:])[0])
        if est_ms >= INF_MS / 2:
            TM.QUERY_TOTAL.labels("no_path").inc()
            return None, "none"
        TM.QUERY_TOTAL.labels("inferred").inc()
        return est_ms * NS_PER_MS, "inferred"

    @staticmethod
    def _intify(v: float | None) -> int | None:
        return None if v is None else int(v)

    def neighbors(self, host_id: str, limit: int = 32) -> list[dict]:
        """Fresh out-edges of ``host_id`` from the CSR rows, nearest first:
        [{host_id, avg_rtt_ns, age_s}]."""
        if self._arrays is None:
            # outside _lock: flush takes _flush_lock → _lock
            self.flush()
        with self._lock:
            idx = self.store.index.get(host_id)
            if idx is None:
                return []
            arr = self._arrays
            row_ptr = arr["row_ptr"]
            lo, hi = int(row_ptr[idx]), int(row_ptr[idx + 1])
            out = []
            for d in arr["edge_dst"][lo:hi]:
                e = self.store.edges.get((idx, int(d)))
                if e is None:
                    continue
                out.append(
                    {
                        "host_id": self.store.ids[int(d)],
                        "avg_rtt_ns": int(e[0]),
                        "age_s": max(self.clock() - e[1], 0.0),
                    }
                )
            out.sort(key=lambda r: r["avg_rtt_ns"])
            return out[:limit]

    def rtt_affinity(self, src: str, dest: str) -> float:
        """The MLP feature: log1p(est RTT in ms)/10, 0.0 when unknown."""
        rtt = self.est_rtt_ns(src, dest)
        if rtt is None:
            return 0.0
        return float(np.log1p(rtt / NS_PER_MS) / 10.0)

    def rtt_affinity_pairs(self, src_ids, dst_ids) -> np.ndarray:
        """[N] src (child) host ids × [N] dst (parent) host ids → [N]
        rtt_affinity in one lock hold and one device gather — the wave-join
        form of :meth:`rtt_affinity` (self → direct fresh edge → landmark
        inference → 0.0), without the per-pair cache. The pair arrays are
        padded to a ladder rung and go up as one [5, rows] upload; the whole
        rung comes back and is sliced on the host."""
        n = len(src_ids)
        out = np.zeros(n, dtype=np.float32)
        if n == 0:
            return out
        need_src = np.zeros(n, dtype=np.int64)
        need_dst = np.zeros(n, dtype=np.int64)
        known = np.zeros(n, dtype=bool)
        direct_ms = np.zeros(n, dtype=np.float32)
        has_direct = np.zeros(n, dtype=bool)
        with self._lock:
            index = self.store.index
            edges = self.store.edges
            D = self._D  # immutable snapshot: _swap installs new tensors
            for i in range(n):
                src, dst = src_ids[i], dst_ids[i]
                if src == dst:
                    # self pair: a 0 ms direct edge ⇒ affinity 0.0
                    known[i] = has_direct[i] = True
                    continue
                s = index.get(src)
                d = index.get(dst)
                if s is None or d is None:
                    continue
                known[i] = True
                edge = edges.get((s, d)) or edges.get((d, s))
                if edge is not None:
                    has_direct[i] = True
                    direct_ms[i] = edge[0] / NS_PER_MS
                else:
                    need_src[i] = s
                    need_dst[i] = d
        if D is None or not bool(np.any(known & ~has_direct)):
            # nothing to infer: direct-only affinity, no device work
            m = known & has_direct
            out[m] = np.log1p(direct_ms[m]) / np.float32(10.0)
            return out
        rows = bucket_rows(n)
        # float64 holds the int64 host indices and the float32 values exactly
        packed = np.stack(
            [
                pad_batch(need_src, rows),
                pad_batch(need_dst, rows),
                pad_batch(direct_ms, rows),
                pad_batch(has_direct.astype(np.float32), rows),
                pad_batch(known.astype(np.float32), rows),
            ]
        ).astype(np.float64)
        dev = torch.from_numpy(packed).to(self.device)
        padded = self.kernels.gather_rtt_affinity(
            D, dev[0].long(), dev[1].long(), dev[2].float(), dev[3].float(), dev[4].float()
        )
        with self._lock:
            self._kernel_pairs += n
        return padded.cpu().numpy()[:n]

    def rtt_affinity_batch(self, child_ids: np.ndarray, parent_ids: np.ndarray) -> np.ndarray:
        """[N] child host ids × [N, P] parent host ids → [N, P]
        rtt_affinity through one flattened :meth:`rtt_affinity_pairs`."""
        child_ids = np.asarray(child_ids)
        parent_ids = np.asarray(parent_ids)
        if parent_ids.size == 0:
            return np.zeros(parent_ids.shape, dtype=np.float32)
        n, p = parent_ids.shape
        src = [str(c) for c in np.repeat(child_ids, p)]
        dst = [str(q) for q in parent_ids.reshape(-1)]
        return self.rtt_affinity_pairs(src, dst).reshape(n, p)

    def centrality(self, candidates: list[str] | None = None) -> list[dict]:
        """Mean inferred RTT from every live host to each candidate,
        ascending (the seed-placement ranking): [{host_id, mean_rtt_ms}].
        No-path pairs are left out of the mean; candidates unreachable from
        everywhere are dropped. The store is snapshot under ``_lock`` and
        the O(C·H) math runs unlocked."""
        if self._arrays is None:
            self.flush()
        with self._lock:
            if self._D is None:
                return []
            D = self._D.cpu().numpy()
            live = list(self.store.index.items())
            index = dict(self.store.index)
            edges = [(s, d, v[0]) for (s, d), v in self.store.edges.items()]
        if not live:
            return []
        pool = (
            [(h, index[h]) for h in candidates if h in index]
            if candidates is not None
            else live
        )
        idxs = np.array([i for _, i in live], dtype=np.int32)
        pos = {int(i): p for p, i in enumerate(idxs)}
        touch: dict[int, list[tuple[int, float]]] = {}
        for s, d, rtt_ns in edges:
            touch.setdefault(s, []).append((d, rtt_ns))
            touch.setdefault(d, []).append((s, rtt_ns))
        out = []
        for hid, i in pool:
            est = np.min(D[idxs] + D[i][None, :], axis=-1)  # [H] landmark est
            for j, rtt_ns in touch.get(i, ()):
                p = pos.get(int(j))
                if p is not None:
                    est[p] = min(est[p], rtt_ns / NS_PER_MS)
            est[pos[int(i)]] = INF_MS  # self is not a fleet member to average
            finite = est[est < INF_MS / 2]
            if len(finite) == 0:
                continue
            out.append({"host_id": hid, "mean_rtt_ms": round(float(finite.mean()), 4)})
        out.sort(key=lambda r: r["mean_rtt_ms"])
        return out

    def khop_rtt_log_ms(self, host_id: str) -> float | None:
        """The k-hop EWMA-RTT aggregate for one host (log-ms)."""
        with self._lock:
            idx = self.store.index.get(host_id)
            if idx is None or self._khop_rtt is None:
                return None
            return float(self._khop_rtt[idx])

    def stats(self) -> dict:
        with self._lock:
            total = self._cache_hits + self._cache_misses
            hit_rate = self._cache_hits / total if total else 0.0
            TM.INFERENCE_CACHE_HIT_RATE.set(hit_rate)
            return {
                "backend": self.kernels.backend,
                "device": str(self.device),
                "hosts": len(self.store.index),
                "edges": self.store.num_edges,
                "pending_deltas": len(self.deltas),
                "dropped_deltas": self.deltas.dropped,
                "flushes": self._flush_count,
                "landmarks": int(len(self._landmark_idx))
                if self._landmark_idx is not None
                else 0,
                "cache_hit_rate": round(hit_rate, 4),
                "kernel_pairs": self._kernel_pairs,
                "query_p50_ms": self.query_p50_ms(),
                "last_flush_at": self._last_flush_at,
            }

    # ------------------------------------------------------------------
    # export: the snapshot path reads the adjacency, not the KV store
    # ------------------------------------------------------------------
    def export_records(self, host_manager, dest_limit: int) -> list:
        """``NetworkTopologyRecord`` rows straight from the host store, one
        per source host known to ``host_manager``, keeping its freshest
        ``dest_limit`` destinations (most recently updated first)."""
        # flush BEFORE taking _lock: flush's order is _flush_lock → _lock,
        # and the reverse would deadlock with a concurrent flusher
        self.flush()
        with self._lock:
            by_src: dict[int, list[tuple[int, list[float]]]] = {}
            for (s, d), v in self.store.edges.items():
                by_src.setdefault(s, []).append((d, [v[0], v[1]]))

            out = []
            now_ns = int(self.clock() * 1e9)
            for s, dests in by_src.items():
                sh = host_manager.load(self.store.ids[s])
                if sh is None:
                    continue
                dests.sort(key=lambda t: -t[1][1])  # most recently updated first
                dest_hosts = []
                for d, v in dests[:dest_limit]:
                    dh = host_manager.load(self.store.ids[d])
                    if dh is None:
                        continue
                    dest_hosts.append(
                        R.DestHost(
                            id=dh.id,
                            type=dh.type.value,
                            hostname=dh.hostname,
                            ip=dh.ip,
                            port=dh.port,
                            network=dh.network,
                            probes=R.ProbesRecord(
                                average_rtt=int(v[0]),
                                created_at=int(v[1] * 1e9),
                                updated_at=int(v[1] * 1e9),
                            ),
                        )
                    )
                if not dest_hosts:
                    continue
                out.append(
                    R.NetworkTopologyRecord(
                        id=str(uuid.uuid4()),
                        host=R.SrcHost(
                            id=sh.id,
                            type=sh.type.value,
                            hostname=sh.hostname,
                            ip=sh.ip,
                            port=sh.port,
                            network=sh.network,
                        ),
                        dest_hosts=dest_hosts,
                        created_at=now_ns,
                    )
                )
            return out

    # ------------------------------------------------------------------
    def _note_latency(self, t0: float) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        bisect.insort(self._query_lat_ms, ms)
        if len(self._query_lat_ms) > 4096:
            # drop extremes pairwise so the ring stays a sample
            self._query_lat_ms = self._query_lat_ms[1:-1]

    def query_p50_ms(self) -> float:
        with self._lock:
            if not self._query_lat_ms:
                return 0.0
            return round(self._query_lat_ms[len(self._query_lat_ms) // 2], 6)
