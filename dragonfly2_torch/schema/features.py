"""Feature/label extraction: records → fixed-shape training tensors (own
copy of the reference's ``schema/features.py``).

- **MLP parent scorer** — one example per (download, parent) pair. The
  feature vector covers everything the upstream default evaluator scores
  (finished-piece ratio, upload success, free upload slots, host type,
  IDC/location affinity) plus host load signals it ignores. The target is
  the observed mean per-piece download cost from that parent (log-ms).
- **GraphSAGE GNN** — nodes are hosts, edges are probe measurements with
  EWMA RTT. Edge target: log-RTT.
- **GRU piece time-series** — per-(download, parent) piece-cost sequences
  (the train block carries them; the GRU fit comes with a later slice).

All functions are vectorized over columnar batches (``schema/columnar.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dragonfly2_torch.schema.records import MAX_DEST_HOSTS, MAX_PARENTS, MAX_PIECES_PER_PARENT

NS_PER_MS = 1e6

MLP_FEATURE_NAMES = (
    "finished_piece_ratio",
    "upload_success_rate",
    "free_upload_ratio",
    "is_seed",
    "idc_match",
    "location_affinity",
    "cpu_percent",
    "mem_used_percent",
    "tcp_connection_log",
    "upload_tcp_connection_log",
    "disk_used_percent",
    "parent_succeeded",
    # full host-stat surface (upstream types.go:59-128 records it all;
    # the default evaluator ignores it — extra signal is the point of
    # the learned scorer). Excluded on purpose: upload_piece_count
    # (pieces served to THIS child — label leakage).
    "cpu_process_percent",
    "mem_available_ratio",
    "inodes_used_percent",
    "child_cpu_percent",
    "child_mem_used_percent",
    "task_size_log",
    # live-topology signal (topology.TopologyEngine): log1p(estimated
    # child→parent RTT ms)/10, 0.0 when no estimate exists. Download
    # records carry no probe RTT, so the offline extraction emits the
    # 0.0 missing-value; the live evaluator fills it from the device
    # adjacency (direct EWMA or landmark-inferred). Appending it bumps
    # MLP_FEATURE_DIM — older models are refused by the evaluator's
    # feature_dim guard and retrain against the new schema.
    "rtt_affinity",
)
MLP_FEATURE_DIM = len(MLP_FEATURE_NAMES)

# Maximum "|"-separated location element depth scored for affinity
# (upstream evaluator_base.go maxElementLen).
MAX_LOCATION_DEPTH = 5


def stack_group(cols: dict[str, np.ndarray], template: str, width: int) -> np.ndarray:
    """Stack per-slot dotted columns ``template.format(i)`` into [N, width]."""
    return np.stack([cols[template.format(i=i)] for i in range(width)], axis=1)


def location_affinity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Shared leading "|"-separated path depth / MAX_LOCATION_DEPTH, elementwise."""
    out = np.zeros(a.shape, dtype=np.float32)
    flat_a, flat_b, flat_o = a.ravel(), b.ravel(), out.ravel()
    # memoize on the (src, dst) string pair — cardinality is tiny vs. N
    cache: dict[tuple[str, str], float] = {}
    for i in range(flat_a.shape[0]):
        key = (flat_a[i], flat_b[i])
        v = cache.get(key)
        if v is None:
            pa, pb = key[0].split("|"), key[1].split("|")
            depth = 0
            if key[0] and key[1]:
                for x, y in zip(pa[:MAX_LOCATION_DEPTH], pb[:MAX_LOCATION_DEPTH]):
                    if x != y:
                        break
                    depth += 1
            v = depth / MAX_LOCATION_DEPTH
            cache[key] = v
        flat_o[i] = v
    return out


@dataclass
class PairExamples:
    """Flattened (download, parent) training pairs."""

    features: np.ndarray  # [M, MLP_FEATURE_DIM] float32
    labels: np.ndarray  # [M] float32 — log1p(mean piece cost, ms)
    download_index: np.ndarray  # [M] int32 — row in the source batch
    num_downloads: int = 0  # source download-record count (for min-record gates)


def extract_pair_features(
    cols: dict[str, np.ndarray], rtt_lookup=None
) -> PairExamples:
    """Vectorized download-record batch → MLP training pairs.

    ``rtt_lookup(child_host_ids [N], parent_host_ids [N, P]) → [N, P]``
    fills the rtt_affinity column from a live source (the scheduler's
    topology engine, which extracts train blocks batch-side next to the
    device adjacency). Without it the column is the 0.0 missing-value —
    the trainer-side CSV fallback and the native decoder have no
    adjacency to join against."""
    if not cols:
        return PairExamples(
            features=np.zeros((0, MLP_FEATURE_DIM), dtype=np.float32),
            labels=np.zeros((0,), dtype=np.float32),
            download_index=np.zeros((0,), dtype=np.int32),
            num_downloads=0,
        )
    n = cols["id"].shape[0]
    P = MAX_PARENTS

    def pg(field: str) -> np.ndarray:
        return stack_group(cols, "parents.{i}." + field, P).astype(np.float64)

    def pg_str(field: str) -> np.ndarray:
        return stack_group(cols, "parents.{i}." + field, P)

    parent_ids = pg_str("id")
    valid_parent = parent_ids != ""

    total_pieces = np.maximum(cols["task.total_piece_count"].astype(np.float64), 1.0)
    finished = pg("finished_piece_count")
    finished_ratio = np.clip(finished / total_pieces[:, None], 0.0, 1.0)

    upload_count = pg("host.upload_count")
    upload_failed = pg("host.upload_failed_count")
    upload_success = (upload_count - upload_failed) / np.maximum(upload_count, 1.0)

    cul = pg("host.concurrent_upload_limit")
    cuc = pg("host.concurrent_upload_count")
    free_upload = np.clip(1.0 - cuc / np.maximum(cul, 1.0), 0.0, 1.0)

    host_type = pg_str("host.type")
    is_seed = (host_type != "normal") & (host_type != "")

    child_idc = np.broadcast_to(cols["host.network.idc"][:, None], (n, P))
    parent_idc = pg_str("host.network.idc")
    idc_match = (child_idc == parent_idc) & (parent_idc != "")

    child_loc = np.broadcast_to(cols["host.network.location"][:, None], (n, P))
    parent_loc = pg_str("host.network.location")
    loc_aff = location_affinity(child_loc, parent_loc)

    cpu = pg("host.cpu.percent") / 100.0
    mem = pg("host.memory.used_percent") / 100.0
    tcp = np.log1p(pg("host.network.tcp_connection_count")) / 10.0
    utcp = np.log1p(pg("host.network.upload_tcp_connection_count")) / 10.0
    disk = pg("host.disk.used_percent") / 100.0
    succeeded = pg_str("state") == "Succeeded"

    cpu_proc = pg("host.cpu.process_percent") / 100.0
    mem_avail = pg("host.memory.available") / np.maximum(pg("host.memory.total"), 1.0)
    inodes = pg("host.disk.inodes_used_percent") / 100.0
    child_cpu = np.broadcast_to(
        (cols["host.cpu.percent"].astype(np.float64) / 100.0)[:, None], (n, P)
    )
    child_mem = np.broadcast_to(
        (cols["host.memory.used_percent"].astype(np.float64) / 100.0)[:, None], (n, P)
    )
    task_size = np.broadcast_to(
        (
            np.log1p(np.maximum(cols["task.content_length"].astype(np.float64), 0.0))
            / 30.0
        )[:, None],
        (n, P),
    )
    # rtt_affinity: records carry no probe RTT themselves — 0.0
    # missing-value unless a live adjacency lookup joins it in
    # (see MLP_FEATURE_NAMES)
    if rtt_lookup is not None:
        rtt_aff = np.asarray(
            rtt_lookup(cols["host.id"], pg_str("host.id")), dtype=np.float64
        )
    else:
        rtt_aff = np.zeros((n, P), dtype=np.float64)

    feats = np.stack(
        [
            finished_ratio,
            upload_success,
            free_upload,
            is_seed.astype(np.float64),
            idc_match.astype(np.float64),
            loc_aff,
            cpu,
            mem,
            tcp,
            utcp,
            disk,
            succeeded.astype(np.float64),
            cpu_proc,
            mem_avail,
            inodes,
            child_cpu,
            child_mem,
            task_size,
            rtt_aff,
        ],
        axis=-1,
    ).astype(np.float32)  # [N, P, F]

    # label: mean piece cost (ns → log1p ms) over that parent's pieces
    piece_cost = np.stack(
        [
            stack_group(cols, "parents.{i}.pieces." + str(j) + ".cost", P)
            for j in range(MAX_PIECES_PER_PARENT)
        ],
        axis=-1,
    ).astype(np.float64)  # [N, P, 10]
    has_cost = piece_cost > 0
    cost_sum = (piece_cost * has_cost).sum(-1)
    cost_cnt = has_cost.sum(-1)
    mean_cost_ms = cost_sum / np.maximum(cost_cnt, 1) / NS_PER_MS
    label = np.log1p(mean_cost_ms).astype(np.float32)  # [N, P]

    mask = valid_parent & (cost_cnt > 0)
    rows, slots = np.nonzero(mask)
    return PairExamples(
        features=feats[rows, slots],
        labels=label[rows, slots],
        download_index=rows.astype(np.int32),
        num_downloads=n,
    )


# ---------------------------------------------------------------------------
# Probe graph for the GNN
# ---------------------------------------------------------------------------

GNN_NODE_FEATURE_NAMES = (
    "is_seed",
    "tcp_connection_log",
    "upload_tcp_connection_log",
    "out_degree_log",
    "in_degree_log",
    "mean_out_rtt_log",
    "mean_in_rtt_log",
)
GNN_NODE_FEATURE_DIM = len(GNN_NODE_FEATURE_NAMES)


@dataclass
class ProbeGraph:
    """Host probe graph in fixed-degree form (dense gathers, static shapes)."""

    node_ids: list[str]
    node_features: np.ndarray  # [N, GNN_NODE_FEATURE_DIM] float32
    edge_src: np.ndarray  # [E] int32
    edge_dst: np.ndarray  # [E] int32
    edge_rtt_log_ms: np.ndarray  # [E] float32
    neighbors: np.ndarray  # [N, K] int32 — sampled in-edge sources, self-padded
    neighbor_mask: np.ndarray  # [N, K] float32
    num_records: int = 0  # source topology-record count (for min-record gates)

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)


def build_probe_graph(
    cols: dict[str, np.ndarray],
    max_degree: int = 16,
    seed: int = 0,
) -> ProbeGraph:
    """Network-topology record batch → probe graph.

    Duplicate (src, dst) measurements keep the latest (records are appended
    over time; the snapshotter already EWMA-smooths RTT per upstream
    probes.go:174-212, so last-write-wins matches its semantics).
    """
    if not cols:
        return ProbeGraph(
            node_ids=[],
            node_features=np.zeros((0, GNN_NODE_FEATURE_DIM), dtype=np.float32),
            edge_src=np.zeros((0,), dtype=np.int32),
            edge_dst=np.zeros((0,), dtype=np.int32),
            edge_rtt_log_ms=np.zeros((0,), dtype=np.float32),
            neighbors=np.zeros((0, max_degree), dtype=np.int32),
            neighbor_mask=np.zeros((0, max_degree), dtype=np.float32),
            num_records=0,
        )
    n = cols["id"].shape[0]
    D = MAX_DEST_HOSTS

    src_ids = cols["host.id"]
    dest_ids = stack_group(cols, "dest_hosts.{i}.id", D)
    dest_rtt = stack_group(cols, "dest_hosts.{i}.probes.average_rtt", D).astype(np.float64)
    dest_types = stack_group(cols, "dest_hosts.{i}.type", D)
    src_types = cols["host.type"]
    src_tcp = cols["host.network.tcp_connection_count"].astype(np.float64)
    src_utcp = cols["host.network.upload_tcp_connection_count"].astype(np.float64)
    dest_tcp = stack_group(cols, "dest_hosts.{i}.network.tcp_connection_count", D).astype(np.float64)
    dest_utcp = stack_group(cols, "dest_hosts.{i}.network.upload_tcp_connection_count", D).astype(np.float64)

    index: dict[str, int] = {}
    node_ids: list[str] = []
    is_seed_l: list[float] = []
    tcp_l: list[float] = []
    utcp_l: list[float] = []

    def intern(hid: str, htype: str, tcp: float, utcp: float) -> int:
        idx = index.get(hid)
        if idx is None:
            idx = len(node_ids)
            index[hid] = idx
            node_ids.append(hid)
            is_seed_l.append(0.0 if htype in ("normal", "") else 1.0)
            tcp_l.append(tcp)
            utcp_l.append(utcp)
        else:
            tcp_l[idx], utcp_l[idx] = tcp, utcp
        return idx

    edge_map: dict[tuple[int, int], float] = {}
    for r in range(n):
        s = intern(src_ids[r], src_types[r], src_tcp[r], src_utcp[r])
        for d in range(D):
            hid = dest_ids[r, d]
            if hid == "":
                continue
            t = intern(hid, dest_types[r, d], dest_tcp[r, d], dest_utcp[r, d])
            rtt = dest_rtt[r, d]
            if rtt > 0:
                edge_map[(s, t)] = rtt

    num_nodes = len(node_ids)
    if edge_map:
        e = np.array(list(edge_map.keys()), dtype=np.int32)
        src, dst = e[:, 0], e[:, 1]
        rtt_ns = np.array(list(edge_map.values()), dtype=np.float64)
    else:
        src = dst = np.zeros((0,), dtype=np.int32)
        rtt_ns = np.zeros((0,), dtype=np.float64)
    rtt_log = np.log1p(rtt_ns / NS_PER_MS).astype(np.float32)

    out_deg = np.bincount(src, minlength=num_nodes).astype(np.float64)
    in_deg = np.bincount(dst, minlength=num_nodes).astype(np.float64)
    out_rtt = np.bincount(src, weights=rtt_log, minlength=num_nodes) / np.maximum(out_deg, 1)
    in_rtt = np.bincount(dst, weights=rtt_log, minlength=num_nodes) / np.maximum(in_deg, 1)

    node_feats = np.stack(
        [
            np.array(is_seed_l, dtype=np.float64),
            np.log1p(np.array(tcp_l)) / 10.0,
            np.log1p(np.array(utcp_l)) / 10.0,
            np.log1p(out_deg),
            np.log1p(in_deg),
            out_rtt,
            in_rtt,
        ],
        axis=-1,
    ).astype(np.float32)

    neighbors, mask = sample_neighbors(src, dst, num_nodes, max_degree, seed)
    return ProbeGraph(
        node_ids=node_ids,
        node_features=node_feats,
        edge_src=src,
        edge_dst=dst,
        edge_rtt_log_ms=rtt_log,
        neighbors=neighbors,
        neighbor_mask=mask,
        num_records=n,
    )


def sample_neighbors(
    src: np.ndarray, dst: np.ndarray, num_nodes: int, k: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-degree in-neighbor table: for each node, up to ``k`` sources of
    its in-edges (GraphSAGE-style sampling). Padded with the node's own
    index so gathers stay in-bounds; the mask zeroes padded slots.

    Fixed [N, K] shape is what lets the aggregation run as dense gathers and
    reductions instead of dynamic sparse ops.
    """
    rng = np.random.default_rng(seed)
    neighbors = np.tile(np.arange(num_nodes, dtype=np.int32)[:, None], (1, k))
    mask = np.zeros((num_nodes, k), dtype=np.float32)
    if len(src):
        order = np.argsort(dst, kind="stable")
        sdst, ssrc = dst[order], src[order]
        starts = np.searchsorted(sdst, np.arange(num_nodes), side="left")
        ends = np.searchsorted(sdst, np.arange(num_nodes), side="right")
        for v in range(num_nodes):
            nbrs = ssrc[starts[v] : ends[v]]
            if len(nbrs) == 0:
                continue
            if len(nbrs) > k:
                nbrs = rng.choice(nbrs, size=k, replace=False)
            neighbors[v, : len(nbrs)] = nbrs
            mask[v, : len(nbrs)] = 1.0
    return neighbors, mask


# ---------------------------------------------------------------------------
# GRU piece time-series (per-(download, parent) piece-cost sequences)
# ---------------------------------------------------------------------------

GRU_FEATURE_DIM = 2  # [log1p(cost_ms), piece position / MAX_PIECES]
GRU_MAX_SEQ = MAX_PIECES_PER_PARENT - 1


@dataclass
class PieceSequences:
    """Per-(download, parent) piece-cost history → next-cost prediction
    examples (the GRU's supervised task; piece costs per parent come from
    the Download record schema, upstream scheduler/storage/types.go:
    143-176 Parent.Pieces[].Cost)."""

    sequences: np.ndarray  # [N, GRU_MAX_SEQ, GRU_FEATURE_DIM] float32
    labels: np.ndarray  # [N] float32 — log1p(next piece cost, ms)
    lengths: np.ndarray  # [N] int32 — valid prefix length per sequence


def extract_piece_sequences(
    cols: dict[str, np.ndarray], min_pieces: int = 2
) -> PieceSequences:
    """Download-record batch → piece-cost sequences: for every parent
    with ≥ ``min_pieces`` recorded piece costs, the first k-1 costs form
    the input sequence and the k-th is the label."""
    empty = PieceSequences(
        sequences=np.zeros((0, GRU_MAX_SEQ, GRU_FEATURE_DIM), np.float32),
        labels=np.zeros((0,), np.float32),
        lengths=np.zeros((0,), np.int32),
    )
    if not cols:
        return empty
    P = MAX_PARENTS
    ids = stack_group(cols, "parents.{i}.id", P)  # [N, P] strings
    costs = np.stack(
        [
            stack_group(cols, "parents.{i}.pieces." + str(j) + ".cost", P)
            for j in range(MAX_PIECES_PER_PARENT)
        ],
        axis=-1,
    ).astype(np.float64)  # [N, P, J]
    valid_piece = costs > 0
    counts = valid_piece.sum(-1)  # [N, P]
    eligible = (ids != "") & (counts >= min_pieces)
    n_idx, p_idx = np.nonzero(eligible)
    if len(n_idx) == 0:
        return empty

    seqs = np.zeros((len(n_idx), GRU_MAX_SEQ, GRU_FEATURE_DIM), np.float32)
    labels = np.zeros((len(n_idx),), np.float32)
    lengths = np.zeros((len(n_idx),), np.int32)
    for out_i, (n, p) in enumerate(zip(n_idx, p_idx)):
        c = costs[n, p][valid_piece[n, p]]  # ordered piece costs, ns
        k = len(c)
        prefix = np.log1p(c[: k - 1] / NS_PER_MS)
        L = min(len(prefix), GRU_MAX_SEQ)
        seqs[out_i, :L, 0] = prefix[:L]
        seqs[out_i, :L, 1] = (np.arange(L) + 1) / MAX_PIECES_PER_PARENT
        labels[out_i] = np.log1p(c[k - 1] / NS_PER_MS)
        lengths[out_i] = L
    return PieceSequences(sequences=seqs, labels=labels, lengths=lengths)
