"""Training-record schemas (own copy of the reference's
``schema/records.py``): the host-stat shapes the scheduler's resource
model holds, and the download and network-topology records the trainer
reads. Nested repeated groups are fixed-width — up to 20 parents per
download, 10 pieces per parent, 5 probed destination hosts per topology
row — which is what makes the records tensorize into static shapes.

Records round-trip through flat dotted-key dicts (``parents.3.host.cpu.percent``)
for CSV, and through columnar numpy blocks (``schema/columnar.py``,
``schema/wire.py``) for the trainer's path.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field, fields
from typing import Any, get_args, get_origin, get_type_hints

# Fixed repeated-group widths (upstream types.go csv[] tags: parents=20,
# pieces=10, destHosts=5).
MAX_PARENTS = 20
MAX_PIECES_PER_PARENT = 10
MAX_DEST_HOSTS = 5


@dataclass
class CPUTimes:
    user: float = 0.0
    system: float = 0.0
    idle: float = 0.0
    nice: float = 0.0
    iowait: float = 0.0
    irq: float = 0.0
    softirq: float = 0.0
    steal: float = 0.0
    guest: float = 0.0
    guest_nice: float = 0.0


@dataclass
class CPU:
    logical_count: int = 0
    physical_count: int = 0
    percent: float = 0.0
    process_percent: float = 0.0
    times: CPUTimes = field(default_factory=CPUTimes)


@dataclass
class Memory:
    total: int = 0
    available: int = 0
    used: int = 0
    used_percent: float = 0.0
    process_used_percent: float = 0.0
    free: int = 0


@dataclass
class Network:
    tcp_connection_count: int = 0
    upload_tcp_connection_count: int = 0
    location: str = ""
    idc: str = ""


@dataclass
class Disk:
    total: int = 0
    free: int = 0
    used: int = 0
    used_percent: float = 0.0
    inodes_total: int = 0
    inodes_used: int = 0
    inodes_free: int = 0
    inodes_used_percent: float = 0.0


@dataclass
class Build:
    git_version: str = ""
    git_commit: str = ""
    go_version: str = ""
    platform: str = ""


@dataclass
class HostRecord:
    id: str = ""
    type: str = "normal"
    hostname: str = ""
    ip: str = ""
    port: int = 0
    download_port: int = 0
    os: str = ""
    platform: str = ""
    platform_family: str = ""
    platform_version: str = ""
    kernel_version: str = ""
    concurrent_upload_limit: int = 0
    concurrent_upload_count: int = 0
    upload_count: int = 0
    upload_failed_count: int = 0
    cpu: CPU = field(default_factory=CPU)
    memory: Memory = field(default_factory=Memory)
    network: Network = field(default_factory=Network)
    disk: Disk = field(default_factory=Disk)
    build: Build = field(default_factory=Build)
    scheduler_cluster_id: int = 0
    created_at: int = 0
    updated_at: int = 0


@dataclass
class TaskRecord:
    id: str = ""
    url: str = ""
    type: str = ""
    content_length: int = 0
    total_piece_count: int = 0
    back_to_source_limit: int = 0
    back_to_source_peer_count: int = 0
    state: str = ""
    created_at: int = 0
    updated_at: int = 0


@dataclass
class PieceRecord:
    length: int = 0
    cost: int = 0  # nanoseconds spent downloading the piece
    created_at: int = 0


@dataclass
class ParentRecord:
    id: str = ""
    tag: str = ""
    application: str = ""
    state: str = ""
    cost: int = 0
    upload_piece_count: int = 0
    finished_piece_count: int = 0
    host: HostRecord = field(default_factory=HostRecord)
    pieces: list[PieceRecord] = field(default_factory=list)
    created_at: int = 0
    updated_at: int = 0


@dataclass
class ErrorInfo:
    code: str = ""
    message: str = ""


@dataclass
class DownloadRecord:
    """One finished (or failed) peer download — the MLP training example
    source (written by the scheduler on ReportPeerResult, upstream
    service_v1.go:1418-1632)."""

    id: str = ""
    tag: str = ""
    application: str = ""
    state: str = ""
    error: ErrorInfo = field(default_factory=ErrorInfo)
    cost: int = 0
    finished_piece_count: int = 0
    task: TaskRecord = field(default_factory=TaskRecord)
    host: HostRecord = field(default_factory=HostRecord)
    parents: list[ParentRecord] = field(default_factory=list)
    created_at: int = 0
    updated_at: int = 0


@dataclass
class ProbesRecord:
    average_rtt: int = 0  # nanoseconds
    created_at: int = 0
    updated_at: int = 0


@dataclass
class SrcHost:
    id: str = ""
    type: str = "normal"
    hostname: str = ""
    ip: str = ""
    port: int = 0
    network: Network = field(default_factory=Network)


@dataclass
class DestHost:
    id: str = ""
    type: str = "normal"
    hostname: str = ""
    ip: str = ""
    port: int = 0
    network: Network = field(default_factory=Network)
    probes: ProbesRecord = field(default_factory=ProbesRecord)


@dataclass
class NetworkTopologyRecord:
    """One probe-graph snapshot row — the GNN training example source
    (written by the topology snapshotter, upstream
    network_topology.go:325-436)."""

    id: str = ""
    host: SrcHost = field(default_factory=SrcHost)
    dest_hosts: list[DestHost] = field(default_factory=list)
    created_at: int = 0


# ---------------------------------------------------------------------------
# Flat (dotted-key) round-trip — powers the CSV codec and columnar layout.
# ---------------------------------------------------------------------------

_LIST_WIDTHS = {
    (DownloadRecord, "parents"): (MAX_PARENTS, ParentRecord),
    (ParentRecord, "pieces"): (MAX_PIECES_PER_PARENT, PieceRecord),
    (NetworkTopologyRecord, "dest_hosts"): (MAX_DEST_HOSTS, DestHost),
}


def _is_record(t: Any) -> bool:
    return dataclasses.is_dataclass(t) and isinstance(t, type)


@functools.lru_cache(maxsize=None)
def _hints(cls: type) -> dict[str, Any]:
    """get_type_hints re-evaluates annotations on every call — far too
    slow for the per-record hot path; one resolution per class."""
    return get_type_hints(cls)


@functools.lru_cache(maxsize=None)
def _flat_plan(cls: type) -> tuple:
    """Compiled flatten schedule per record class: (name, kind, extra)
    rows, with the flat form of a default-constructed list element
    precomputed so padding costs a dict-update, not an object graph."""
    plan = []
    hints = _hints(cls)
    for f in fields(cls):
        hint = hints[f.name]
        if get_origin(hint) is list:
            width, elem_cls = _LIST_WIDTHS[(cls, f.name)]
            empty_flat = tuple(flatten(elem_cls()).items())
            plan.append((f.name, "list", (width, empty_flat)))
        elif _is_record(hint):
            plan.append((f.name, "record", None))
        else:
            plan.append((f.name, "scalar", None))
    return tuple(plan)


def flatten(rec: Any, prefix: str = "", skip_padding: bool = False) -> dict[str, Any]:
    """Flatten a record into dotted keys; fixed-width lists are padded with
    default-constructed elements so every row has identical columns.

    ``skip_padding`` OMITS the padding columns instead (the CSV writer pairs
    it with ``DictWriter(restval="")`` so padding serializes as EMPTY cells,
    not ``"0"``s). Lossless: ``unflatten``'s ``_coerce`` reads ``""`` as the
    field default and ``_trim_padding`` already drops trailing default-equal
    elements, and the decoders key parent validity on a non-empty id
    (features.py:120, native empty-slot fast-forward). Empty cells shrink
    rows ~17% and let the native scanner's tail short-circuit skip the
    padding bytes entirely — the delta vs upstream's gocsv (which
    serializes zero-values as ``"0"``, upstream scheduler/storage
    types.go) is documented in PARITY.md."""
    out: dict[str, Any] = {}
    for name, kind, extra in _flat_plan(type(rec)):
        key = f"{prefix}{name}"
        value = getattr(rec, name)
        if kind == "list":
            width, empty_flat = extra
            for i, item in enumerate(value[:width]):
                out.update(flatten(item, prefix=f"{key}.{i}.", skip_padding=skip_padding))
            if not skip_padding:
                for i in range(len(value), width):
                    p = f"{key}.{i}."
                    for k, v in empty_flat:
                        out[p + k] = v
        elif kind == "record":
            out.update(flatten(value, prefix=f"{key}.", skip_padding=skip_padding))
        else:
            out[key] = value
    return out


def unflatten(cls: type, row: dict[str, Any], prefix: str = "") -> Any:
    """Rebuild a record from dotted keys, coercing strings from CSV."""
    kwargs: dict[str, Any] = {}
    hints = _hints(cls)
    for f in fields(cls):
        key = f"{prefix}{f.name}"
        hint = hints[f.name]
        if get_origin(hint) is list:
            width, elem_cls = _LIST_WIDTHS[(cls, f.name)]
            items = [unflatten(elem_cls, row, prefix=f"{key}.{i}.") for i in range(width)]
            kwargs[f.name] = _trim_padding(items, elem_cls)
        elif _is_record(hint):
            kwargs[f.name] = unflatten(hint, row, prefix=f"{key}.")
        else:
            raw = row.get(key, "")
            kwargs[f.name] = _coerce(hint, raw)
    return cls(**kwargs)


@functools.lru_cache(maxsize=None)
def _empty_element(elem_cls: type) -> Any:
    """The element an all-empty-cells row slice unflattens to. Differs from
    ``elem_cls()`` where a string field has a non-empty default (e.g.
    HostRecord.type == "normal"): the CSV writer omits padding cells
    entirely (flatten ``skip_padding``), so they read back as ``""``, not
    the field default."""
    return unflatten(elem_cls, {})


def _trim_padding(items: list, elem_cls: type) -> list:
    # Two padding spellings: default-constructed elements (pre-empty-cell
    # files, where gocsv-style "0"s round-trip to defaults) and all-empty
    # cells (current writer). Both are semantically invalid as real
    # elements — parent/dest validity keys on a non-empty id everywhere.
    defaults = (elem_cls(), _empty_element(elem_cls))
    while items and (items[-1] == defaults[0] or items[-1] == defaults[1]):
        items.pop()
    return items


def _coerce(hint: Any, raw: Any) -> Any:
    origin = get_origin(hint)
    if origin is not None:  # e.g. Optional — treat as str passthrough
        args = [a for a in get_args(hint) if a is not type(None)]
        hint = args[0] if args else str
    if isinstance(raw, hint):
        return raw
    if raw == "" or raw is None:
        return hint()
    if hint is int:
        try:
            return int(raw)  # exact for >2^53 (nanosecond timestamps)
        except ValueError:
            return int(float(raw))  # "3.0"-style strings
    if hint is float:
        return float(raw)
    return hint(raw)


def headers(cls: type) -> list[str]:
    """Stable column order for a record class."""
    return list(flatten(cls()).keys())
