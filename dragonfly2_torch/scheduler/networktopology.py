"""Network topology: the probe graph the GNN trains on and embeds
(counterpart of the reference's ``scheduler/networktopology.py``, the
engine-backed path only).

The reference keeps the probe graph in a KV store (Redis role) and mirrors
it into a ``topology.TopologyEngine``, its live replica on the device;
``export_records`` reads the engine's adjacency, not the store. The port
has the engine path: a ``NetworkTopology`` over an engine and the
scheduler's host manager. The KV store (probe ingestion, the probe-target
choice, hydration, the KV walk when no engine is attached) and the
snapshot into the scheduler's record storage wait for
``utils/kvstore.py`` and ``scheduler/storage.py`` (ROADMAP queue A item
5b); a KV store raises.
"""

from __future__ import annotations

from dragonfly2_torch.schema import records as R

_KV_NOT_PORTED = (
    "the KV-backed network topology is not ported yet (ROADMAP queue A item 5b):"
    " build NetworkTopology over a topology engine, with kv=None"
)


class NetworkTopology:
    def __init__(self, host_manager, engine=None, kv=None):
        if kv is not None or engine is None:
            raise NotImplementedError(_KV_NOT_PORTED)
        self.host_manager = host_manager
        self.engine = engine  # topology.TopologyEngine

    def export_records(self, dest_limit: int = R.MAX_DEST_HOSTS) -> list:
        """Live probe graph → ``NetworkTopologyRecord`` rows (one per source
        host, up to ``dest_limit`` dest hosts each, the most recently
        updated kept), straight from the engine's adjacency. The snapshot
        sink, the GNN's swap-time embed and seed placement consume this.

        ``dest_limit`` is clamped to the record schema's fixed group width:
        the columnar flatten pads/truncates ``dest_hosts`` to
        ``MAX_DEST_HOSTS``, so a larger limit would be dropped downstream
        rather than widen coverage."""
        dest_limit = min(dest_limit, R.MAX_DEST_HOSTS)
        return self.engine.export_records(self.host_manager, dest_limit)
