"""Diagnose gRPC service: the flight recorder's live query surface.

One unary RPC snapshots this process's event rings (utils/flight) plus
runtime state — thread stacks, per-ring drop counts, registered probes
(queue depths, topology engine stats) — without restarting the service
or touching its sample rates. All four server assemblies bind it;
``tools/dfdoctor.py --rpc host:port`` is the collecting client.
"""

from __future__ import annotations

import json
import os

from dragonfly2_torch.rpc import protos
from dragonfly2_torch.rpc.glue import DIAGNOSE_SERVICE as SERVICE_NAME  # noqa: F401
from dragonfly2_torch.utils import flight, profiling

diagnose_pb2 = protos.load("diagnose_pb2")


class DiagnoseService:
    def __init__(self, recorder: "flight.FlightRecorder | None" = None):
        self.recorder = recorder or flight.recorder()

    def Diagnose(self, request, context):
        rec = self.recorder
        categories = list(request.categories) or None
        snap = {
            "service": rec.service,
            "pid": os.getpid(),
            "rings": rec.snapshot(categories),
            "runtime": rec.runtime_state(include_stacks=request.include_stacks),
        }
        try:
            # the dfprof capture (tools/dfprof.py --rpc): sampler stats,
            # collapsed stacks, phase ledger — never fatal to Diagnose
            snap["profile"] = profiling.profile_snapshot()
        except Exception as e:
            snap["profile_error"] = str(e)
        return diagnose_pb2.DiagnoseResponse(
            service=rec.service,
            pid=os.getpid(),
            snapshot_json=json.dumps(snap, default=str),
        )
