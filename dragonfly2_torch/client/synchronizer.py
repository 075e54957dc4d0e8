"""Daemon↔daemon piece-metadata synchronizer: live SyncPieceTasks bidi
streams from a downloading child to each candidate parent (upstream
client/daemon/peer/peertask_piecetask_synchronizer.go, 494 LoC;
counterpart of the reference's ``client/synchronizer.py``).

The scheduler's candidate list carries a STATIC finished_pieces snapshot;
an in-progress parent keeps finishing pieces after that snapshot. The
synchronizer keeps each ParentInfo.finished_pieces fresh over the
parent's dfdaemon gRPC port, so the dispatcher prefers parents that
actually hold a piece instead of probing optimistically and eating 404s.

One thread + one bidi stream per parent; failures degrade silently to
the snapshot (the conductor's optimistic-probe fallback still works).
"""

from __future__ import annotations

import threading

from dragonfly2_torch.rpc import protos
dfdaemon_pb2 = protos.load("dfdaemon_pb2")

from dragonfly2_torch.rpc import glue
from dragonfly2_torch.utils import dflog

logger = dflog.get("client.sync")


class PieceTaskSynchronizer:
    def __init__(
        self,
        task_id: str,
        peer_id: str,
        interval: float = 0.2,
    ):
        self.task_id = task_id
        self.peer_id = peer_id
        self.interval = interval
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._calls: list = []  # live stream handles, cancelled on stop

    # ------------------------------------------------------------------
    def watch(self, parent, daemon_addr: str) -> None:
        """Open a sync stream to ``daemon_addr`` feeding
        ``parent.finished_pieces`` until stop()."""
        if not daemon_addr or daemon_addr.endswith(":0"):
            return
        t = threading.Thread(
            target=self._run,
            args=(parent, daemon_addr),
            name=f"piece-sync-{parent.peer_id[:8]}",
            daemon=True,
        )
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for call in self._calls:
            try:
                call.cancel()  # unblocks a thread stuck on a hung parent
            except Exception as e:
                logger.debug("piece-sync cancel failed: %s", e)
        for t in self._threads:
            t.join(timeout=2.0)

    # ------------------------------------------------------------------
    def _run(self, parent, daemon_addr: str) -> None:
        try:
            channel = glue.dial(daemon_addr, retries=1)
        except Exception as e:
            logger.debug("sync dial %s failed: %s", daemon_addr, e)
            return
        try:
            # target=daemon_addr: per-parent breaker/budget — one dead
            # parent must not trip the others' circuit
            client = glue.ServiceClient(
                channel, glue.DFDAEMON_SERVICE, target=daemon_addr
            )
            first = [True]

            def watermark() -> int:
                # contiguous-prefix watermark: every piece below it is
                # already known, so the parent only re-sends the tail —
                # without this, big tasks re-transfer the whole inventory
                # every poll
                n = 0
                known = parent.finished_pieces
                while n in known:
                    n += 1
                return n

            def requests():
                # paced request loop: each request asks for the parent's
                # inventory above the watermark; stop() ends the stream
                while not self._stop.wait(0 if first[0] else self.interval):
                    first[0] = False
                    yield dfdaemon_pb2.PieceTaskRequest(
                        task_id=self.task_id,
                        src_peer_id=parent.peer_id,
                        dst_peer_id=self.peer_id,
                        start_num=watermark(),
                        limit=0,
                    )

            call = client.SyncPieceTasks(requests())
            self._calls.append(call)
            for packet in call:
                if self._stop.is_set():
                    break
                if packet.piece_infos:
                    # set assignment is atomic enough for the dispatcher's
                    # membership reads (CPython set under the GIL)
                    parent.finished_pieces |= {
                        p.number for p in packet.piece_infos
                    }
        except Exception as e:
            if not self._stop.is_set():
                logger.debug("piece sync with %s ended: %s", parent.peer_id, e)
        finally:
            channel.close()
