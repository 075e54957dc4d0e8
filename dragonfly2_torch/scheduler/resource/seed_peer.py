"""Seed-peer client: the scheduler's lever for cold tasks.

Role parity: upstream scheduler/resource/seed_peer.go:92-213 — when a
task has no feedable parents, the scheduler asks a seed-peer daemon to
download it (back-to-source allowed). The seed registers as a peer over
its own announce stream, succeeds, and becomes the first parent for
every waiting child. Also the execution arm of preheat jobs (upstream
scheduler/job/job.go:109-152).

Transport here is the daemon's own Download RPC (our dfdaemon service)
instead of the reference's cdnsystem ObtainSeeds stream.
"""

from __future__ import annotations

import threading

from dragonfly2_torch.rpc import protos

common_pb2 = protos.load("common_pb2")
dfdaemon_pb2 = protos.load("dfdaemon_pb2")

from dragonfly2_torch.utils import dflog

logger = dflog.get("scheduler.seed")


class SeedPeerClient:
    """Triggers seed downloads on seed-type hosts known to the resource
    host manager (announced with type != normal)."""

    def __init__(self, host_manager, timeout: float = 300.0):
        self.host_manager = host_manager
        self.timeout = timeout
        self._inflight: set[str] = set()
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def seed_hosts(self):
        return [h for h in self.host_manager.all() if h.type.is_seed]

    def is_inflight(self, task_id: str) -> bool:
        with self._lock:
            return task_id in self._inflight

    def trigger(
        self,
        task_id: str,
        url: str,
        tag: str = "",
        application: str = "",
        digest: str = "",
        url_filter: str = "",
        url_range: str = "",
    ) -> bool:
        """Start a seed download for ``task_id`` on one seed host (async);
        False when no seed host exists or one is already in flight."""
        seeds = self.seed_hosts()
        if not seeds:
            return False
        with self._lock:
            if task_id in self._inflight:
                return True  # already seeding — callers just retry-wait
            self._inflight.add(task_id)
        # spread tasks over seed hosts by task-id hash so one seed doesn't
        # absorb an entire preheat batch
        host = seeds[int(task_id[:8], 16) % len(seeds)]
        threading.Thread(
            target=self._run,
            args=(host, task_id, url, tag, application, digest, url_filter, url_range),
            name=f"seed-{task_id[:8]}",
            daemon=True,
        ).start()
        return True

    def _run(self, host, task_id, url, tag, application, digest, url_filter, url_range) -> None:
        from dragonfly2_torch.rpc import glue

        try:
            addr = f"{host.ip}:{host.port}"
            channel = glue.dial(addr, retries=2)
            try:
                # target=addr: per-seed-host breaker, not one shared
                # 'Dfdaemon' circuit across every seed peer
                daemon = glue.ServiceClient(
                    channel, glue.DFDAEMON_SERVICE, target=addr
                )
                stream = daemon.Download(
                    dfdaemon_pb2.DownloadRequest(
                        url=url,
                        url_meta=common_pb2.UrlMeta(
                            tag=tag,
                            application=application,
                            digest=digest,
                            filter=url_filter,
                            range=url_range,
                        ),
                        # the seed must go origin-first immediately, not
                        # wait out the scheduler's retry budget
                        need_back_to_source=True,
                    ),
                    timeout=self.timeout,
                )
                for result in stream:
                    if result.done:
                        logger.info(
                            "seed host %s finished task %s (%d bytes)",
                            host.id,
                            task_id[:16],
                            result.content_length,
                        )
                        break
            finally:
                channel.close()
        except Exception as e:
            logger.warning("seed download %s on %s failed: %s", task_id[:16], host.id, e)
        finally:
            with self._lock:
                self._inflight.discard(task_id)
