"""Dynconfig: cached dynamic-config fetcher with disk fallback (counterpart
of the reference's ``utils/dynconfig.py``).

Role parity: upstream internal/dynconfig/dynconfig.go:45-110 — services
poll the manager for cluster-scoped config on an interval; results are
cached in memory and mirrored to disk so a manager outage degrades to
the last known config instead of an error; observers are notified when
the data changes (upstream scheduler/config/dynconfig.go:107-119).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Callable

from dragonfly2_torch.utils import dflog

logger = dflog.get("dynconfig")

DEFAULT_REFRESH_INTERVAL = 10.0


class Dynconfig:
    """Generic engine: ``fetch()`` produces a JSON-serializable dict."""

    def __init__(
        self,
        fetch: Callable[[], dict],
        cache_path: str | Path | None = None,
        refresh_interval: float = DEFAULT_REFRESH_INTERVAL,
    ):
        self._fetch = fetch
        self.cache_path = Path(cache_path) if cache_path else None
        self.refresh_interval = refresh_interval
        self._data: dict | None = None
        self._fetched_at = 0.0
        self._lock = threading.Lock()
        self._observers: list[Callable[[dict], None]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def get(self) -> dict:
        """Current config: cached while fresh; refreshed when expired; on
        fetch failure falls back to the previous value, then the disk
        cache, then {}."""
        with self._lock:
            if (
                self._data is not None
                and time.monotonic() - self._fetched_at < self.refresh_interval
            ):
                return self._data
        return self.refresh()

    def refresh(self) -> dict:
        try:
            data = self._fetch()
        except Exception as e:
            logger.warning("dynconfig fetch failed: %s", e)
            with self._lock:
                if self._data is not None:
                    return self._data
            disk = self._load_disk()
            with self._lock:
                self._data = disk
                self._fetched_at = time.monotonic()
            return disk

        changed = False
        with self._lock:
            if data != self._data:
                changed = True
            self._data = data
            self._fetched_at = time.monotonic()
        if changed:
            self._store_disk(data)
            for ob in list(self._observers):
                try:
                    ob(data)
                except Exception:
                    logger.exception("dynconfig observer failed")
        return data

    # ------------------------------------------------------------------
    def register(self, observer: Callable[[dict], None]) -> None:
        """Observer fires on every change (and immediately when data is
        already present)."""
        self._observers.append(observer)
        with self._lock:
            data = self._data
        if data is not None:
            observer(data)

    # -- background refresh ---------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="dynconfig", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        # skip the initial refresh when a recent get()/refresh() already
        # fetched — start() right after a bootstrap fetch must not hit
        # the source twice within milliseconds
        with self._lock:
            fresh = (
                self._data is not None
                and time.monotonic() - self._fetched_at < self.refresh_interval
            )
        if not fresh:
            self.refresh()
        while not self._stop.wait(self.refresh_interval):
            self.refresh()

    def fetch_once(self) -> dict:
        """One direct fetch WITHOUT the failure fallbacks — callers that
        must distinguish source-unreachable from source-empty use this
        (get()/refresh() intentionally swallow into cache/{})."""
        return self._fetch()

    # -- disk cache ------------------------------------------------------
    def _store_disk(self, data: dict) -> None:
        if self.cache_path is None:
            return
        try:
            self.cache_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.cache_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(data))
            tmp.replace(self.cache_path)
        except OSError as e:
            logger.warning("dynconfig disk cache write failed: %s", e)

    def _load_disk(self) -> dict:
        if self.cache_path is None or not self.cache_path.exists():
            return {}
        try:
            return json.loads(self.cache_path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            logger.warning("dynconfig disk cache unreadable: %s", e)
            return {}


# ---------------------------------------------------------------------------
# Service-facing wrappers
# ---------------------------------------------------------------------------


class SchedulerDynconfig:
    """Scheduler-side view: polls the manager's cluster config and exposes
    the live scheduling limits (consumed per-schedule, upstream
    scheduling.go:405-413 via scheduler/config/dynconfig.go)."""

    def __init__(
        self,
        manager_client,  # glue.ServiceClient of the manager service
        cluster_id: int = 0,
        cache_path: str | Path | None = None,
        refresh_interval: float = DEFAULT_REFRESH_INTERVAL,
    ):
        from dragonfly2_torch.rpc import protos

        manager_pb2 = protos.load("manager_pb2")

        def fetch() -> dict:
            resp = manager_client.GetSchedulerClusterConfig(
                manager_pb2.GetSchedulerClusterConfigRequest(
                    scheduler_cluster_id=cluster_id
                )
            )
            data: dict[str, Any] = {
                "candidate_parent_limit": resp.candidate_parent_limit,
                "filter_parent_limit": resp.filter_parent_limit,
            }
            if resp.json:
                try:
                    data.update(json.loads(resp.json))
                except json.JSONDecodeError:
                    pass
            return data

        self.engine = Dynconfig(fetch, cache_path, refresh_interval)

    # the attribute surface Scheduling reads
    @property
    def candidate_parent_limit(self) -> int:
        return int(self.engine.get().get("candidate_parent_limit", 0) or 0)

    @property
    def filter_parent_limit(self) -> int:
        return int(self.engine.get().get("filter_parent_limit", 0) or 0)

    def register(self, observer: Callable[[dict], None]) -> None:
        self.engine.register(observer)

    def start(self) -> None:
        self.engine.start()

    def stop(self) -> None:
        self.engine.stop()


class DaemonDynconfig:
    """Daemon-side view: polls the manager for the active scheduler list
    (upstream client/config/dynconfig_manager.go) so daemons fail over
    when schedulers come and go. Location hints scope the list through
    the manager's searcher (the joining daemon gets its best cluster)."""

    def __init__(
        self,
        manager_client,
        cache_path: str | Path | None = None,
        refresh_interval: float = DEFAULT_REFRESH_INTERVAL,
        hostname: str = "",
        ip: str = "",
        idc: str = "",
        location: str = "",
    ):
        from dragonfly2_torch.rpc import protos

        manager_pb2 = protos.load("manager_pb2")

        def fetch() -> dict:
            resp = manager_client.ListSchedulers(
                manager_pb2.ListSchedulersRequest(
                    hostname=hostname, ip=ip, idc=idc, location=location
                )
            )
            return {
                "schedulers": [
                    {"hostname": s.hostname, "ip": s.ip, "port": s.port}
                    for s in resp.schedulers
                ]
            }

        self.engine = Dynconfig(fetch, cache_path, refresh_interval)

    @staticmethod
    def addresses_of(data: dict) -> list[str]:
        """data dict → dialable addresses (rows missing ip/port dropped)."""
        return [
            f"{s['ip']}:{s['port']}"
            for s in (data or {}).get("schedulers", [])
            if s.get("ip") and s.get("port")
        ]

    def scheduler_addresses(self) -> list[str]:
        return self.addresses_of(self.engine.get())

    def fetch_once(self) -> dict:
        """Direct fetch without fallbacks (distinguishes unreachable from
        empty — see Dynconfig.fetch_once)."""
        return self.engine.fetch_once()

    def register(self, observer: Callable[[dict], None]) -> None:
        self.engine.register(observer)

    def start(self) -> None:
        self.engine.start()

    def stop(self) -> None:
        self.engine.stop()
