"""Interval GC framework (counterpart of the reference's ``utils/gc.py``;
upstream Dragonfly2's pkg/gc/gc.go:28-120).

Named collectors run on their own intervals in one background thread pool;
the scheduler registers peer/task/host collectors, the daemon registers
storage reclamation.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable

logger = logging.getLogger(__name__)


@dataclass
class GCTask:
    id: str
    interval: float
    timeout: float
    runner: Callable[[], None]


class GC:
    def __init__(self) -> None:
        self._tasks: dict[str, GCTask] = {}
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._lock = threading.Lock()

    def add(self, task: GCTask) -> None:
        if task.interval <= 0:
            raise ValueError(f"gc task {task.id}: interval must be positive")
        with self._lock:
            if task.id in self._tasks:
                raise ValueError(f"gc task {task.id} already registered")
            self._tasks[task.id] = task

    def run(self, task_id: str) -> None:
        """Run one collector immediately."""
        with self._lock:
            task = self._tasks.get(task_id)
        if task is None:
            raise KeyError(task_id)
        self._run_task(task)

    def run_all(self) -> None:
        with self._lock:
            tasks = list(self._tasks.values())
        for t in tasks:
            self._run_task(t)

    def start(self) -> None:
        with self._lock:
            tasks = list(self._tasks.values())
        for task in tasks:
            th = threading.Thread(
                target=self._loop, args=(task,), name=f"gc-{task.id}", daemon=True
            )
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=1.0)
        self._threads.clear()

    def _loop(self, task: GCTask) -> None:
        while not self._stop.wait(task.interval):
            self._run_task(task)

    def _run_task(self, task: GCTask) -> None:
        start = time.monotonic()
        try:
            task.runner()
        except Exception:
            logger.exception("gc task %s failed", task.id)
        elapsed = time.monotonic() - start
        if task.timeout and elapsed > task.timeout:
            logger.warning("gc task %s took %.2fs (timeout %.2fs)", task.id, elapsed, task.timeout)
