"""TTL cache (counterpart of the reference's ``utils/cache.py``; upstream
pkg/cache).

Small thread-safe expiring map used by dynconfig, network topology and the
searcher. Expiry is lazy (checked on read) plus an optional sweep.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterator

NO_EXPIRATION = -1.0


class TTLCache:
    def __init__(self, default_ttl: float = NO_EXPIRATION):
        self._default_ttl = default_ttl
        self._items: dict[str, tuple[Any, float]] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: Any, ttl: float | None = None) -> None:
        ttl = self._default_ttl if ttl is None else ttl
        expires = time.monotonic() + ttl if ttl >= 0 else NO_EXPIRATION
        with self._lock:
            self._items[key] = (value, expires)

    def get(self, key: str) -> tuple[Any, bool]:
        with self._lock:
            item = self._items.get(key)
            if item is None:
                return None, False
            value, expires = item
            if expires != NO_EXPIRATION and time.monotonic() > expires:
                del self._items[key]
                return None, False
            return value, True

    def delete(self, key: str) -> None:
        with self._lock:
            self._items.pop(key, None)

    def keys(self) -> Iterator[str]:
        now = time.monotonic()
        with self._lock:
            return iter(
                [
                    k
                    for k, (_, exp) in self._items.items()
                    if exp == NO_EXPIRATION or exp >= now
                ]
            )

    def sweep(self) -> int:
        """Drop expired entries; returns how many were removed."""
        now = time.monotonic()
        with self._lock:
            dead = [
                k
                for k, (_, exp) in self._items.items()
                if exp != NO_EXPIRATION and exp < now
            ]
            for k in dead:
                del self._items[k]
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
