"""Resumable ingestion offsets (counterpart of the ``OffsetLedger`` half of
the reference's ``trainer/checkpoint.py``).

When a trainer runs incremental rounds (``clear_after_train=False``), the
byte offset consumed per dataset file is committed after a successful
fit, so the next round decodes only newly appended upload rounds. The
same ledger persists the per-file round boundaries the Train stream
marks.

The fit snapshots (the reference's orbax ``FitCheckpointer``) are not
ported yet: a fit configured with a ``checkpoint_dir`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

from dragonfly2_torch.utils import dflog

logger = dflog.get("trainer.ckpt")


class OffsetLedger:
    """Byte offsets consumed per dataset file, committed only after a
    successful fit — a crashed round re-decodes from the previous commit
    (at-least-once ingestion; training is idempotent over a round)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._lock = threading.Lock()
        self._offsets: dict[str, int] = {}
        if self.path.exists():
            try:
                self._offsets = json.loads(self.path.read_text())
            except (OSError, json.JSONDecodeError) as e:
                logger.warning("offset ledger unreadable, starting fresh: %s", e)

    def get(self, key: str) -> int:
        with self._lock:
            return int(self._offsets.get(key, 0))

    def has(self, key: str) -> bool:
        """Whether an entry exists — callers that must distinguish "never
        committed" from "committed at 0" (round-boundary recovery) need
        more than get()'s 0 default."""
        with self._lock:
            return key in self._offsets

    def commit(self, key: str, offset: int) -> None:
        with self._lock:
            self._offsets[key] = int(offset)
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self._offsets, indent=0, sort_keys=True))
            tmp.replace(self.path)

    def reset(self, key: str) -> None:
        """Drop a file's offset (after the file itself is cleared)."""
        with self._lock:
            if key in self._offsets:
                del self._offsets[key]
                tmp = self.path.with_suffix(".tmp")
                tmp.write_text(json.dumps(self._offsets, indent=0, sort_keys=True))
                tmp.replace(self.path)
