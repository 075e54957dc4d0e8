"""Plugin loader (counterpart of the reference's ``utils/dfplugin.py``;
upstream Dragonfly2's internal/dfplugin/dfplugin.go:28-70): imports
modules named ``df_plugin_*.py`` from a plugin directory, each exporting
``dragonfly_plugin_init(registry)``.

A plugin registers extensions on the passed registry:

    def dragonfly_plugin_init(registry):
        registry.register_evaluator("myalgo", lambda: MyEvaluator())

Seam served: the scheduler evaluator (``new_evaluator(algorithm=...)``).
The reference's back-to-source client and cluster-searcher seams come with
the daemon and manager.
"""

from __future__ import annotations

import importlib.util
import threading
from pathlib import Path
from typing import Callable

from dragonfly2_torch.utils import dflog

logger = dflog.get("dfplugin")

PLUGIN_PREFIX = "df_plugin_"
INIT_HOOK = "dragonfly_plugin_init"


class PluginRegistry:
    def __init__(self):
        self.evaluators: dict[str, Callable] = {}
        self._lock = threading.Lock()

    # -- registration hooks handed to plugins ---------------------------
    def register_evaluator(self, name: str, factory: Callable) -> None:
        with self._lock:
            self.evaluators[name] = factory
        logger.info("plugin evaluator registered: %s", name)

    # -- lookups ---------------------------------------------------------
    def evaluator(self, name: str):
        factory = self.evaluators.get(name)
        return factory() if factory is not None else None


registry = PluginRegistry()  # process-wide


def load_plugins(plugin_dir: str | Path) -> list[str]:
    """Import every ``df_plugin_*.py`` under ``plugin_dir`` and call its
    init hook. Returns loaded plugin names; a broken plugin logs and is
    skipped (one bad plugin must not take the service down)."""
    d = Path(plugin_dir)
    if not d.is_dir():
        return []
    loaded = []
    for path in sorted(d.glob(f"{PLUGIN_PREFIX}*.py")):
        name = path.stem
        try:
            spec = importlib.util.spec_from_file_location(name, path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            hook = getattr(module, INIT_HOOK, None)
            if hook is None:
                logger.warning("plugin %s has no %s; skipped", name, INIT_HOOK)
                continue
            hook(registry)
            loaded.append(name)
            logger.info("plugin loaded: %s", name)
        except Exception:
            logger.exception("plugin %s failed to load; skipped", name)
    return loaded
