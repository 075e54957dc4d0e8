"""Embedded web console (counterpart of the reference's
``manager/console``; role parity: upstream manager/console React
front-end served by the manager, manager/manager.go:61-85). A single
static page with no build step: it drives the same REST API the CLI and
operators use, so everything visible here is reproducible with curl.
The page is this package's own copy, byte for byte the reference's."""

from __future__ import annotations

from pathlib import Path

_HERE = Path(__file__).parent


def index_html() -> bytes:
    return (_HERE / "index.html").read_bytes()
