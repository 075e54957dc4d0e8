"""HTTP piece downloader — the child side of piece transfer.

Counterpart of the reference's ``client/downloader.py``.

Role parity: upstream client/daemon/peer/piece_downloader.go:165-204 —
``GET parent:uploadPort/download/<task>?peerId=&number=`` fetches one
piece's bytes from the parent's upload server.

Transport: rides the shared readiness-based :mod:`transfer` pool
(bounded keep-alive connections, one selector thread — a piece fetch no
longer pays TCP setup/teardown, and thousands of concurrent transfers
multiplex over a bounded fd set). ``DF_TRANSFER_LOOP=0`` falls back to
per-request urllib.
"""

# dfanalyze: hot — one call per piece on the child download path

from __future__ import annotations

import urllib.error
import urllib.request

from dragonfly2_torch.client import transfer


class PieceDownloadError(Exception):
    """Piece fetch failed. ``not_found`` marks an HTTP 404 — the parent is
    healthy but hasn't written the piece yet (in-progress peer), which
    callers treat as retryable rather than as a bad parent."""

    def __init__(self, msg: str, not_found: bool = False):
        super().__init__(msg)
        self.not_found = not_found


def download_piece(
    parent_addr: str,
    task_id: str,
    number: int,
    peer_id: str = "",
    timeout: float = 30.0,
) -> tuple[bytes, str, str]:
    """Fetch piece ``number`` of ``task_id`` from a parent upload server
    at ``host:port``; returns (bytes, digest, origin_content_type)."""
    target = f"/download/{task_id}?number={number}&peerId={peer_id}"
    pool = transfer.default_pool()
    if pool is None:
        return _download_piece_urllib(parent_addr, target, number, timeout)
    try:
        status, headers, body = pool.fetch(parent_addr, target, timeout=timeout)
    except transfer.TransferError as e:
        raise PieceDownloadError(f"piece {number} from {parent_addr}: {e}") from e
    if status != 200:
        raise PieceDownloadError(
            f"piece {number} from {parent_addr}: HTTP {status}",
            not_found=status == 404,
        )
    return (
        body,
        headers.get("x-dragonfly-piece-digest", ""),
        headers.get("x-dragonfly-origin-content-type", ""),
    )


def release_parents(addrs) -> None:
    """Task finished: let the pool drop idle keep-alive connections to
    these parents (bounds steady-state fd usage in big swarms)."""
    pool = transfer.default_pool()
    if pool is not None:
        pool.release_idle(addrs)


def _download_piece_urllib(
    parent_addr: str, target: str, number: int, timeout: float
) -> tuple[bytes, str, str]:
    url = f"http://{parent_addr}{target}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            data = resp.read()
            digest = resp.headers.get("X-Dragonfly-Piece-Digest", "")
            content_type = resp.headers.get("X-Dragonfly-Origin-Content-Type", "")
            return data, digest, content_type
    except urllib.error.HTTPError as e:
        raise PieceDownloadError(
            f"piece {number} from {parent_addr}: HTTP {e.code}", not_found=e.code == 404
        ) from e
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise PieceDownloadError(f"piece {number} from {parent_addr}: {e}") from e
