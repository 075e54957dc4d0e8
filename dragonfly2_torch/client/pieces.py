"""Piece geometry helpers.

Counterpart of the reference's ``client/pieces.py``.

Role parity: upstream pkg/source piece sizing + client piece math —
pieces are fixed-length slices of the object; the last piece may be
short. Default 4 MiB, scaled up for very large objects so piece count
stays bounded (upstream util.ComputePieceSize behavior).
"""

from __future__ import annotations

from dataclasses import dataclass

DEFAULT_PIECE_LENGTH = 4 * 1024 * 1024
MAX_PIECE_COUNT = 2048


def parse_byte_range(spec: str) -> tuple[int, int]:
    """UrlMeta.range → (offset, length); '' → (0, -1) = whole object.
    Accepts the RFC 7233 forms 'lo-hi' (inclusive), 'lo-' (to end), and
    the suffix form '-n' (last n bytes — returned as offset=-n,
    length=-1; resolved against the object length at fetch time), each
    with an optional 'bytes=' prefix (upstream dfget --range passes
    HTTP-style specs)."""
    spec = (spec or "").strip()
    if not spec:
        return 0, -1
    spec = spec.removeprefix("bytes=")
    lo, sep, hi = spec.partition("-")
    lo, hi = lo.strip(), hi.strip()
    if not sep:
        raise ValueError(f"malformed byte range {spec!r}")
    if not lo:
        if not hi.isdigit() or int(hi) == 0:
            raise ValueError(f"malformed suffix range {spec!r}")
        return -int(hi), -1
    if not lo.isdigit() or (hi and not hi.isdigit()):
        raise ValueError(f"malformed byte range {spec!r}")
    start = int(lo)
    if not hi:
        return start, -1
    end = int(hi)
    if end < start:
        raise ValueError(f"range end before start: {spec!r}")
    return start, end - start + 1


def resolve_byte_range(spec: str, total: int) -> "tuple[int, int] | None":
    """Resolve a range spec against a known object size → inclusive
    (offset, end), or None when unsatisfiable (HTTP 416: start past the
    end, or an empty object). Raises ValueError on malformed specs —
    RFC 7233 callers IGNORE those (serve the whole object), they don't
    error."""
    off, ln = parse_byte_range(spec)
    if off < 0:  # suffix: last n bytes, clamped to the object
        off = max(0, total + off)
    if off >= total:
        return None
    end = total - 1 if ln < 0 else min(off + ln - 1, total - 1)
    return off, end


def normalize_byte_range(spec: str) -> str:
    """Canonical form for task identity: '0-1023', 'bytes=0-1023', and
    ' 0-1023' are the SAME slice and must hash to the same task id (the
    cache would otherwise split per spelling); '0-'/'bytes=0-' IS the
    whole object and canonicalizes to '' (one task, not a duplicate
    cache entry). Malformed specs raise here — at task registration,
    not deep in back-to-source."""
    off, ln = parse_byte_range(spec)
    if off == 0 and ln < 0:
        return ""  # whole object — identical to the unranged task
    if off < 0:
        return f"-{-off}"  # suffix form
    return f"{off}-{off + ln - 1}" if ln >= 0 else f"{off}-"


def compute_piece_length(content_length: int) -> int:
    """Default piece size, doubled until piece count ≤ MAX_PIECE_COUNT."""
    if content_length <= 0:
        return DEFAULT_PIECE_LENGTH
    pl = DEFAULT_PIECE_LENGTH
    while content_length / pl > MAX_PIECE_COUNT:
        pl *= 2
    return pl


def piece_count(content_length: int, piece_length: int) -> int:
    if content_length <= 0:
        return 0
    return (content_length + piece_length - 1) // piece_length


@dataclass(frozen=True)
class PieceRange:
    number: int
    offset: int
    length: int


def piece_ranges(content_length: int, piece_length: int) -> list[PieceRange]:
    out = []
    for n in range(piece_count(content_length, piece_length)):
        off = n * piece_length
        out.append(
            PieceRange(number=n, offset=off, length=min(piece_length, content_length - off))
        )
    return out
