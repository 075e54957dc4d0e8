"""Digest helpers (counterpart of the reference's ``utils/digest.py``;
upstream parity: pkg/digest).

Supports the `<algo>:<hex>` digest-string format used across the piece
pipeline and task IDs.
"""

from __future__ import annotations

import hashlib

ALGORITHM_SHA256 = "sha256"
ALGORITHM_MD5 = "md5"

_SUPPORTED = {ALGORITHM_SHA256, ALGORITHM_MD5}
_HEX_LEN = {ALGORITHM_SHA256: 64, ALGORITHM_MD5: 32}
_HEX_CHARS = set("0123456789abcdefABCDEF")


def sha256_from_strings(*parts: str) -> str:
    """Hash the concatenation of ``parts`` (pkg/digest SHA256FromStrings)."""
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode("utf-8"))
    return h.hexdigest()


def sha256_from_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def md5_from_bytes(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


def digest_string(algorithm: str, value: str) -> str:
    """Format a digest as ``algo:hex``."""
    if algorithm not in _SUPPORTED:
        raise ValueError(f"unsupported digest algorithm: {algorithm}")
    return f"{algorithm}:{value}"


def parse_digest(s: str) -> tuple[str, str]:
    """Parse ``algo:hex`` back into (algorithm, value). The value must
    be real hex of the algorithm's digest length — a pin that can never
    match any content (wrong length, non-hex) is malformed input, and
    catching it here means BEFORE a transfer is spent on it."""
    algorithm, sep, value = s.partition(":")
    if not sep or algorithm not in _SUPPORTED or not value:
        raise ValueError(f"invalid digest: {s!r}")
    if len(value) != _HEX_LEN[algorithm] or not set(value) <= _HEX_CHARS:
        raise ValueError(
            f"invalid digest: {s!r} (need {_HEX_LEN[algorithm]} hex chars)"
        )
    return algorithm, value


def verify(data: bytes, expected: str) -> bool:
    algorithm, value = parse_digest(expected)
    if algorithm == ALGORITHM_SHA256:
        return sha256_from_bytes(data) == value
    return md5_from_bytes(data) == value
