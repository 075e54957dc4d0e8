"""Host and model ids (counterpart of the reference's ``utils/idgen.py``,
cut to what the trainer slice calls). Host ids are stable per (ip,
hostname); model ids key (type, ip, hostname) so a retrain replaces the
same logical model. Every id is the hex sha256 of the concatenated
parts, byte-identical to the reference's.

The task and peer ids come with the daemon and server slices.
"""

from __future__ import annotations

import hashlib


def sha256_from_strings(*parts: str) -> str:
    """Hash the concatenation of ``parts`` (the reference's
    ``utils/digest.sha256_from_strings``)."""
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode("utf-8"))
    return h.hexdigest()


def host_id_v2(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname)


def gnn_model_id_v1(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname, "gnn")


def mlp_model_id_v1(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname, "mlp")
