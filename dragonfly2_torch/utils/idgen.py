"""Task, host and model ids (counterpart of the reference's
``utils/idgen.py``, cut to what the trainer and preheat slices call).
Task ids are content-addressed (sha256 over the url and the ``URLMeta``
fields that take part in identity), so every peer downloading the same
object lands on the same task; host ids are stable per (ip, hostname);
model ids key (type, ip, hostname) so a retrain replaces the same logical
model; peer ids are unique per download attempt. Every content id is the
hex sha256 of the concatenated parts, byte-identical to the reference's.
"""

from __future__ import annotations

import urllib.parse
import uuid
from dataclasses import dataclass, field

from dragonfly2_torch.utils.digest import sha256_from_strings

URL_FILTER_SEPARATOR = "&"


@dataclass
class URLMeta:
    """Download metadata that participates in task identity."""

    digest: str = ""
    tag: str = ""
    range: str = ""
    filter: str = ""
    application: str = ""
    priority: int = 0
    header: dict[str, str] = field(default_factory=dict)


def filter_query(url: str, filters: list[str]) -> str:
    """Strip the named query parameters from ``url``, so volatile ones
    (signatures, timestamps) do not change task identity."""
    if not filters:
        return url
    parsed = urllib.parse.urlsplit(url)
    drop = set(filters)
    kept = [
        (k, v)
        for k, v in urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
        if k not in drop
    ]
    query = urllib.parse.urlencode(kept)
    return urllib.parse.urlunsplit(
        (parsed.scheme, parsed.netloc, parsed.path, query, parsed.fragment)
    )


def task_id_v1(url: str, meta: URLMeta | None = None) -> str:
    if meta is None:
        return sha256_from_strings(url)
    filters = (
        [f for f in meta.filter.split(URL_FILTER_SEPARATOR) if f] if meta.filter.strip() else []
    )
    try:
        u = filter_query(url, filters)
    except Exception:
        u = ""
    data = [u]
    if meta.digest:
        data.append(meta.digest)
    if meta.range:
        data.append(meta.range)
    if meta.tag:
        data.append(meta.tag)
    if meta.application:
        data.append(meta.application)
    return sha256_from_strings(*data)


def host_id_v2(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname)


def peer_id_v2() -> str:
    return str(uuid.uuid4())


def gnn_model_id_v1(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname, "gnn")


def mlp_model_id_v1(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname, "mlp")


def gru_model_id_v1(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname, "gru")


def federated_model_id_v1(cluster: str = "global") -> str:
    """One merged model per federation scope (all uploading hosts)."""
    return sha256_from_strings("federated", cluster, "mlp")
