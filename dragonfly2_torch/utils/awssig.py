"""AWS Signature V4 (counterpart of the reference's ``utils/awssig.py``;
shared by the s3 back-to-source client and the s3
object-storage driver; upstream pkg/source/clients/s3protocol +
pkg/objectstorage s3 driver both sign the same way through aws-sdk).

Unsigned-payload signing: the body hash is declared UNSIGNED-PAYLOAD,
which S3 accepts for https endpoints and keeps the signer streaming-
friendly (no second pass over piece data).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac


def sigv4_headers(
    method: str,
    host: str,
    path: str,
    query: str,
    region: str,
    access_key: str,
    secret_key: str,
    extra_headers: dict | None = None,
    service: str = "s3",
) -> dict:
    """→ headers dict (without ``host`` — urllib sets it) carrying
    x-amz-date, x-amz-content-sha256 and the Authorization line."""
    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = "UNSIGNED-PAYLOAD"
    headers = {"host": host, "x-amz-content-sha256": payload_hash, "x-amz-date": amz_date}
    headers.update({k.lower(): v for k, v in (extra_headers or {}).items()})
    signed = ";".join(sorted(headers))
    canonical = "\n".join(
        [
            method,
            path,
            query,
            "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
            signed,
            payload_hash,
        ]
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical.encode()).hexdigest(),
        ]
    )

    def hm(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = hm(("AWS4" + secret_key).encode(), datestamp)
    k = hm(k, region)
    k = hm(k, service)
    k = hm(k, "aws4_request")
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    out = dict(headers)
    out["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope},"
        f" SignedHeaders={signed}, Signature={sig}"
    )
    del out["host"]  # urllib sets it
    return out


def oss_sign_headers(
    method: str,
    bucket: str,
    key: str,
    access_key: str,
    secret_key: str,
    content_type: str = "",
) -> dict:
    """Alibaba OSS classic header signature
    (``OSS <key>:<base64 hmac-sha1>``; string-to-sign =
    VERB\\nContent-MD5\\nContent-Type\\nDate\\nResource). The caller must
    send EXACTLY the Content-Type given here — urllib silently adds
    ``application/x-www-form-urlencoded`` to data-carrying requests, so
    writers must pass an explicit type or the signature won't match."""
    import base64
    import email.utils

    # RFC1123 via email.utils — strftime('%a/%b') is locale-dependent and
    # a non-English LC_TIME would render a Date OSS can't parse
    date = email.utils.formatdate(usegmt=True)
    resource = f"/{bucket}/{key}" if key else f"/{bucket}/"
    to_sign = f"{method}\n\n{content_type}\n{date}\n{resource}"
    sig = base64.b64encode(
        hmac.new(secret_key.encode(), to_sign.encode(), hashlib.sha1).digest()
    ).decode()
    out = {"Date": date, "Authorization": f"OSS {access_key}:{sig}"}
    if content_type:
        out["Content-Type"] = content_type
    return out
