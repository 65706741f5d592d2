"""Client-side AWS SigV4 signer for talking TO S3-compatible endpoints;
the counterpart of seaweedfs_tpu/s3/sigv4_client.py (the server-side
verifier lives in s3/auth.py). Used by s3/client.py, and so by the
remote tier (storage/backend.py S3BackendStorage, remote_storage/ "s3");
compatible with the gateway's verifier and with AWS. One departure: a
query value the url already escapes (`prefix=tier-ec%2Fc%2F7`) is
decoded before it is escaped for the canonical request, as AWS and
both gateways do; the reference escapes it twice. The POST-policy
helpers sign and verify a browser form's policy document.
"""
from __future__ import annotations

import hashlib
import hmac
from datetime import datetime, timezone
from urllib.parse import quote, unquote, urlsplit


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_headers(method: str, url: str, access_key: str,
                 secret_key: str, payload: bytes = b"",
                 region: str = "us-east-1",
                 service: str = "s3",
                 unsigned_payload: bool = False) -> dict:
    """-> headers dict carrying a SigV4 Authorization for `url`.

    `unsigned_payload=True` signs with x-amz-content-sha256 =
    UNSIGNED-PAYLOAD (the standard escape hatch for streamed bodies
    whose hash isn't known up front, e.g. tier uploads of multi-GB
    .dat files)."""
    parts = urlsplit(url)
    host = parts.netloc
    path = quote(parts.path or "/", safe="/~._-")
    now = datetime.now(timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = ("UNSIGNED-PAYLOAD" if unsigned_payload
                    else hashlib.sha256(payload).hexdigest())

    # canonical query: sorted key=value with rfc3986 escaping of the
    # DECODED names and values (the reference re-escapes the url's own
    # %XX, so a signed ListObjectsV2 with prefix=a%2Fb fails with 403)
    q = []
    if parts.query:
        for kv in parts.query.split("&"):
            k, _, v = kv.partition("=")
            q.append((quote(unquote(k), safe="~._-"),
                      quote(unquote(v), safe="~._-")))
    q.sort()
    canonical_query = "&".join(f"{k}={v}" for k, v in q)

    headers = {"host": host, "x-amz-date": amz_date,
               "x-amz-content-sha256": payload_hash}
    signed = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n"
                                for k in sorted(headers))
    creq = "\n".join([method.upper(), path, canonical_query,
                      canonical_headers, signed, payload_hash])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    key = _hmac(_hmac(_hmac(_hmac(
        ("AWS4" + secret_key).encode(), datestamp), region), service),
        "aws4_request")
    signature = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={signature}"),
    }


def verify_policy_signature(policy_b64: str, credential: str,
                            signature: str, secret: str) -> bool:
    """Verify a POST-policy SigV4 signature: the string-to-sign is the
    base64 policy itself, signed with the standard derived key
    (post-policy-fanout of auth_signature_v4.go)."""
    parts = credential.split("/")
    if len(parts) != 5:
        return False
    _ak, datestamp, region, service, terminal = parts
    if terminal != "aws4_request":
        return False
    key = _hmac(_hmac(_hmac(_hmac(
        ("AWS4" + secret).encode(), datestamp), region), service),
        "aws4_request")
    want = hmac.new(key, policy_b64.encode(),
                    hashlib.sha256).hexdigest()
    return hmac.compare_digest(want, signature)


def sign_policy(policy_b64: str, access_key: str, secret: str,
                region: str = "us-east-1",
                datestamp: str | None = None) -> dict:
    """Client side: produce the form fields for a POST-policy upload."""
    import time as _time
    datestamp = datestamp or _time.strftime("%Y%m%d", _time.gmtime())
    credential = f"{access_key}/{datestamp}/{region}/s3/aws4_request"
    key = _hmac(_hmac(_hmac(_hmac(
        ("AWS4" + secret).encode(), datestamp), region), "s3"),
        "aws4_request")
    sig = hmac.new(key, policy_b64.encode(),
                   hashlib.sha256).hexdigest()
    return {"policy": policy_b64,
            "x-amz-credential": credential,
            "x-amz-algorithm": "AWS4-HMAC-SHA256",
            "x-amz-date": f"{datestamp}T000000Z",
            "x-amz-signature": sig}
