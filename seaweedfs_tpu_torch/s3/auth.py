"""S3 request authentication: AWS Signature V4 + legacy V2 + the
identity/action model; the counterpart of seaweedfs_tpu/s3/auth.py,
copied as is (its signatures must match the reference's byte for byte).

Equivalent of SeaweedFS weed/s3api/auth_signature_v4.go (header and
presigned-query SigV4 verification), auth_signature_v2.go:32 (legacy
header + presigned V2, still emitted by old SDKs), and
auth_credentials.go (the `IdentityAccessManagement` identity ->
credentials -> actions model, hot-reloadable config).

Identities config (JSON, same shape idea as s3.configure):
  {"identities": [{"name": "admin",
                   "credentials": [{"accessKey": "K", "secretKey": "S"}],
                   "actions": ["Admin"]}]}
Actions: Admin, Read, Write, List, Tagging — optionally scoped
":bucket" (e.g. "Read:public-bucket"). No identities -> open access.
"""
from __future__ import annotations

import hashlib
import hmac
import threading
import urllib.parse
from datetime import datetime, timedelta, timezone

ALGORITHM = "AWS4-HMAC-SHA256"
MAX_CLOCK_SKEW_SECONDS = 15 * 60

# query subresources that participate in the V2 canonicalized
# resource — EXACTLY auth_signature_v2.go:39 resourceList (notably,
# no "tagging": adding anything the clients don't sign 403s them)
V2_SUBRESOURCES = (
    "acl", "delete", "lifecycle", "location", "logging", "notification",
    "partNumber", "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type",
    "response-expires", "torrent", "uploadId", "uploads",
    "versionId", "versioning", "versions", "website",
)

ACTION_ADMIN = "Admin"
ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_LIST = "List"
ACTION_TAGGING = "Tagging"


class S3AuthError(Exception):
    def __init__(self, code: str, message: str, status: int = 403):
        super().__init__(message)
        self.code = code
        self.status = status


class StreamingContext:
    """Everything needed to verify + decode an aws-chunked body after
    header authentication (chunked_reader_v4.go newSignV4ChunkedReader).
    `key` is None for STREAMING-UNSIGNED-PAYLOAD-TRAILER."""

    def __init__(self, key: bytes | None, amz_date: str, scope: str,
                 seed_signature: str, decoded_length: int | None = None):
        self.key = key
        self.amz_date = amz_date
        self.scope = scope
        self.seed_signature = seed_signature
        self.decoded_length = decoded_length

    def decode(self, payload: bytes) -> bytes:
        from .chunked import ChunkSignatureError, decode_chunked
        try:
            return decode_chunked(
                payload, key=self.key, amz_date=self.amz_date,
                scope=self.scope, seed_signature=self.seed_signature,
                expected_length=self.decoded_length)
        except ChunkSignatureError as e:
            raise S3AuthError("SignatureDoesNotMatch", str(e))


class Identity:
    def __init__(self, name: str, credentials: list[dict],
                 actions: list[str]):
        self.name = name
        self.credentials = credentials
        self.actions = set(actions)

    def allows(self, action: str, bucket: str) -> bool:
        if ACTION_ADMIN in self.actions:
            return True
        return action in self.actions or \
            f"{action}:{bucket}" in self.actions


class IdentityAccessManagement:
    def __init__(self, config: dict | None = None):
        self._lock = threading.Lock()
        self._identities: list[Identity] = []
        self._by_access_key: dict[str, tuple[Identity, str]] = {}
        if config:
            self.load_config(config)

    @property
    def is_open(self) -> bool:
        with self._lock:
            return not self._identities

    def load_config(self, config: dict) -> None:
        """Replace all identities (hot reload — the reference reloads on
        s3.configure metadata events, auth_credentials_subscribe.go)."""
        identities, by_key = [], {}
        for id_cfg in config.get("identities", []):
            ident = Identity(id_cfg.get("name", ""),
                             id_cfg.get("credentials", []),
                             id_cfg.get("actions", []))
            identities.append(ident)
            for cred in ident.credentials:
                by_key[cred["accessKey"]] = (ident, cred["secretKey"])
        with self._lock:
            self._identities = identities
            self._by_access_key = by_key

    def lookup(self, access_key: str) -> tuple[Identity, str]:
        with self._lock:
            found = self._by_access_key.get(access_key)
        if found is None:
            raise S3AuthError("InvalidAccessKeyId",
                              f"access key {access_key!r} not found")
        return found

    # -- request verification -------------------------------------------
    def authenticate(self, method: str, path: str, query: dict[str, str],
                     headers: dict[str, str],
                     payload_hash: str) -> Identity | None:
        """Verify a request; returns the Identity (None if open mode).
        Raises S3AuthError on bad signatures."""
        return self.authenticate_ctx(method, path, query, headers,
                                     payload_hash)[0]

    def authenticate_ctx(
            self, method: str, path: str, query: dict[str, str],
            headers: dict[str, str], payload_hash: str,
    ) -> tuple[Identity | None, "StreamingContext | None"]:
        """Like authenticate(), but also returns a StreamingContext when
        the request body is aws-chunked framed (signed or unsigned
        streaming) and must be decoded before use."""
        from .chunked import STREAMING_UNSIGNED

        declared = headers.get(
            "x-amz-content-sha256",
            headers.get("X-Amz-Content-Sha256", ""))
        if "X-Amz-Signature" in query or "X-Amz-Algorithm" in query:
            return self._verify_presigned(method, path, query,
                                          headers), None
        if "Signature" in query and "AWSAccessKeyId" in query:
            return self._verify_presigned_v2(method, path, query,
                                             headers), None
        auth = headers.get("Authorization", "")
        if auth.startswith(ALGORITHM):
            identity, ctx = self._verify_header(
                method, path, query, headers, payload_hash, auth)
            return identity, ctx
        if auth.startswith("AWS ") and ":" in auth:
            return self._verify_header_v2(method, path, query,
                                          headers, auth), None
        if self.is_open:
            ctx = None
            if declared == STREAMING_UNSIGNED:
                ctx = StreamingContext(None, "", "", "")
            return None, ctx
        raise S3AuthError("AccessDenied", "no credentials provided")

    # -- Signature V2 (auth_signature_v2.go:32) -------------------------
    def _string_to_sign_v2(self, method: str, path: str,
                           query: dict[str, str],
                           headers: dict[str, str],
                           expires_or_date: str) -> str:
        """The legacy V2 string-to-sign, matching
        auth_signature_v2.go:312 getStringToSignV2 exactly: method,
        content-md5, content-type, date (Expires for presigned, else
        the Date header), canonicalized x-amz-* headers (x-amz-date
        INCLUDED — clients sign it), canonicalized resource (path +
        the resourceList subresources in list order)."""
        h = {k.lower(): v for k, v in headers.items()}
        amz = "\n".join(
            f"{k}:{h[k].strip()}" for k in sorted(h)
            if k.startswith("x-amz-"))
        if amz:
            amz += "\n"
        resource = urllib.parse.quote(path, safe="/~._-")
        parts = [(f"{k}={query[k]}" if query[k] else k)
                 for k in V2_SUBRESOURCES if k in query]
        if parts:
            resource += "?" + "&".join(parts)
        return "\n".join([
            method,
            h.get("content-md5", ""),
            h.get("content-type", ""),
            expires_or_date,
            amz,
        ]) + resource

    @staticmethod
    def _sig_v2(secret: str, sts: str) -> str:
        import base64

        return base64.b64encode(hmac.new(
            secret.encode(), sts.encode(), hashlib.sha1).digest()
        ).decode()

    def _verify_header_v2(self, method, path, query, headers,
                          auth) -> Identity:
        """`Authorization: AWS <accessKey>:<base64 hmac-sha1>`."""
        access_key, _, got = auth[len("AWS "):].partition(":")
        identity, secret = self.lookup(access_key)
        h = {k.lower(): v for k, v in headers.items()}
        # the date line is always the Date header; a client's
        # x-amz-date rides the canonicalized amz headers instead
        sts = self._string_to_sign_v2(method, path, query, headers,
                                      h.get("date", ""))
        if not hmac.compare_digest(self._sig_v2(secret, sts), got):
            raise S3AuthError("SignatureDoesNotMatch",
                              "v2 signature mismatch")
        return identity

    def _verify_presigned_v2(self, method, path, query,
                             headers) -> Identity:
        """?AWSAccessKeyId=..&Expires=<unix>&Signature=<b64>."""
        identity, secret = self.lookup(query["AWSAccessKeyId"])
        expires = query.get("Expires", "")
        try:
            if datetime.now(timezone.utc).timestamp() > float(expires):
                raise S3AuthError("AccessDenied",
                                  "presigned V2 request has expired")
        except ValueError:
            raise S3AuthError("AccessDenied", "bad Expires") from None
        sts = self._string_to_sign_v2(method, path, query, headers,
                                      expires)
        if not hmac.compare_digest(self._sig_v2(secret, sts),
                                   query.get("Signature", "")):
            raise S3AuthError("SignatureDoesNotMatch",
                              "v2 signature mismatch")
        return identity

    def _verify_header(self, method, path, query, headers, payload_hash,
                       auth) -> tuple[Identity, "StreamingContext | None"]:
        from .chunked import (STREAMING_SIGNED, STREAMING_UNSIGNED,
                              signing_key)
        fields = {}
        for part in auth[len(ALGORITHM):].strip().split(","):
            k, _, v = part.strip().partition("=")
            fields[k] = v
        cred_parts = fields.get("Credential", "").split("/")
        if len(cred_parts) != 5:
            raise S3AuthError("AuthorizationHeaderMalformed",
                              "bad Credential")
        access_key, datestamp, region, service, _ = cred_parts
        identity, secret = self.lookup(access_key)
        signed_headers = fields.get("SignedHeaders", "").split(";")
        amz_date = headers.get("x-amz-date") or headers.get("X-Amz-Date", "")
        # the declared payload hash must match the actual body, or a
        # captured signature authorizes arbitrary substituted bodies.
        # Streaming uploads declare a sentinel instead: the body is
        # integrity-checked per chunk by the signature chain.
        declared = headers.get(
            "x-amz-content-sha256",
            headers.get("X-Amz-Content-Sha256", payload_hash))
        streaming = declared in (STREAMING_SIGNED, STREAMING_UNSIGNED)
        if not streaming and declared != "UNSIGNED-PAYLOAD" \
                and declared != payload_hash:
            raise S3AuthError("XAmzContentSHA256Mismatch",
                              "payload hash does not match body", 400)
        # SigV4 requires rejecting stale requests or any captured
        # signed request replays forever
        try:
            t = datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(
                tzinfo=timezone.utc)
        except ValueError:
            raise S3AuthError("AccessDenied", "missing/bad x-amz-date")
        skew = abs((datetime.now(timezone.utc) - t).total_seconds())
        if skew > MAX_CLOCK_SKEW_SECONDS:
            raise S3AuthError("RequestTimeTooSkewed",
                              f"request time skewed by {skew:.0f}s")
        payload_hash = declared
        creq = _canonical_request(method, path, query, headers,
                                  signed_headers, payload_hash)
        scope = f"{datestamp}/{region}/{service}/aws4_request"
        expect = _signature(secret, amz_date, scope, creq)
        if not hmac.compare_digest(expect, fields.get("Signature", "")):
            raise S3AuthError("SignatureDoesNotMatch",
                              "signature mismatch")
        ctx = None
        if streaming:
            decoded_len = headers.get(
                "x-amz-decoded-content-length",
                headers.get("X-Amz-Decoded-Content-Length", ""))
            if not decoded_len.isdigit():
                raise S3AuthError("MissingContentLength",
                                  "streaming upload must declare "
                                  "x-amz-decoded-content-length", 411)
            key = signing_key(secret, datestamp, region, service) \
                if declared == STREAMING_SIGNED else None
            ctx = StreamingContext(key, amz_date, scope, expect,
                                   int(decoded_len))
        return identity, ctx

    def _verify_presigned(self, method, path, query, headers) -> Identity:
        q = dict(query)
        sig = q.pop("X-Amz-Signature", "")
        cred_parts = q.get("X-Amz-Credential", "").split("/")
        if len(cred_parts) != 5:
            raise S3AuthError("AuthorizationQueryParametersError",
                              "bad X-Amz-Credential")
        access_key, datestamp, region, service, _ = cred_parts
        identity, secret = self.lookup(access_key)
        amz_date = q.get("X-Amz-Date", "")
        try:
            t = datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(
                tzinfo=timezone.utc)
            expires = int(q.get("X-Amz-Expires", "900"))
        except ValueError as e:
            raise S3AuthError("AuthorizationQueryParametersError", str(e))
        if datetime.now(timezone.utc) > t + timedelta(seconds=expires):
            raise S3AuthError("AccessDenied", "request has expired")
        signed_headers = q.get("X-Amz-SignedHeaders", "host").split(";")
        creq = _canonical_request(method, path, q, headers,
                                  signed_headers, "UNSIGNED-PAYLOAD")
        scope = f"{datestamp}/{region}/{service}/aws4_request"
        expect = _signature(secret, amz_date, scope, creq)
        if not hmac.compare_digest(expect, sig):
            raise S3AuthError("SignatureDoesNotMatch",
                              "signature mismatch")
        return identity


def _canonical_request(method: str, path: str, query: dict[str, str],
                       headers: dict[str, str],
                       signed_headers: list[str],
                       payload_hash: str) -> str:
    canonical_uri = urllib.parse.quote(path, safe="/-_.~")
    q_items = sorted((urllib.parse.quote(k, safe="-_.~"),
                      urllib.parse.quote(str(v), safe="-_.~"))
                     for k, v in query.items())
    canonical_query = "&".join(f"{k}={v}" for k, v in q_items)
    lower = {k.lower(): " ".join(str(v).split())
             for k, v in headers.items()}
    signed_headers = sorted(h.lower() for h in signed_headers)
    canonical_headers = "".join(
        f"{h}:{lower.get(h, '')}\n" for h in signed_headers)
    return "\n".join([method.upper(), canonical_uri, canonical_query,
                      canonical_headers, ";".join(signed_headers),
                      payload_hash])


def _signature(secret: str, amz_date: str, scope: str, creq: str) -> str:
    from .chunked import signing_key

    sts = "\n".join([ALGORITHM, amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    datestamp, region, service, _ = scope.split("/")
    k = signing_key(secret, datestamp, region, service)
    return hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()


def sign_request(method: str, url: str, access_key: str, secret: str,
                 region: str = "us-east-1",
                 payload: bytes = b"",
                 extra_headers: dict | None = None,
                 content_sha256: str | None = None) -> dict[str, str]:
    """Client-side SigV4 header signing (for tests and the shell's s3
    commands). Returns headers to attach. `content_sha256` overrides
    the payload hash (e.g. the STREAMING-* sentinels)."""
    parsed = urllib.parse.urlsplit(url)
    query = dict(urllib.parse.parse_qsl(parsed.query,
                                        keep_blank_values=True))
    now = datetime.now(timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = content_sha256 or hashlib.sha256(payload).hexdigest()
    headers = {"host": parsed.netloc, "x-amz-date": amz_date,
               "x-amz-content-sha256": payload_hash}
    if extra_headers:
        headers.update({k.lower(): v for k, v in extra_headers.items()})
    signed = sorted(headers)
    creq = _canonical_request(method, parsed.path or "/", query, headers,
                              signed, payload_hash)
    scope = f"{datestamp}/{region}/s3/aws4_request"
    sig = _signature(secret, amz_date, scope, creq)
    headers["Authorization"] = (
        f"{ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return headers


def presign_url(method: str, url: str, access_key: str, secret: str,
                region: str = "us-east-1", expires: int = 900) -> str:
    """Generate a presigned URL (client side)."""
    parsed = urllib.parse.urlsplit(url)
    now = datetime.now(timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    scope = f"{datestamp}/{region}/s3/aws4_request"
    q = dict(urllib.parse.parse_qsl(parsed.query, keep_blank_values=True))
    q.update({
        "X-Amz-Algorithm": ALGORITHM,
        "X-Amz-Credential": f"{access_key}/{scope}",
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
    })
    headers = {"host": parsed.netloc}
    creq = _canonical_request(method, parsed.path or "/", q, headers,
                              ["host"], "UNSIGNED-PAYLOAD")
    sig = _signature(secret, amz_date, scope, creq)
    q["X-Amz-Signature"] = sig
    return urllib.parse.urlunsplit(
        (parsed.scheme, parsed.netloc, parsed.path,
         urllib.parse.urlencode(q), ""))
