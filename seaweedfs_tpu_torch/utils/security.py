"""JWT (HS256) write authorization on the standard library; the
counterpart of seaweedfs_tpu/utils/security.py.

Equivalent of SeaweedFS weed/security/jwt.go:30 (per-fid signed tokens
the master hands to clients for volume-server writes) and guard.go:41
(the token check). Tokens are standard JWS compact form:
base64url(header).base64url(payload).base64url(hmac-sha256), without
padding. Header and payload are `json.dumps` with its default
separators, the keys in the order alg, typ and exp, fid, so a token
minted here is byte-equal to the reference's for the same secret, fid
and second.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def sign_jwt(secret: str, fid: str, expires_seconds: int = 10) -> str:
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64(json.dumps({
        "exp": int(time.time()) + expires_seconds,
        "fid": fid,
    }).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64(sig)}"


def verify_jwt(secret: str, token: str, fid: str | None = None) -> dict:
    """-> payload dict; raises PermissionError on any failure."""
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
    except ValueError:
        raise PermissionError("malformed jwt") from None
    signing_input = f"{header_b64}.{payload_b64}".encode()
    expect = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(expect, _unb64(sig_b64)):
        raise PermissionError("jwt signature mismatch")
    payload = json.loads(_unb64(payload_b64))
    if payload.get("exp", 0) < time.time():
        raise PermissionError("jwt expired")
    if fid is not None and payload.get("fid") != fid:
        # exact claim match (volume_server_handlers.go:183): a signed
        # token with a missing or empty fid authorizes no fid
        raise PermissionError("jwt fid mismatch")
    return payload


class Guard:
    """Request guard: with a secret configured, a write needs a valid
    `Authorization: Bearer <token>` for its fid (security/guard.go:41)."""

    def __init__(self, secret: str = ""):
        self.secret = secret

    @property
    def enabled(self) -> bool:
        return bool(self.secret)

    def check(self, auth_header: str | None, fid: str | None = None) -> None:
        if not self.enabled:
            return
        if not auth_header or not auth_header.startswith("Bearer "):
            raise PermissionError("missing jwt")
        if fid is not None and "_" in fid:
            # batch-assign slots ("fid_N") share the base fid's token:
            # the suffix is stripped before the claim comparison
            # (volume_server_handlers.go:181)
            fid = fid[:fid.rfind("_")]
        verify_jwt(self.secret, auth_header[len("Bearer "):], fid)

    def sign(self, fid: str) -> str:
        return sign_jwt(self.secret, fid) if self.enabled else ""
