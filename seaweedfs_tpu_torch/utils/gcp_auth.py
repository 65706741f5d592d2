"""Google OAuth2 token source for the GCP REST clients
(remote_storage/gcs_client.py); the counterpart of
seaweedfs_tpu/utils/gcp_auth.py.

Modes: static token / metadata-server token URL (GCE workload
identity) / service-account JSON key, whose RFC 7523 JWT grant is
RS256-signed in-tree (utils/rs256.py) — no google-auth SDK. Requests go
through rpc/httpclient's per-thread session unless the caller hands one
in; the grant's form body is the bytes `requests` sends for a dict.
"""
from __future__ import annotations

import base64
import json
import time
from urllib.parse import urlencode

from ..rpc.httpclient import session as _thread_session

TOKEN_URL = "https://oauth2.googleapis.com/token"


class GcpTokenSource:
    def __init__(self, session=None, token: str = "", token_url: str = "",
                 credentials_file: str = "",
                 scope: str = "https://www.googleapis.com/auth/"
                              "cloud-platform"):
        self._sess = session
        self._token_url = token_url
        self._scope = scope
        self._sa = None
        if credentials_file:
            with open(credentials_file) as f:
                self._sa = json.load(f)
        self._token = token
        self._token_exp = float("inf") if token else 0.0

    def _session(self):
        return self._sess if self._sess is not None else _thread_session()

    def headers(self) -> dict:
        """-> {"Authorization": ...} (empty dict = anonymous)."""
        if time.time() < self._token_exp - 60:
            return {"Authorization": f"Bearer {self._token}"} \
                if self._token else {}
        if self._token_url:
            r = self._session().get(self._token_url,
                                    headers={"Metadata-Flavor": "Google"},
                                    timeout=30)
            r.raise_for_status()
            d = r.json()
            self._token = d["access_token"]
            self._token_exp = time.time() + float(
                d.get("expires_in", 3600))
        elif self._sa is not None:
            self._token, self._token_exp = self._jwt_grant()
        else:
            return {}
        return {"Authorization": f"Bearer {self._token}"}

    def _jwt_grant(self) -> tuple[str, float]:
        """OAuth2 JWT bearer grant signed with the service account's
        RSA key (what google-auth does under the hood)."""
        from . import rs256

        def b64(b: bytes) -> bytes:
            return base64.urlsafe_b64encode(b).rstrip(b"=")

        now = int(time.time())
        header = b64(json.dumps(
            {"alg": "RS256", "typ": "JWT"}).encode())
        token_uri = self._sa.get("token_uri", TOKEN_URL)
        claims = b64(json.dumps({
            "iss": self._sa["client_email"], "scope": self._scope,
            "aud": token_uri, "iat": now, "exp": now + 3600,
        }).encode())
        signing_input = header + b"." + claims
        sig = rs256.sign(self._sa["private_key"], signing_input)
        assertion = (signing_input + b"." + b64(sig)).decode()
        r = self._session().post(token_uri, data=urlencode({
            "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
            "assertion": assertion}), headers={
            "Content-Type": "application/x-www-form-urlencoded"},
            timeout=30)
        r.raise_for_status()
        d = r.json()
        return d["access_token"], time.time() + float(
            d.get("expires_in", 3600))
