"""TLS for the HTTP and websocket plane; the counterpart of
seaweedfs_tpu/utils/tls.py.

Equivalent of SeaweedFS weed/security/tls.go: the reference loads
per-component cert / key / ca from security.toml and wires mutual TLS
into its gRPC channels. Here the transport is HTTP(S), so the same
configuration becomes ssl.SSLContext objects handed to the servers
(rpc/http.py `ServerThread(ssl_context=)`) and, client-side, trust
through the standard env vars (REQUESTS_CA_BUNDLE, SSL_CERT_FILE) that
rpc/httpclient.py honours.

Config shape (JSON, the reference's `scaffold -config=security`):

    {"https": {"cert": "/path/server.crt", "key": "/path/server.key",
               "ca": "/path/ca.crt", "client_auth": false}}

`ca` + `client_auth: true` enables mutual TLS: only clients bearing a
certificate signed by that CA may connect.

generate_self_signed() mints a throwaway CA + server pair (tests,
quick starts) with the openssl binary: the reference's fall-back path.
Its first path, the `cryptography` package, is not taken, since the
port imports nothing past the standard library, numpy, torch and
triton.
"""
from __future__ import annotations

import json
import os
import ssl
import subprocess


def load_security_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def server_ssl_context(cert: str, key: str, ca: str = "",
                       client_auth: bool = False) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    if ca:
        ctx.load_verify_locations(ca)
        if client_auth:
            ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_ssl_context(ca: str = "", cert: str = "",
                       key: str = "") -> ssl.SSLContext:
    ctx = ssl.create_default_context(cafile=ca or None)
    if cert:
        ctx.load_cert_chain(cert, key or None)
    return ctx


def context_from_config(conf: dict) -> ssl.SSLContext | None:
    https = conf.get("https", {})
    if not https.get("cert"):
        return None
    return server_ssl_context(https["cert"], https["key"],
                              ca=https.get("ca", ""),
                              client_auth=https.get("client_auth", False))


def generate_self_signed(out_dir: str, cn: str = "localhost",
                         sans: tuple[str, ...] = ("localhost",
                                                  "127.0.0.1")) -> dict:
    """Mint ca.crt/ca.key + server.crt/server.key (+ client pair)
    under out_dir; returns the path map."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {n: os.path.join(out_dir, f)
             for n, f in (("ca_cert", "ca.crt"), ("ca_key", "ca.key"),
                          ("cert", "server.crt"), ("key", "server.key"),
                          ("client_cert", "client.crt"),
                          ("client_key", "client.key"))}
    _generate_with_openssl(paths, cn, sans)
    return paths


def _generate_with_openssl(paths: dict, cn: str,
                           sans: tuple[str, ...]) -> None:
    san = ",".join(
        (f"IP:{s}" if s.replace(".", "").isdigit() else f"DNS:{s}")
        for s in sans)

    def run(*a, **kw):
        subprocess.run(a, check=True, capture_output=True, **kw)

    run("openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
        "ec_paramgen_curve:prime256v1", "-keyout", paths["ca_key"],
        "-out", paths["ca_cert"], "-days", "7", "-nodes",
        "-subj", "/CN=seaweedfs-test-ca")
    for cert_p, key_p in ((paths["cert"], paths["key"]),
                          (paths["client_cert"], paths["client_key"])):
        csr = cert_p + ".csr"
        run("openssl", "req", "-newkey", "ec", "-pkeyopt",
            "ec_paramgen_curve:prime256v1", "-keyout", key_p,
            "-out", csr, "-nodes", "-subj", f"/CN={cn}")
        run("openssl", "x509", "-req", "-in", csr, "-CA",
            paths["ca_cert"], "-CAkey", paths["ca_key"],
            "-CAcreateserial", "-out", cert_p, "-days", "7",
            "-extfile", "/dev/stdin",
            input=f"subjectAltName={san}".encode())
        os.remove(csr)
