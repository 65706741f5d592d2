"""The port's outbound S3 client (s3/sigv4_client.py, s3/client.py)
against the JAX package's (tolerance 0).

* `sign_headers` byte-equal to the reference's for the same request at
  a pinned clock: GET with a query, signed and UNSIGNED-PAYLOAD PUTs,
  keys that need escaping, other regions and services. A query value
  the url already escapes (`prefix=tier-ec%2Fc%2F7`) is the one
  departure: the reference escapes it twice and both gateways refuse
  its signature; the port signs it as the reference signs the
  unescaped query.
* Each package's `S3Client` against each package's gateway (four
  pairs, SigV4-signed): bucket listing, put, ranged gets, head, a
  streamed put, download_to, ListObjectsV2 with a prefix, delete; every
  pair gives the same answers and the same bytes, but the reference's
  prefixed listing (403, the fault above).
* The port's `put_stream` sends its file-like body in BODY_BLOCK pieces
  with a Content-Length (never chunked), on a connection of its own.
"""
import datetime as _dt
import hashlib
import threading

import numpy as np
import pytest
import requests

from seaweedfs_tpu.s3 import client as ref_client
from seaweedfs_tpu.s3 import sigv4_client as ref_sigv4
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.rpc import httpclient
from seaweedfs_tpu_torch.rpc.http import App, Response, ServerThread
from seaweedfs_tpu_torch.s3 import client as port_client
from seaweedfs_tpu_torch.s3 import sigv4_client as port_sigv4
from seaweedfs_tpu_torch.server.cluster import Cluster

SEED = 20261017
AK, SK = "TIERAK", "tier-secret"
CFG = {"identities": [
    {"name": "admin", "credentials": [{"accessKey": AK, "secretKey": SK}],
     "actions": ["Admin"]}]}
CLIENTS = {"reference": ref_client.S3Client, "port": port_client.S3Client}


class _Clock(_dt.datetime):
    """datetime with now() pinned, for both signers."""

    @classmethod
    def now(cls, tz=None):
        return _dt.datetime(2026, 10, 17, 12, 34, 56, tzinfo=tz)


@pytest.mark.parametrize("method,url,payload,kw", [
    ("GET", "http://127.0.0.1:8333/bkt/a/b.txt", b"", {}),
    ("GET", "http://127.0.0.1:8333/bkt?list-type=2&max-keys=1000"
            "&prefix=tier-ec/c/7", b"", {}),
    ("PUT", "http://h:1/bkt/tier-ec/default/7/03.ec", b"\x00\x01" * 999,
     {}),
    ("PUT", "http://h:1/bkt/7.dat", b"", {"unsigned_payload": True}),
    ("DELETE", "http://h:1/bkt/dir with space/ü~._-.bin", b"", {}),
    ("HEAD", "http://h:1/b/k", b"", {"region": "eu-west-1",
                                       "service": "s3"}),
    ("PUT", "http://h:1/", b"x", {"region": "us-west-2"}),
])
def test_sign_headers_equal(monkeypatch, method, url, payload, kw):
    monkeypatch.setattr(ref_sigv4, "datetime", _Clock)
    monkeypatch.setattr(port_sigv4, "datetime", _Clock)
    want = ref_sigv4.sign_headers(method, url, AK, SK, payload=payload,
                                  **kw)
    assert port_sigv4.sign_headers(method, url, AK, SK, payload=payload,
                                   **kw) == want
    assert want["x-amz-date"] == "20261017T123456Z"


def test_escaped_query_signed_once(monkeypatch):
    """ListObjectsV2 as S3Client sends it (prefix escaped in the url):
    the port signs what the reference signs for the unescaped query;
    the reference's own signature of the escaped url differs (it
    escapes %2F again)."""
    monkeypatch.setattr(ref_sigv4, "datetime", _Clock)
    monkeypatch.setattr(port_sigv4, "datetime", _Clock)
    base = "http://h:1/bkt?list-type=2&max-keys=1000"
    escaped = base + "&prefix=tier-ec%2Fc%2F7%2F&continuation-token=a%2Bb"
    plain = base + "&prefix=tier-ec/c/7/&continuation-token=a+b"
    port = port_sigv4.sign_headers("GET", escaped, AK, SK)
    assert port == ref_sigv4.sign_headers("GET", plain, AK, SK)
    assert port != ref_sigv4.sign_headers("GET", escaped, AK, SK)


@pytest.fixture(scope="module")
def gateways(tmp_path_factory):
    """One reference and one port cluster, each with its S3 gateway
    and the same identity."""
    ref = RefCluster(str(tmp_path_factory.mktemp("ref_gw")),
                     n_volume_servers=1, volume_size_limit=64 << 20,
                     with_s3=True, s3_config=CFG, ec_backend="numpy")
    try:
        port = Cluster(str(tmp_path_factory.mktemp("port_gw")),
                       n_volume_servers=1, volume_size_limit=64 << 20,
                       with_s3=True, s3_config=CFG, ec_backend="native")
    except BaseException:
        ref.stop()
        raise
    try:
        yield {"reference": ref.s3_url, "port": port.s3_url}
    finally:
        port.stop()
        ref.stop()


class _Reader:
    """A file-like reader over bytes that records its read sizes."""

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0
        self.sizes: list[int] = []

    def read(self, n: int) -> bytes:
        self.sizes.append(n)
        out = self.data[self.off:self.off + n]
        self.off += len(out)
        return out


def _drive(client, tmp_path) -> dict:
    """The client verbs the remote tier uses, one bucket -> results."""
    rng = np.random.default_rng([SEED, 1])
    small = rng.bytes(70_001)
    big = rng.bytes(3 * (1 << 20) + 12_345)
    out: dict = {}
    out["put"] = (client.put_object("tier-ec/c/7/00.ec", small).size,
                  client.put_object("tier-ec/c/7/00.ec", small).etag)
    for i in range(5):
        client.put_object(f"tier-ec/c/7/{i + 1:02d}.ec",
                          small[:1000 * (i + 1)])
    out["get"] = hashlib.sha256(client.get_object("tier-ec/c/7/00.ec"))\
        .hexdigest()
    out["ranges"] = [client.get_object("tier-ec/c/7/00.ec", off, n)
                     for off, n in ((0, 1), (17, 4096), (70_000, 1),
                                    (69_990, -1), (5, 0))]
    head = client.head_object("tier-ec/c/7/00.ec")
    out["head"] = (head.key, head.size, head.etag)
    out["head_missing"] = client.head_object("tier-ec/c/7/99.ec")
    reader = _Reader(big)
    out["stream"] = client.put_stream("dat/7.dat", reader, len(big))
    out["stream_reads_bounded"] = max(reader.sizes) <= 64 << 20
    dest = tmp_path / f"dl-{id(client)}"
    out["download"] = client.download_to("dat/7.dat", str(dest))
    out["download_equal"] = dest.read_bytes() == big
    try:
        out["list"] = [(o.key, o.size) for o in
                       client.list_objects("tier-ec/c/7/")]
    except OSError as e:     # requests' and the port's HTTPError
        out["list"] = str(e).split()[0]
    out["list_all"] = sorted(o.key for o in client.list_objects())
    client.delete_object("tier-ec/c/7/00.ec")
    client.delete_object("tier-ec/c/7/00.ec")     # absent: no error
    out["after_delete"] = client.head_object("tier-ec/c/7/00.ec")
    out["buckets"] = client.list_buckets()
    return out


@pytest.mark.parametrize("gateway", ["reference", "port"])
def test_both_clients_against_each_gateway(gateways, gateway, tmp_path):
    """The reference's client and the port's drive the same gateway
    into the same state, one bucket each, and see the same answers."""
    url = gateways[gateway]
    got = {}
    for who, cls in CLIENTS.items():
        bucket = f"tier-{who}"
        requests.put(f"{url}/{bucket}", timeout=10,
                     headers=ref_sigv4.sign_headers(
                         "PUT", f"{url}/{bucket}", AK, SK)) \
            .raise_for_status()
        got[who] = _drive(cls(endpoint=url, bucket=bucket, access_key=AK,
                              secret_key=SK), tmp_path)
    for out in got.values():
        out["buckets"] = sorted(set(out["buckets"]) -
                                {"tier-reference", "tier-port"})
    # the reference signs the escaped prefix twice: 403 (see above)
    assert got["reference"].pop("list") == "403"
    out = got["port"]
    assert out.pop("list") == [(f"tier-ec/c/7/{i:02d}.ec", n) for i, n in
                               enumerate([70_001, 1000, 2000, 3000,
                                          4000, 5000])]
    assert got["port"] == got["reference"]
    assert out["stream"] == 3 * (1 << 20) + 12_345 and out["download_equal"]
    assert [len(r) for r in out["ranges"]] == [1, 4096, 1, 11, 0]
    assert out["head"][1] == 70_001 and out["head_missing"] is None
    assert out["after_delete"] is None


def test_anonymous_client_sends_no_signature(gateways):
    """Empty credentials: unsigned requests, no Authorization header."""
    c = port_client.S3Client(endpoint=gateways["port"], bucket="b")
    assert c.headers("GET", c.url("k")) == {}
    assert c.url("a b/ü.txt") == f"{gateways['port']}/b/a%20b/%C3%BC.txt"
    with pytest.raises(ValueError, match="endpoint and bucket"):
        port_client.S3Client(endpoint="", bucket="b")


def test_put_stream_sends_a_length_in_blocks(tmp_path):
    """A file-like body goes out with its Content-Length, in pieces of
    at most BODY_BLOCK, on a fresh connection; the server sees every
    byte once and no Transfer-Encoding."""
    seen = {}

    def handler(req):
        seen["length"] = req.headers.get("Content-Length")
        seen["te"] = req.headers.get("Transfer-Encoding")
        seen["body"] = hashlib.sha256(req.read()).hexdigest()
        seen["sha"] = req.headers.get("x-amz-content-sha256")
        return Response(b"", 200)

    app = App()
    app.route("PUT", "/{tail:.*}", handler)
    th = ServerThread(app).start()
    try:
        data = np.random.default_rng(SEED).bytes(5 * (1 << 20) + 3)
        reader = _Reader(data)
        c = port_client.S3Client(endpoint=th.url, bucket="b",
                                 access_key=AK, secret_key=SK)
        sess = httpclient.session()
        pooled = sum(len(p) for p in sess._pools.values())
        assert c.put_stream("k", reader, len(data)) == len(data)
        assert seen == {"length": str(len(data)), "te": None,
                        "body": hashlib.sha256(data).hexdigest(),
                        "sha": "UNSIGNED-PAYLOAD"}
        assert max(reader.sizes) <= httpclient.BODY_BLOCK
        assert len(reader.sizes) >= 5
        # the streamed request took a connection of its own and handed
        # it back to the pool when done
        assert sum(len(p) for p in sess._pools.values()) == pooled + 1
    finally:
        th.stop()


def test_a_spent_body_is_never_replayed():
    """A file-like body that reached the wire is not sent again after a
    503: the caller gets the 503."""
    calls = []
    lock = threading.Lock()

    def handler(req):
        req.read()
        with lock:
            calls.append(1)
        return Response(b"busy", 503)

    app = App()
    app.route("PUT", "/{tail:.*}", handler)
    th = ServerThread(app).start()
    try:
        body = port_client._Body(_Reader(b"x" * 1000), 1000)
        r = httpclient.session().put(f"{th.url}/b/k", data=body,
                                     timeout=10)
        assert r.status_code == 503 and len(calls) == 1
    finally:
        th.stop()

