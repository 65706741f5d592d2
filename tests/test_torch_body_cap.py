"""Request body caps: every port server answers 413 where its reference
counterpart does (ROADMAP Queue 3 item 2, fixed in the port).

The reference's aiohttp apps cap what `request.read()` / `json()` take
(`client_max_size`): master 1 MiB, volume server 256 MiB, S3 gateway
1 GiB, filer 1 TiB; a handler that reads a body that reaches the cap
gets 413. The port's `App(max_body=...)` is that cap.

* Each port server's cap equals its reference's.
* The master takes a real 1 MiB + 1 body, on a route that reads it
  (/cluster/announce: 413 in both) and on one whose handler maps any
  read error to 400 (/cluster/traces/push: 400 in both).
* The larger caps are held at a scaled cap: both packages' servers get
  the same 64 KiB cap, and a body one byte over it (and one under)
  gets the same status from each, on a body-reading route of every
  server (volume /admin/assign_volume, filer PUT /kv/, S3 object PUT).
* A body that declares the real cap (or more) is refused by the port
  before a byte of it is read: Content-Length 256 MiB + 1, 1 TiB + 1
  and 1 GiB + 1 with a short body each get 413 at once. (aiohttp reads
  such a body until it reaches the cap, so the reference waits for
  bytes a short body never sends: no status to compare.)
* An object PUT over the S3 gateway's cap signed UNSIGNED-PAYLOAD gets
  413 from both gateways. So the reference's `S3Client.put_stream`,
  one PUT whatever the size, cannot store an object at the cap (ROADMAP
  Queue 3); the port's sends a multipart upload from the cap on, which
  both gateways take and read back equal.
"""
import functools
import hashlib
import io
import socket

import pytest
import requests

from seaweedfs_tpu.s3.client import S3Client as RefS3Client
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.s3 import client as port_s3_client
from seaweedfs_tpu_torch.server.cluster import Cluster

PortCluster = functools.partial(Cluster, ec_backend="native")
MIB = 1 << 20
SCALED = 64 << 10
REAL_CAPS = {"master": 1 << 20, "volume": 256 << 20, "s3": 1 << 30,
             "filer": 1 << 40}


def _threads(c) -> dict:
    return {"master": c.master_thread, "volume": c.volume_threads[0],
            "filer": c.filer_thread, "s3": c.s3_thread}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    ref = RefCluster(str(tmp_path_factory.mktemp("ref_cap")),
                     n_volume_servers=1, volume_size_limit=16 << 20,
                     with_filer=True, with_s3=True)
    try:
        port = PortCluster(str(tmp_path_factory.mktemp("port_cap")),
                           n_volume_servers=1,
                           volume_size_limit=16 << 20,
                           with_filer=True, with_s3=True)
    except BaseException:
        ref.stop()
        raise
    for c in (ref, port):
        assert requests.put(c.s3_url + "/capb", timeout=10).status_code \
            == 200
    yield ref, port
    port.stop()
    ref.stop()


def _set_cap(c, kind: str, cap: int) -> None:
    app = _threads(c)[kind].app
    if hasattr(app, "max_body"):
        app.max_body = cap
    else:
        app._client_max_size = cap


@pytest.mark.parametrize("kind", sorted(REAL_CAPS))
def test_caps_match_the_reference(pair, kind):
    ref, port = pair
    assert _threads(ref)[kind].app._client_max_size == REAL_CAPS[kind]
    assert _threads(port)[kind].app.max_body == REAL_CAPS[kind]


@pytest.mark.parametrize("path,want", [("/cluster/announce", 413),
                                       ("/cluster/traces/push", 400)])
def test_master_one_mib_plus_one(pair, path, want):
    body = b"{" + b" " * MIB
    got = [requests.post(c.master_url + path, data=body,
                         headers={"Content-Type": "application/json"},
                         timeout=30).status_code for c in pair]
    assert got[1] == got[0] == want


def _scaled_request(c, kind: str, n: int) -> int:
    body = b"x" * n
    url = {"master": c.master_url + "/cluster/announce",
           "volume": _threads(c)["volume"].url + "/admin/assign_volume",
           "filer": c.filer_url + "/kv/capkey",
           "s3": c.s3_url + "/capb/obj"}[kind]
    send = requests.post if kind in ("master", "volume") else requests.put
    return send(url, data=body, timeout=30).status_code


@pytest.mark.parametrize("kind", sorted(REAL_CAPS))
def test_scaled_cap_same_status(pair, kind):
    try:
        for c in pair:
            _set_cap(c, kind, SCALED)
        over = [_scaled_request(c, kind, SCALED + 1) for c in pair]
        under = [_scaled_request(c, kind, SCALED - 1) for c in pair]
    finally:
        for c in pair:
            _set_cap(c, kind, REAL_CAPS[kind])
    assert over[1] == over[0] == 413
    assert under[1] == under[0] != 413


def _declare(url: str, method: str, length: int,
             headers: dict | None = None) -> tuple[int, bytes]:
    """Send a request head declaring `length` and 1 KiB of body, then
    read the status line."""
    host, _, rest = url.removeprefix("http://").partition("/")
    h, p = host.split(":")
    s = socket.create_connection((h, int(p)), timeout=10)
    try:
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        s.sendall(f"{method} /{rest} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Length: {length}\r\n{extra}\r\n".encode()
                  + b"x" * 1024)
        head = b""
        while b"\r\n\r\n" not in head:
            piece = s.recv(4096)
            if not piece:
                break
            head += piece
    finally:
        s.close()
    status = int(head.split(b" ", 2)[1]) if head else 0
    return status, head


@pytest.mark.parametrize("kind", ["volume", "filer", "s3"])
def test_port_refuses_a_declared_over_cap_body_unread(pair, kind):
    _, port = pair
    url = {"volume": _threads(port)["volume"].url + "/admin/assign_volume",
           "filer": port.filer_url + "/kv/capkey",
           "s3": port.s3_url + "/capb/big"}[kind]
    status, head = _declare(url, "POST" if kind == "volume" else "PUT",
                            REAL_CAPS[kind] + 1)
    assert status == 413, head
    assert b"Connection: close" in head


def test_s3_unsigned_payload_over_the_cap_is_refused(pair):
    body = bytes(range(256)) * ((SCALED + 256) // 256)
    hdrs = {"X-Amz-Content-Sha256": "UNSIGNED-PAYLOAD"}
    try:
        for c in pair:
            _set_cap(c, "s3", SCALED)
        got = [requests.put(c.s3_url + "/capb/streamed", data=body,
                            headers=hdrs, timeout=30).status_code
               for c in pair]
    finally:
        for c in pair:
            _set_cap(c, "s3", REAL_CAPS["s3"])
    assert got == [413, 413]


@pytest.mark.parametrize("gateway", ["reference", "port"])
def test_put_stream_at_the_cap_goes_multipart(pair, gateway, monkeypatch):
    """At a scaled cap, the reference's put_stream of an object at the
    cap gets 413; the port's, with its threshold at the cap, uploads it
    in parts that the gateway takes, and it reads back equal."""
    c = dict(zip(("reference", "port"), pair))[gateway]
    monkeypatch.setattr(port_s3_client, "MULTIPART_THRESHOLD", SCALED)
    monkeypatch.setattr(port_s3_client, "PART_SIZE", SCALED // 3)
    body = bytes(range(251)) * (SCALED // 251 + 7)
    key = f"multi-{gateway}"
    try:
        _set_cap(c, "s3", SCALED)
        with pytest.raises(requests.HTTPError, match="413"):
            RefS3Client(endpoint=c.s3_url, bucket="capb").put_stream(
                key, io.BytesIO(body), len(body))
        client = port_s3_client.S3Client(endpoint=c.s3_url, bucket="capb")
        assert client.put_stream(key, io.BytesIO(body), len(body)) \
            == len(body)
        small = body[:SCALED - 1]
        assert client.put_stream(key + "-small", io.BytesIO(small),
                                 len(small)) == len(small)
    finally:
        _set_cap(c, "s3", REAL_CAPS["s3"])
    assert client.get_object(key) == body
    assert client.get_object(key, 5, SCALED) == body[5:5 + SCALED]
    head = client.head_object(key)
    assert head.size == len(body) and head.etag.endswith("-4")
    assert client.head_object(key + "-small").etag == \
        hashlib.md5(small).hexdigest()
    listing = requests.get(c.s3_url + "/capb?uploads", timeout=30).text
    assert "<UploadId>" not in listing
