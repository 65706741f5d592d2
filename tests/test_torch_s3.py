"""The port's S3 gateway against the JAX package's.

* The cases of tests/test_s3.py run unchanged against the port's
  `Cluster(with_s3=True)` (tests/torch_port_cases.py rebinds `Cluster`,
  `sign_request` and `presign_url`), the tagging case included.
* The same SigV4-signed requests (tests/s3v4client.py, a clean-room
  signer) to a reference and a port gateway get the same statuses and
  XML (timestamps and upload ids masked): bucket CRUD, ListObjects v1
  and v2 with prefix, delimiter, pages and url encoding, put, get,
  range, head, copy, delete, DeleteObjects and the whole multipart
  path; an aws-chunked signed upload, a presigned GET, a bad signature,
  a tampered body.
* The sub-resources the port once answered 501 for (the names of the
  two tests below stay from then) answer what the reference answers:
  bucket policy and CORS, object ACL, retention, legal hold and object
  lock 501 in both; ACL, lifecycle, ownership controls, tagging and
  form uploads as the reference serves them
  (tests/test_torch_s3_subresources.py holds them in full).
* `sign_request` / `presign_url` / `encode_chunked` byte-equal to the
  reference's for seeded inputs at a pinned clock.
* A multipart object whose parts span several filer chunks: GET, HEAD
  and the listing answer the ETag CompleteMultipartUpload returned on
  the port (the reference answers ETagChunks there — a departure, see
  s3/server.py).
"""
import datetime as _dt
import functools
import hashlib
import re
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import requests

from seaweedfs_tpu.s3 import auth as ref_auth
from seaweedfs_tpu.s3 import chunked as ref_chunked
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.s3 import auth, chunked
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_s3 as ref_cases
from tests.s3v4client import S3V4Client
from tests.torch_port_cases import call_case, port_cases

SEED = 20261017
NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"
AK, SK = "TORCHAK", "torch-secret"
CFG = {"identities": [
    {"name": "admin", "credentials": [{"accessKey": AK, "secretKey": SK}],
     "actions": ["Admin"]},
    {"name": "reader", "credentials": [{"accessKey": "RK",
                                        "secretKey": "RS"}],
     "actions": ["Read", "List"]}]}
PortCluster = functools.partial(Cluster, ec_backend="native")

CASES = port_cases(ref_cases, Cluster=PortCluster,
                   sign_request=auth.sign_request,
                   presign_url=auth.presign_url)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The reference case file's open gateway, on the port."""
    c = PortCluster(str(tmp_path_factory.mktemp("port_s3")),
                    n_volume_servers=2, volume_size_limit=16 << 20,
                    with_s3=True)
    ls = c.s3_url + "/ls"
    requests.put(ls, timeout=10)
    for k in ("a.txt", "b.txt", "dir1/x.txt", "dir1/y.txt", "dir2/z.txt"):
        requests.put(f"{ls}/{k}", data=b"1", timeout=10)
    yield c
    c.stop()


@pytest.fixture(scope="module")
def auth_cluster(tmp_path_factory):
    c = PortCluster(str(tmp_path_factory.mktemp("port_s3_auth")),
                    n_volume_servers=1, volume_size_limit=16 << 20,
                    with_s3=True, s3_config={"identities": [
                        {"name": "admin", "actions": ["Admin"],
                         "credentials": [{"accessKey": "AKID",
                                          "secretKey": "SK"}]},
                        {"name": "reader", "actions": ["Read", "List"],
                         "credentials": [{"accessKey": "RKID",
                                          "secretKey": "RS"}]}]})
    yield c
    c.stop()


@pytest.mark.parametrize("case", list(CASES))
def test_s3_cases_on_the_port(case, cluster, auth_cluster, tmp_path_factory):
    call_case(CASES[case], {"s3": cluster.s3_url, "cluster": cluster,
                            "auth_cluster": auth_cluster,
                            "tmp_path_factory": tmp_path_factory})


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A reference and a port gateway with the same identities."""
    ref = RefCluster(str(tmp_path_factory.mktemp("ref_s3")),
                     n_volume_servers=1, volume_size_limit=64 << 20,
                     with_s3=True, s3_config=CFG)
    try:
        port = PortCluster(str(tmp_path_factory.mktemp("port_s3p")),
                           n_volume_servers=1, volume_size_limit=64 << 20,
                           with_s3=True, s3_config=CFG)
    except BaseException:
        ref.stop()
        raise
    yield ref, port
    port.stop()
    ref.stop()


_MASKED_TAGS = {"LastModified", "CreationDate", "Initiated", "UploadId"}


def _xml(body: bytes):
    """XML as nested (tag, text, children), volatile fields masked."""
    def walk(el):
        tag = el.tag.split("}")[-1]
        text = "*" if tag in _MASKED_TAGS else (el.text or "").strip()
        return (tag, text, [walk(c) for c in el])
    return walk(ET.fromstring(body))


def _answer(r) -> tuple:
    body = r.body
    if body.startswith(b"<?xml"):
        body = _xml(body)
    hdrs = {h: r.header(h) for h in ("etag", "content-range",
                                      "content-length")}
    if not isinstance(body, bytes):
        hdrs["content-length"] = "masked"
    # aiohttp sends no Content-Length on an empty HEAD reply
    hdrs["content-length"] = hdrs["content-length"] or "0"
    return r.status, body, hdrs


def _upload_id(r) -> str:
    return ET.fromstring(r.body).find(f"{NS}UploadId").text


def test_same_signed_requests_same_answers(pair):
    """One seeded sequence through both gateways; every status, XML
    body, ETag and Content-Range equal."""
    rng = np.random.default_rng(SEED)
    objs = {"a.txt": b"alpha" * 30, "dir/b.json": b'{"b": 2}' * 40,
            "dir/sub/c.bin": rng.bytes(70000),
            "big.bin": rng.bytes((1 << 20) + 333),
            "sp ace+plus.txt": b"odd key", "z/last.txt": b"z"}
    parts = [rng.bytes(5 << 20), rng.bytes(3000)]
    clients = [S3V4Client(c.s3_url, AK, SK) for c in pair]
    upload_ids = [None, None]

    def both(fn):
        out = [fn(cl, i) for i, cl in enumerate(clients)]
        assert _answer(out[1]) == _answer(out[0])
        return out

    both(lambda c, i: c.put("/cmp"))
    both(lambda c, i: c.put("/cmp"))
    both(lambda c, i: c.head("/cmp"))
    both(lambda c, i: c.head("/nope"))
    both(lambda c, i: c.get("/"))
    for k, v in objs.items():
        both(lambda c, i: c.put(f"/cmp/{k}", v, headers={
            "x-amz-meta-origin": "seeded"}))
    for k in objs:
        both(lambda c, i: c.get(f"/cmp/{k}"))
        both(lambda c, i: c.head(f"/cmp/{k}"))
    for rng_h in ("bytes=0-9", "bytes=1000-1048999", "bytes=-77",
                  "bytes=1048570-", "bytes=99999999-"):
        both(lambda c, i: c.get("/cmp/big.bin", headers={"Range": rng_h}))
    both(lambda c, i: c.get("/cmp/missing.txt"))
    both(lambda c, i: c.get("/nobucket/x"))
    for q in ({}, {"prefix": "dir/"}, {"delimiter": "/"},
              {"prefix": "dir/", "delimiter": "/"}, {"max-keys": "2"},
              {"marker": "big.bin"}, {"encoding-type": "url"},
              {"list-type": "2", "max-keys": "2"},
              {"list-type": "2", "start-after": "dir/b.json"},
              {"list-type": "2", "continuation-token": "big.bin"},
              {"list-type": "2", "delimiter": "/", "prefix": "dir/"},
              {"encoding-type": "bogus"}):
        both(lambda c, i: c.get("/cmp", **q))
    both(lambda c, i: c.put("/cmp/copy.txt", headers={
        "x-amz-copy-source": "/cmp/a.txt"}))
    both(lambda c, i: c.get("/cmp/copy.txt"))
    both(lambda c, i: c.put("/cmp/copy2.txt", headers={
        "x-amz-copy-source": "/cmp/a.txt",
        "x-amz-metadata-directive": "REPLACE",
        "x-amz-meta-fresh": "yes", "content-type": "text/plain"}))
    both(lambda c, i: c.head("/cmp/copy2.txt"))
    both(lambda c, i: c.put("/cmp/a.txt", headers={
        "x-amz-copy-source": "/cmp/a.txt"}))
    both(lambda c, i: c.delete("/cmp/z/last.txt"))
    both(lambda c, i: c.get("/cmp/z/last.txt"))
    both(lambda c, i: c.post("/cmp", b"<Delete><Object><Key>copy.txt</Key>"
                             b"</Object><Object><Key>nope</Key></Object>"
                             b"</Delete>", delete=""))
    # multipart, with each gateway's own upload id
    init = both(lambda c, i: c.post("/cmp/mp.bin", uploads=""))
    upload_ids = [_upload_id(r) for r in init]
    for n, part in enumerate(parts, 1):
        both(lambda c, i: c.put("/cmp/mp.bin", part, partNumber=str(n),
                                uploadId=upload_ids[i]))
    both(lambda c, i: c.put("/cmp/mp.bin", partNumber="3",
                            uploadId=upload_ids[i], headers={
                                "x-amz-copy-source": "/cmp/big.bin",
                                "x-amz-copy-source-range": "bytes=5-104"}))
    both(lambda c, i: c.put("/cmp/mp.bin", b"x", partNumber="0",
                            uploadId=upload_ids[i]))
    both(lambda c, i: c.get("/cmp/mp.bin", uploadId=upload_ids[i]))
    both(lambda c, i: c.get("/cmp", uploads=""))
    both(lambda c, i: c.post("/cmp/mp.bin", (
        "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber></Part>"
            for n in (1, 2, 3)) + "</CompleteMultipartUpload>").encode(),
        uploadId=upload_ids[i]))
    both(lambda c, i: c.get("/cmp/mp.bin"))
    both(lambda c, i: c.get("/cmp/mp.bin", headers={
        "Range": f"bytes={(5 << 20) - 3}-{(5 << 20) + 3}"}))
    both(lambda c, i: c.post("/cmp/mp.bin", b"", uploadId="0" * 32))
    ab = both(lambda c, i: c.post("/cmp/ab.bin", uploads=""))
    ab_ids = [_upload_id(r) for r in ab]
    both(lambda c, i: c.delete("/cmp/ab.bin", uploadId=ab_ids[i]))
    both(lambda c, i: c.get("/cmp", location=""))
    both(lambda c, i: c.delete("/cmp"))
    both(lambda c, i: c.put("/empty"))
    both(lambda c, i: c.delete("/empty"))
    both(lambda c, i: c.get("/"))


def test_auth_answers_as_the_reference(pair):
    """aws-chunked signed upload, presigned GET, bad and missing
    signatures, a tampered body, a reader's write."""
    rng = np.random.default_rng(SEED + 1)
    chunks = [rng.bytes(65536), rng.bytes(1000)]
    out = []
    for c in pair:
        cl = S3V4Client(c.s3_url, AK, SK)
        got = [_answer(cl.put("/auth"))]
        got.append(_answer(cl.put_chunked("/auth/streamed.bin", chunks)))
        got.append(_answer(cl.get("/auth/streamed.bin")))
        url = auth.presign_url("GET", f"{c.s3_url}/auth/streamed.bin", AK, SK)
        r = requests.get(url, timeout=10)
        got.append((r.status_code, r.content))
        bad = url.replace("X-Amz-Signature=", "X-Amz-Signature=0")
        r = requests.get(bad, timeout=10)
        got.append((r.status_code, _xml(r.content)))
        wrong = S3V4Client(c.s3_url, AK, "wrong-secret")
        got.append(_answer(wrong.get("/auth/streamed.bin")))
        got.append(_answer(S3V4Client(c.s3_url, "NOKEY", "x").get("/auth")))
        r = requests.get(f"{c.s3_url}/auth/streamed.bin", timeout=10)
        got.append((r.status_code, _xml(r.content)))
        h = auth.sign_request("PUT", f"{c.s3_url}/auth/t.bin", AK, SK,
                              payload=b"original")
        r = requests.put(f"{c.s3_url}/auth/t.bin", data=b"TAMPERED",
                         headers=h, timeout=10)
        got.append((r.status_code, _xml(r.content)))
        reader = S3V4Client(c.s3_url, "RK", "RS")
        got.append(_answer(reader.put("/auth/r.bin", b"nope")))
        got.append(_answer(reader.get("/auth/streamed.bin")))
        out.append(got)
    assert out[1] == out[0]
    assert out[1][1][0] == 200 and out[1][2][1] == b"".join(chunks)
    assert [g[0] for g in out[1][4:9]] == [403, 403, 403, 403, 400]


@pytest.mark.parametrize("method,path,params", [
    ("GET", "/np", {"acl": ""}), ("PUT", "/np", {"acl": ""}),
    ("GET", "/np", {"policy": ""}), ("PUT", "/np", {"cors": ""}),
    ("GET", "/np", {"lifecycle": ""}),
    ("PUT", "/np", {"ownershipControls": ""}),
    ("GET", "/np/k.txt", {"tagging": ""}),
    ("PUT", "/np/k.txt", {"tagging": ""}),
    ("GET", "/np/k.txt", {"acl": ""}),
    ("PUT", "/np/k.txt", {"retention": ""}),
    ("PUT", "/np/k.txt", {"legal-hold": ""}),
    ("GET", "/np/k.txt", {"object-lock": ""})])
def test_unported_operations_answer_not_implemented(pair, method, path,
                                                    params):
    """Each answers as the reference's gateway: the six sub-resources
    the reference refuses with 501 as well, the rest served."""
    out = []
    for c in pair:
        cl = S3V4Client(c.s3_url, AK, SK)
        cl.put("/np")
        cl.put("/np/k.txt", b"k")
        out.append(_answer(cl.request(method, path, params)))
    assert out[1] == out[0]
    refused = {"policy", "cors", "retention", "legal-hold", "object-lock"}
    if set(params) & refused or (path == "/np/k.txt" and "acl" in params):
        assert out[1][0] == 501
        assert out[1][1][2][0][:2] == ("Code", "NotImplemented")
    else:
        assert out[1][0] < 500


def test_post_policy_form_upload_answers_not_implemented(pair):
    """A form upload without a policy to a gateway with identities:
    refused as the reference refuses it (403 AccessDenied), no longer
    501."""
    got = []
    for c in pair:
        r = requests.post(f"{c.s3_url}/np", files={"file": b"x"},
                          data={"key": "k"}, timeout=10)
        got.append((r.status_code, _xml(r.content)))
    assert got[1] == got[0]
    assert got[1][0] == 403


class _FixedClock(_dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 10, 17, 12, 34, 56, tzinfo=_dt.timezone.utc)


@pytest.mark.parametrize("i", range(6))
def test_signing_byte_equal_to_the_reference(i, monkeypatch):
    monkeypatch.setattr(auth, "datetime", _FixedClock)
    monkeypatch.setattr(ref_auth, "datetime", _FixedClock)
    rng = np.random.default_rng([SEED, i])
    payload = rng.bytes(int(rng.integers(0, 5000)))
    key = f"k{i}/o bj+{int(rng.integers(1000))}.bin"
    url = f"http://127.0.0.1:{8000 + i}/bkt/{key}?partNumber={i + 1}" \
          f"&uploadId={rng.bytes(8).hex()}"
    extra = {"Content-Type": "application/octet-stream",
             "x-amz-meta-n": str(i)} if i % 2 else None
    for method in ("PUT", "GET"):
        assert auth.sign_request(method, url, AK, SK, payload=payload,
                                 extra_headers=extra) == \
            ref_auth.sign_request(method, url, AK, SK, payload=payload,
                                  extra_headers=extra)
        assert auth.presign_url(method, url, AK, SK, expires=60 + i) == \
            ref_auth.presign_url(method, url, AK, SK, expires=60 + i)
    k = chunked.signing_key(SK, "20261017", "us-east-1", "s3")
    assert k == ref_chunked.signing_key(SK, "20261017", "us-east-1", "s3")
    framed = chunked.encode_chunked(payload, key=k, amz_date="x",
                                    scope="s", seed_signature="seed",
                                    chunk_size=1024)
    assert framed == ref_chunked.encode_chunked(
        payload, key=k, amz_date="x", scope="s", seed_signature="seed",
        chunk_size=1024)
    assert chunked.decode_chunked(framed, key=k, amz_date="x", scope="s",
                                  seed_signature="seed",
                                  expected_length=len(payload)) == payload
    with pytest.raises(chunked.ChunkSignatureError):
        chunked.decode_chunked(framed[:-7], key=k, amz_date="x", scope="s",
                               seed_signature="seed")


def test_multipart_etag_across_filer_chunks(pair):
    """Parts larger than one 8 MiB filer chunk: the port answers the
    completed upload's ETag on GET, HEAD and in the listing; the
    reference answers ETagChunks of the object's chunks on GET."""
    rng = np.random.default_rng(SEED + 2)
    parts = [rng.bytes((8 << 20) + 4096), rng.bytes(2000)]
    want = hashlib.md5(b"".join(hashlib.md5(p).digest()
                                for p in parts)).hexdigest() + "-2"
    got = []
    for c in pair:
        cl = S3V4Client(c.s3_url, AK, SK)
        cl.put("/mpe")
        uid = _upload_id(cl.post("/mpe/o.bin", uploads=""))
        for n, p in enumerate(parts, 1):
            assert cl.put("/mpe/o.bin", p, partNumber=str(n),
                          uploadId=uid).status == 200
        done = cl.post("/mpe/o.bin", b"", uploadId=uid)
        etag = ET.fromstring(done.body).find(f"{NS}ETag").text
        g = cl.get("/mpe/o.bin")
        assert g.body == b"".join(parts)
        listed = ET.fromstring(cl.get("/mpe", **{"list-type": "2"}).body)
        got.append((etag, g.header("etag"), cl.head("/mpe/o.bin")
                    .header("etag"),
                    listed.find(f"{NS}Contents/{NS}ETag").text))
    ref, port = got
    assert ref[0] == port[0] == f'"{want}"'
    assert port[1:] == (f'"{want}"',) * 3
    assert re.fullmatch(r'"[0-9a-f]{32}-3"', ref[1])   # 3 filer chunks
