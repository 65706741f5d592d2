"""The S3 sub-resources of the port's gateway and the filer's browser
listing, against the JAX package's, with tolerance 0.

* The reference's cases of tests/test_s3_ext.py (streaming uploads,
  UploadPartCopy, bucket ACL with its XML body, lifecycle, ownership
  controls, the 501 stubs, copy-source permissions) and the POST-policy
  cases of tests/test_s3_breaker_policy.py run on port clusters.
* Over ONE filer (a port cluster's) a reference gateway and the port's
  get the same requests on buckets of their own: the XML bodies and
  statuses of bucket ACL (canned and AccessControlPolicy), lifecycle,
  ownership controls and object tagging, the six sub-resources both
  refuse with 501, the anonymous GET / HEAD of a public-read bucket
  and the refusals around it, and POST-policy form uploads with each
  condition passing and failing (bucket names masked).
* A setting one gateway makes is read by the other: a bucket's ACL
  (and so its anonymous reads), lifecycle, ownership and an object's
  tags; the `filer.conf` bytes after PUT / DELETE ?lifecycle are equal,
  and a rule's other fields survive in both.
* The filer's text/html listing is byte for byte the reference's for
  the same entries (escaped names, links, the next-page link with its
  filters); `Accept: application/json` gets JSON from both.
"""
import base64
import functools
import json
import time
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import requests

from seaweedfs_tpu.filer.entry import Entry as RefEntry
from seaweedfs_tpu.filer.entry import FileChunk as RefChunk
from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.s3.server import S3ApiServer as RefS3
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu_torch.filer.entry import Entry, FileChunk
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.s3 import auth, chunked, sigv4_client
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.server.filer_server import FilerServer

from tests import test_s3_breaker_policy as ref_policy_cases
from tests import test_s3_ext as ref_ext_cases
from tests import test_scaffold_metrics as ref_scaffold
from tests.s3v4client import S3V4Client
from tests.torch_port_cases import port_cases, run_case, within

SEED = 20261018
AK, SK = "TORCHAK", "torch-secret"
CFG = {"identities": [
    {"name": "admin", "credentials": [{"accessKey": AK, "secretKey": SK}],
     "actions": ["Admin"]},
    {"name": "reader", "credentials": [{"accessKey": "RK",
                                        "secretKey": "RS"}],
     "actions": ["Read", "List"]}]}
PortCluster = functools.partial(Cluster, ec_backend="native")


def _cluster(tmp_path_factory, name, **kw):
    return within(60, PortCluster, str(tmp_path_factory.mktemp(name)),
                  n_volume_servers=1, volume_size_limit=16 << 20, **kw)


# -- the reference's cases on the port ---------------------------------------
EXT = port_cases(ref_ext_cases, Cluster=PortCluster,
                 sign_request=auth.sign_request, chunked=chunked)
POLICY = {k: v for k, v in port_cases(
    ref_policy_cases, Cluster=PortCluster,
    sign_policy=sigv4_client.sign_policy).items()
    if k.startswith("TestPostPolicy")}
ESCAPES = port_cases(ref_scaffold, Cluster=PortCluster)[
    "TestStatusUis.test_filer_listing_escapes_names"]


@pytest.fixture(scope="module")
def ext_fixtures(tmp_path_factory):
    """The reference case files' clusters, on the port."""
    made = []

    def add(c):
        made.append(c)
        return c

    try:
        open_c = add(_cluster(tmp_path_factory, "s3_ext", with_s3=True))
        requests.put(f"{open_c.s3_url}/ext", timeout=10)
        stream = add(_cluster(tmp_path_factory, "s3_stream", with_s3=True,
                              s3_config={"identities": [
                                  {"name": "admin", "actions": ["Admin"],
                                   "credentials": [{"accessKey": "AKID",
                                                    "secretKey": "SK"}]}]}))
        h = auth.sign_request("PUT", f"{stream.s3_url}/sb", "AKID", "SK")
        assert requests.put(f"{stream.s3_url}/sb", headers=h,
                            timeout=10).status_code == 200
        w = add(_cluster(tmp_path_factory, "s3_copysrc", with_s3=True,
                         s3_config={"identities": [
                             {"name": "admin", "actions": ["Admin"],
                              "credentials": [{"accessKey": "AKID",
                                               "secretKey": "SK"}]},
                             {"name": "writer",
                              "actions": ["Write:dest", "Read:dest",
                                          "List:dest"],
                              "credentials": [{"accessKey": "WKID",
                                               "secretKey": "WS"}]}]}))
        for b in ("dest", "secret"):
            h = auth.sign_request("PUT", f"{w.s3_url}/{b}", "AKID", "SK")
            assert requests.put(f"{w.s3_url}/{b}", headers=h,
                                timeout=10).status_code == 200
        h = auth.sign_request("PUT", f"{w.s3_url}/secret/private.txt",
                              "AKID", "SK", payload=b"classified")
        requests.put(f"{w.s3_url}/secret/private.txt", data=b"classified",
                     headers=h, timeout=10)
        pp = add(_cluster(tmp_path_factory, "s3_pp", with_filer=True,
                          with_s3=True))
        sec = add(_cluster(tmp_path_factory, "s3_pp_sec", with_filer=True,
                           with_s3=True, s3_config=ref_policy_cases.CFG))
        h = sigv4_client.sign_headers("PUT", f"{sec.s3_url}/secure", "AK",
                                      "SK")
        assert requests.put(f"{sec.s3_url}/secure", headers=h,
                            timeout=10).status_code == 200
        yield {"cluster": open_c, "s3": open_c.s3_url,
               "auth_cluster": stream, "wcluster": w,
               "pp": pp, "secured": sec}
    finally:
        for c in made:
            within(60, c.stop)


@pytest.mark.parametrize("case", list(EXT))
def test_reference_s3_ext_cases_on_the_port(case, ext_fixtures):
    run_case(EXT[case], ext_fixtures)


@pytest.mark.parametrize("case", list(POLICY))
def test_reference_post_policy_cases_on_the_port(case, ext_fixtures):
    run_case(POLICY[case], {"cluster": ext_fixtures["pp"],
                            "secured": ext_fixtures["secured"]})


def test_reference_listing_escape_case_on_the_port(tmp_path_factory):
    run_case(ESCAPES, {"tmp_path_factory": tmp_path_factory})


# -- two gateways over one filer ---------------------------------------------
@pytest.fixture(scope="module")
def duo(tmp_path_factory):
    """A port cluster (filer + the port's gateway) and a reference
    gateway on the same filer, with the same identities."""
    c = _cluster(tmp_path_factory, "duo", with_filer=True, with_s3=True,
                 s3_config=CFG)
    ref = None
    try:
        ref_s3 = RefS3(c.filer_url, iam_config=CFG)
        ref = RefServerThread(ref_s3.app).start()
        yield {"reference": (ref.url, ref_s3), "port": (c.s3_url, c.s3),
               "cluster": c}
    finally:
        if ref is not None:
            within(30, ref.stop)
        within(60, c.stop)


def _mask(body: bytes, bucket: str) -> object:
    if body.startswith(b"<?xml"):
        def walk(el):
            return (el.tag.split("}")[-1],
                    (el.text or "").strip().replace(bucket, "B"),
                    sorted(el.attrib.items()), [walk(x) for x in el])
        return walk(ET.fromstring(body))
    return body


def _ans(r, bucket: str) -> tuple:
    return r.status, _mask(r.body, bucket), r.header("etag")


def _fresh(gw, bucket: str) -> None:
    """Drop a gateway's cached bucket entry: a setting the OTHER
    gateway made is read at once, not after the cache's 2 s."""
    gw._invalidate_bucket(bucket)


def _acl_body(public: bool, other: str = "") -> bytes:
    grants = ("<Grant><Grantee><ID>seaweedfs_tpu</ID></Grantee>"
              "<Permission>FULL_CONTROL</Permission></Grant>")
    if public:
        grants += ("<Grant><Grantee><URI>http://acs.amazonaws.com/groups/"
                   "global/AllUsers</URI></Grantee>"
                   "<Permission>READ</Permission></Grant>")
    if other:
        grants += (f"<Grant><Grantee><ID>{other}</ID></Grantee>"
                   "<Permission>FULL_CONTROL</Permission></Grant>")
    return (f"<AccessControlPolicy><Owner><ID>seaweedfs_tpu</ID></Owner>"
            f"<AccessControlList>{grants}</AccessControlList>"
            f"</AccessControlPolicy>").encode()


def _lifecycle(*rules) -> bytes:
    out = "".join(
        f"<Rule><ID>r{i}</ID><Status>{st}</Status><Filter><Prefix>{p}"
        f"</Prefix></Filter>"
        + (f"<Expiration><Days>{d}</Days></Expiration>" if d is not None
           else "<Expiration><Date>2030-01-01T00:00:00Z</Date>"
                "</Expiration>")
        + "</Rule>" for i, (p, d, st) in enumerate(rules))
    return f"<LifecycleConfiguration>{out}</LifecycleConfiguration>" \
        .encode()


def _ownership(v: str) -> bytes:
    return (f"<OwnershipControls><Rule><ObjectOwnership>{v}"
            f"</ObjectOwnership></Rule></OwnershipControls>").encode()


def _tagging(tags: dict) -> bytes:
    inner = "".join(f"<Tag><Key>{k}</Key><Value>{v}</Value></Tag>"
                    for k, v in tags.items())
    return f"<Tagging><TagSet>{inner}</TagSet></Tagging>".encode()


def _script(url: str, b: str, rng) -> list:
    """Every verb of the sub-resources on bucket `b`, in order."""
    cl = S3V4Client(url, AK, SK)
    reader = S3V4Client(url, "RK", "RS")
    body = rng.bytes(int(rng.integers(1, 4096)))
    out = [_ans(cl.put(f"/{b}"), b), _ans(cl.put(f"/{b}-priv"), b),
           _ans(cl.put(f"/{b}/k.bin", body), b),
           _ans(cl.put(f"/{b}-priv/k.bin", body), b)]
    # -- acl
    out += [_ans(cl.get(f"/{b}", acl=""), b),
            _ans(cl.put(f"/{b}", headers={"x-amz-acl": "public-read"},
                        acl=""), b),
            _ans(cl.get(f"/{b}", acl=""), b),
            _ans(cl.put(f"/{b}", headers={"x-amz-acl": "authenticated-read"},
                        acl=""), b),
            _ans(cl.put(f"/{b}", _acl_body(False, "someone"), acl=""), b),
            _ans(cl.put(f"/{b}", b"<AccessControlPolicy", acl=""), b),
            _ans(cl.put(f"/{b}", _acl_body(False), acl=""), b),
            _ans(cl.get(f"/{b}", acl=""), b),
            _ans(cl.put(f"/{b}", _acl_body(True), acl=""), b),
            _ans(cl.get(f"/{b}", acl=""), b),
            _ans(reader.put(f"/{b}", headers={"x-amz-acl": "private"},
                            acl=""), b),
            _ans(reader.get(f"/{b}", acl=""), b)]
    # -- the anonymous path of a public-read bucket
    anon = S3V4Client(url, "", "")
    out += [_ans(anon.request("GET", f"/{b}/k.bin", sign=False), b),
            _ans(anon.request("HEAD", f"/{b}/k.bin", sign=False), b),
            _ans(anon.request("GET", f"/{b}/missing", sign=False), b),
            _ans(anon.request("PUT", f"/{b}/new.bin", body=b"x",
                              sign=False), b),
            _ans(anon.request("GET", f"/{b}", {"acl": ""}, sign=False), b),
            _ans(anon.request("GET", f"/{b}/k.bin", {"tagging": ""},
                              sign=False), b),
            _ans(anon.request("GET", f"/{b}", sign=False), b),
            _ans(anon.request("GET", f"/{b}-priv/k.bin", sign=False), b),
            _ans(anon.request("DELETE", f"/{b}/k.bin", sign=False), b)]
    # -- lifecycle
    out += [_ans(cl.get(f"/{b}", lifecycle=""), b),
            _ans(cl.put(f"/{b}", _lifecycle(("tmp/", 7, "Enabled"),
                                            ("logs/", 30, "Enabled"),
                                            ("off/", 2, "Disabled")),
                        lifecycle=""), b),
            _ans(cl.get(f"/{b}", lifecycle=""), b),
            _ans(cl.put(f"/{b}", _lifecycle(("tmp/", 3, "Enabled")),
                        lifecycle=""), b),
            _ans(cl.get(f"/{b}", lifecycle=""), b),
            _ans(cl.put(f"/{b}", _lifecycle(("x/", None, "Enabled")),
                        lifecycle=""), b),
            _ans(cl.put(f"/{b}", _lifecycle(("x/", 0, "Enabled")),
                        lifecycle=""), b),
            _ans(cl.put(f"/{b}", _lifecycle(("x/", "soon", "Enabled")),
                        lifecycle=""), b),
            _ans(cl.put(f"/{b}", _lifecycle(("x/", 3, "Disabled")),
                        lifecycle=""), b),
            _ans(cl.put(f"/{b}", b"<Lifecycle", lifecycle=""), b),
            _ans(cl.delete(f"/{b}", lifecycle=""), b),
            _ans(cl.get(f"/{b}", lifecycle=""), b),
            _ans(cl.delete(f"/{b}", lifecycle=""), b)]
    # -- ownership controls
    out += [_ans(cl.get(f"/{b}", ownershipControls=""), b),
            _ans(cl.put(f"/{b}", _ownership("BucketOwnerEnforced"),
                        ownershipControls=""), b),
            _ans(cl.get(f"/{b}", ownershipControls=""), b),
            _ans(cl.put(f"/{b}", _ownership("Nonsense"),
                        ownershipControls=""), b),
            _ans(cl.put(f"/{b}", b"<x", ownershipControls=""), b),
            _ans(cl.delete(f"/{b}", ownershipControls=""), b),
            _ans(cl.get(f"/{b}", ownershipControls=""), b),
            _ans(cl.post(f"/{b}", ownershipControls=""), b)]
    # -- object tagging
    out += [_ans(cl.get(f"/{b}/k.bin", tagging=""), b),
            _ans(cl.put(f"/{b}/k.bin", _tagging({"team": "edge",
                                                  "tier": "hot"}),
                        tagging=""), b),
            _ans(cl.get(f"/{b}/k.bin", tagging=""), b),
            _ans(cl.put(f"/{b}/k.bin", _tagging({"only": "one"}),
                        tagging=""), b),
            _ans(cl.get(f"/{b}/k.bin", tagging=""), b),
            _ans(cl.put(f"/{b}/k.bin", b"<Tagging", tagging=""), b),
            _ans(cl.delete(f"/{b}/k.bin", tagging=""), b),
            _ans(cl.get(f"/{b}/k.bin", tagging=""), b),
            _ans(cl.get(f"/{b}/nope.bin", tagging=""), b),
            _ans(reader.put(f"/{b}/k.bin", _tagging({"a": "b"}),
                            tagging=""), b),
            _ans(cl.put(f"/{b}/k.bin", body,
                        headers={"x-amz-tagging": "via=header"}), b),
            _ans(cl.get(f"/{b}/k.bin", tagging=""), b)]
    # -- the six the reference refuses too
    out += [_ans(cl.get(f"/{b}", policy=""), b),
            _ans(cl.put(f"/{b}", b"{}", policy=""), b),
            _ans(cl.get(f"/{b}", cors=""), b),
            _ans(cl.put(f"/{b}", b"<CORSConfiguration/>", cors=""), b),
            _ans(cl.get(f"/{b}/k.bin", acl=""), b),
            _ans(cl.put(f"/{b}/k.bin", acl=""), b),
            _ans(cl.get(f"/{b}/k.bin", retention=""), b),
            _ans(cl.put(f"/{b}/k.bin", retention=""), b),
            _ans(cl.get(f"/{b}/k.bin", **{"legal-hold": ""}), b),
            _ans(cl.put(f"/{b}/k.bin", **{"legal-hold": ""}), b),
            _ans(cl.get(f"/{b}/k.bin", **{"object-lock": ""}), b),
            _ans(cl.put(f"/{b}/k.bin", **{"object-lock": ""}), b)]
    return out


def test_sub_resources_answer_as_the_reference(duo):
    rng = {pkg: np.random.default_rng(SEED) for pkg in ("reference",
                                                         "port")}
    got = {pkg: _script(duo[pkg][0], f"sr-{pkg[:3]}", rng[pkg])
           for pkg in ("reference", "port")}
    assert got["port"] == got["reference"]
    statuses = [g[0] for g in got["port"]]
    assert statuses[-12:] == [501] * 12
    # the anonymous requests: GET and HEAD of an object of the
    # public-read bucket, a missing key, then six refusals
    assert statuses[16:25] == [200, 200, 404] + [403] * 6


def test_a_setting_one_gateway_makes_the_other_reads(duo):
    c = duo["cluster"]
    for writer, reader in (("reference", "port"), ("port", "reference")):
        b = f"cross-{writer[:3]}"
        w = S3V4Client(duo[writer][0], AK, SK)
        r = S3V4Client(duo[reader][0], AK, SK)
        anon = S3V4Client(duo[reader][0], "", "")
        assert w.put(f"/{b}").status == 200
        assert w.put(f"/{b}/o.txt", b"shared bytes").status == 200
        assert anon.request("GET", f"/{b}/o.txt",
                            sign=False).status == 403
        assert w.put(f"/{b}", headers={"x-amz-acl": "public-read"},
                     acl="").status == 200
        assert w.put(f"/{b}", _lifecycle(("tmp/", 5, "Enabled")),
                     lifecycle="").status == 200
        assert w.put(f"/{b}", _ownership("ObjectWriter"),
                     ownershipControls="").status == 200
        assert w.put(f"/{b}/o.txt", _tagging({"k": "v"}),
                     tagging="").status == 200
        _fresh(duo[reader][1], b)
        got = anon.request("GET", f"/{b}/o.txt", sign=False)
        assert (got.status, got.body) == (200, b"shared bytes")
        for params in ({"acl": ""}, {"lifecycle": ""},
                       {"ownershipControls": ""}):
            assert _ans(r.get(f"/{b}", **params), b) == \
                _ans(w.get(f"/{b}", **params), b)
        assert _ans(r.get(f"/{b}/o.txt", tagging=""), b) == \
            _ans(w.get(f"/{b}/o.txt", tagging=""), b)
        assert b"<Days>5</Days>" in r.get(f"/{b}", lifecycle="").body
        # and taken back through the reader
        assert r.put(f"/{b}", headers={"x-amz-acl": "private"},
                     acl="").status == 200
        assert r.delete(f"/{b}", lifecycle="").status == 204
        _fresh(duo[writer][1], b)
        assert S3V4Client(duo[writer][0], "", "").request(
            "GET", f"/{b}/o.txt", sign=False).status == 403
        assert w.get(f"/{b}", lifecycle="").status == 404
    assert requests.get(f"{c.filer_url}/kv/filer.conf",
                        timeout=10).status_code == 200


def test_filer_conf_bytes_after_lifecycle_verbs(duo):
    c = duo["cluster"]
    kv = f"{c.filer_url}/kv/filer.conf"
    seed_conf = {"rules": [
        {"location_prefix": "/buckets/lcb/logs/", "ttl": "30d",
         "replication": "001"},
        {"location_prefix": "/buckets/other/", "ttl": "2d"},
        {"location_prefix": "/buckets/lcb/raw/", "ttl": "12h"}]}
    out = {}
    for pkg in ("reference", "port"):
        cl = S3V4Client(duo[pkg][0], AK, SK)
        assert cl.put("/lcb").status in (200, 409)
        requests.put(kv, data=json.dumps(seed_conf), timeout=10)
        steps = [cl.put("/lcb", _lifecycle(("logs/", 7, "Enabled"),
                                           ("tmp/", 1, "Enabled")),
                        lifecycle="").status]
        after_put = requests.get(kv, timeout=10).content
        steps.append(_ans(cl.get("/lcb", lifecycle=""), "lcb"))
        steps.append(cl.delete("/lcb", lifecycle="").status)
        after_delete = requests.get(kv, timeout=10).content
        steps.append(cl.get("/lcb", lifecycle="").status)
        out[pkg] = (steps, after_put, after_delete)
    assert out["port"] == out["reference"]
    rules = json.loads(out["port"][2])["rules"]
    logs = next(r for r in rules
                if r["location_prefix"] == "/buckets/lcb/logs/")
    assert logs["ttl"] == "" and logs["replication"] == "001"
    assert out["port"][0][0] == 200 and out["port"][0][2:] == [204, 404]


# -- POST-policy form uploads ---------------------------------------------
def _policy(conditions, expire_in=300, expiration=None) -> str:
    doc = {"conditions": conditions}
    if expiration is not None or expire_in is not None:
        doc["expiration"] = expiration or time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() + expire_in))
    return base64.b64encode(json.dumps(doc).encode()).decode()


def _form(policy_b64: str, key: str, **extra) -> dict:
    fields = sigv4_client.sign_policy(policy_b64, AK, SK)
    fields["key"] = key
    fields.update(extra)
    return fields


def _form_cases(b: str) -> list:
    ok = [{"bucket": b}, ["starts-with", "$key", "in/"],
          ["content-length-range", 1, 1 << 20]]
    return [
        ("ok", _form(_policy(ok), "in/a.bin"), ("a.bin", b"form body")),
        ("201", _form(_policy(ok), "in/b.bin",
                      success_action_status="201"), ("b.bin", b"bb")),
        ("200", _form(_policy(ok), "in/c.bin",
                      success_action_status="200"), ("c.bin", b"cc")),
        ("odd status", _form(_policy(ok), "in/d.bin",
                             success_action_status="302"),
         ("d.bin", b"dd")),
        ("filename", _form(_policy(ok), "in/${filename}"),
         ("named.txt", b"named")),
        ("eq", _form(_policy([["eq", "$key", "in/eq.bin"]]), "in/eq.bin"),
         ("e", b"eq")),
        ("eq refused", _form(_policy([["eq", "$key", "in/eq.bin"]]),
                             "in/other.bin"), ("e", b"x")),
        ("outside starts-with", _form(_policy(ok), "out/x.bin"),
         ("x", b"x")),
        ("wrong bucket", _form(_policy([{"bucket": "elsewhere"}]),
                               "in/w.bin"), ("w", b"x")),
        ("too large", _form(_policy(
            [["content-length-range", 1, 4]]), "in/big.bin"),
         ("big", b"too big")),
        ("too small", _form(_policy(
            [["content-length-range", 10, 40]]), "in/small.bin"),
         ("s", b"tiny")),
        ("expired", _form(_policy(ok, expire_in=-10), "in/late.bin"),
         ("l", b"x")),
        ("no expiration", _form(_policy(ok, expire_in=None), "in/n.bin"),
         ("n", b"x")),
        ("bad expiration", _form(_policy(ok, expiration="tomorrow"),
                                 "in/n.bin"), ("n", b"x")),
        ("bad signature", {**_form(_policy(ok), "in/s.bin"),
                           "x-amz-signature": "0" * 64}, ("s", b"x")),
        ("not json", _form(base64.b64encode(b"{nope").decode(),
                           "in/j.bin"), ("j", b"x")),
        ("no policy", {"key": "in/p.bin"}, ("p", b"x")),
        ("no key", {k: v for k, v in _form(_policy(ok), "").items()
                    if k != "key"}, ("k", b"x")),
        ("unknown key", {**_form(_policy(ok), "in/u.bin"),
                         "x-amz-credential": "NOKEY/20260101/us-east-1/"
                                             "s3/aws4_request"},
         ("u", b"x")),
    ]


def test_post_policy_uploads_answer_as_the_reference(duo):
    out = {}
    for pkg in ("reference", "port"):
        b = f"form-{pkg[:3]}"
        cl = S3V4Client(duo[pkg][0], AK, SK)
        assert cl.put(f"/{b}").status == 200
        got = []
        for name, fields, (fname, data) in _form_cases(b):
            r = requests.post(f"{duo[pkg][0]}/{b}", data=fields,
                              files={"file": (fname, data)}, timeout=30)
            body = _mask(r.content, b) if r.content else b""
            got.append((name, r.status_code, body, r.headers.get("ETag")))
        listing = cl.get(f"/{b}", prefix="in/")
        keys = sorted(el.text for el in ET.fromstring(listing.body).iter()
                      if el.tag.endswith("Key"))
        got.append(keys)
        got.append([cl.get(f"/{b}/{k}").body for k in keys])
        out[pkg] = got
    assert out["port"] == out["reference"]
    codes = {g[0]: g[1] for g in out["port"][:-2]}
    assert (codes["ok"], codes["201"], codes["200"], codes["odd status"]) \
        == (204, 201, 200, 204)
    assert codes["outside starts-with"] == codes["expired"] == 403
    assert codes["too large"] == codes["too small"] == 400
    assert out["port"][-2] == ["in/a.bin", "in/b.bin", "in/c.bin",
                               "in/d.bin", "in/eq.bin", "in/named.txt"]


def test_post_policy_upload_on_an_open_gateway(ext_fixtures):
    """No identities: the form needs no policy, as in the reference."""
    s3 = ext_fixtures["pp"].s3_url
    requests.put(f"{s3}/open-forms", timeout=10)
    r = requests.post(f"{s3}/open-forms", data={"key": "f/${filename}"},
                      files={"file": ("x.txt", b"open form")}, timeout=10)
    assert r.status_code == 204
    assert requests.get(f"{s3}/open-forms/f/x.txt",
                        timeout=10).content == b"open form"


# -- the filer's browser listing ----------------------------------------------
NAMES = ["a.txt", "<img src=x onerror=alert(1)>.txt", "space name.bin",
         "ünïcödé.md", "q?x=1&y=2", "zz"]


def _entries(entry_cls, chunk_cls) -> list:
    out = []
    for i, n in enumerate(NAMES):
        out.append(entry_cls(
            full_path=f"/site/{n}", mode=0o644, mtime=1_700_000_000.0 + i,
            crtime=1_700_000_000.0,
            chunks=[chunk_cls(fid=f"3,{i + 1:x}01020304", offset=0,
                              size=1000 * (i + 1) ** 3, mtime_ns=1)]))
    for d in ("sub", "sub2"):
        out.append(entry_cls(full_path=f"/site/{d}", mode=0o40755,
                             mtime=1_700_000_100.0,
                             crtime=1_700_000_100.0))
    return out


@pytest.fixture(scope="module")
def filers():
    ref_fs = RefFilerServer("http://127.0.0.1:9", store="memory")
    port_fs = FilerServer("http://127.0.0.1:9", store="memory")
    threads = []
    try:
        for fs, ent, ch in ((ref_fs, RefEntry, RefChunk),
                            (port_fs, Entry, FileChunk)):
            for e in _entries(ent, ch):
                fs.filer.create_entry(e)
        threads.append(RefServerThread(ref_fs.app).start())
        threads.append(ServerThread(port_fs.app).start())
        yield {"reference": threads[0].url, "port": threads[1].url}
    finally:
        for t in threads:
            within(30, t.stop)
        ref_fs.filer.close()
        port_fs.filer.close()


@pytest.mark.parametrize("query", [
    "", "?limit=3", "?limit=3&lastFileName=q%3Fx%3D1%26y%3D2",
    "?prefix=s&limit=1", "?namePattern=*.txt&limit=2",
    "?namePatternExclude=*.md&limit=4"])
@pytest.mark.parametrize("path", ["/site", "/site/", "/"])
def test_html_listing_byte_equal(filers, path, query):
    got = []
    for pkg in ("reference", "port"):
        r = requests.get(filers[pkg] + path + query, timeout=10,
                         headers={"Accept": "text/html,*/*;q=0.8"})
        got.append((r.status_code, r.headers.get("Content-Type"),
                    r.headers.get("X-Seaweed-Entry"), r.content))
    assert got[1] == got[0]
    assert got[1][0] == 200 and got[1][3].startswith(b"<html>")
    if path != "/":
        assert b"&lt;img src=x" in got[1][3] or "lastFileName" in query \
            or "prefix" in query or "namePattern" in query


@pytest.mark.parametrize("accept", ["application/json",
                                    "text/html, application/json", ""])
def test_listing_is_json_unless_html_alone_is_accepted(filers, accept):
    got = []
    for pkg in ("reference", "port"):
        r = requests.get(filers[pkg] + "/site", timeout=10,
                         headers={"Accept": accept} if accept else {})
        got.append((r.status_code, r.headers.get("X-Seaweed-Entry"),
                    r.json()))
    assert got[1] == got[0]
    assert [e["full_path"].rsplit("/", 1)[-1]
            for e in got[1][2]["entries"]] == sorted(NAMES + ["sub",
                                                              "sub2"])

