"""The port's IAM API against the JAX package's, with tolerance 0.

* The IAM cases of tests/test_webdav_iam.py run `[reference]` on the
  JAX package's IAM server, filer and S3 gateway and `[port]` on the
  port's (user, key and policy lifecycles; the policy mapping; a key
  the gateway reloads and then enforces).
* Over each package's filer, the same Action sequence sent to the
  reference's IAM server and to the port's leaves the same identities
  document in the filer KV (`s3/identities`), byte for byte, after
  every step, and gets the same statuses and XML (request and user ids
  masked); the `secrets` generators of both modules are patched to the
  same fixed values.
* `policy_to_actions` maps every policy document of a seeded set as the
  reference does.
* A key minted through either package's IAM server reaches the port's
  S3 gateway: a signed PUT with it is taken once the gateway reloads,
  refused on a bucket its policy does not name, and refused after
  DeleteAccessKey (each polled, the gateway reloads on a timer).
"""
import functools
import itertools
import json
import re
import time

import numpy as np
import pytest
import requests

from seaweedfs_tpu.iam import server as ref_iam
from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.iam import server as port_iam
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_webdav_iam as ref_cases
from tests.test_s3 import sign_request
from tests.torch_port_cases import port_cases, run_case, swap_modules, within

SEED = 20261018
PortCluster = functools.partial(Cluster, ec_backend="native")
PKG = {"reference": (RefCluster, ref_iam, RefServerThread),
       "port": (PortCluster, port_iam, ServerThread)}
CASES = {k: v for k, v in port_cases(ref_cases).items()
         if k.startswith("TestIam.")}
KV = "/kv/s3/identities"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A reference and a port cluster, each with a filer and an S3
    gateway reloading identities every 0.3 s; over each filer a
    reference and a port IAM server."""
    out = {"clusters": {}, "iam": {}, "threads": []}
    try:
        for side, (Cl, _, _) in PKG.items():
            c = within(60, Cl, str(tmp_path_factory.mktemp(f"iam_{side}")),
                       n_volume_servers=1, volume_size_limit=16 << 20,
                       with_filer=True, with_s3=True)
            c.s3.identity_refresh_seconds = 0.3
            out["clusters"][side] = c
        for filer, c in out["clusters"].items():
            for gw, (_, mod, Thread) in PKG.items():
                t = Thread(mod.IamApiServer(c.filer_url).app).start()
                out["threads"].append(t)
                out["iam"][(gw, filer)] = t.url
        yield out
    finally:
        for t in out["threads"]:
            within(30, t.stop)
        for c in out["clusters"].values():
            within(60, c.stop)


def test_every_reference_case_is_mirrored():
    assert len(CASES) == 4


@pytest.mark.parametrize("side", list(PKG))
@pytest.mark.parametrize("case", list(CASES))
def test_reference_iam_cases(case, side, world):
    c = world["clusters"][side]
    fixtures = {"gateways": {"iam": world["iam"][(side, side)],
                             "cluster": c, "s3": c.s3_url}}
    mapping = {"seaweedfs_tpu.iam.server": port_iam} if side == "port" \
        else {}
    with swap_modules(mapping, parents=True):
        run_case(CASES[case], fixtures)
    requests.delete(c.filer_url + KV, timeout=30)


class _FixedSecrets:
    """The two generators the IAM servers draw keys from, counting."""

    def __init__(self):
        self._n = itertools.count()

    def token_hex(self, n: int) -> str:
        return f"{next(self._n):0{2 * n}x}"

    def token_urlsafe(self, n: int) -> str:
        return f"secret-{next(self._n):04d}-" + "s" * n


_POLICY = json.dumps({"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:GetObject", "s3:PutObject",
                                   "s3:ListBucket", "s3:GetObjectTagging"],
     "Resource": ["arn:aws:s3:::photos/*", "arn:aws:s3:::photos"]},
    {"Effect": "Deny", "Action": "s3:*", "Resource": "arn:aws:s3:::*"}]})
_STEPS = [
    {"Action": "ListUsers"},
    {"Action": "CreateUser", "UserName": "alice"},
    {"Action": "CreateUser", "UserName": "alice"},
    {"Action": "GetUser", "UserName": "alice"},
    {"Action": "GetUser", "UserName": "nobody"},
    {"Action": "CreateAccessKey", "UserName": "alice"},
    {"Action": "CreateAccessKey", "UserName": "alice"},
    {"Action": "CreateAccessKey", "UserName": "bob & <co>"},
    {"Action": "ListAccessKeys", "UserName": "alice"},
    {"Action": "ListAccessKeys", "UserName": "nobody"},
    {"Action": "PutUserPolicy", "UserName": "alice", "PolicyName": "p1",
     "PolicyDocument": _POLICY},
    {"Action": "PutUserPolicy", "UserName": "nobody",
     "PolicyDocument": _POLICY},
    {"Action": "GetUserPolicy", "UserName": "alice"},
    {"Action": "GetUserPolicy", "UserName": "bob & <co>"},
    {"Action": "DeleteAccessKey", "UserName": "alice",
     "AccessKeyId": "AKINOSUCHKEY"},
    {"Action": "DeleteAccessKey", "UserName": "alice",
     "AccessKeyId": "AKI0000000000000000"},
    {"Action": "DeleteAccessKey", "UserName": "alice"},
    {"Action": "ListUsers"},
    {"Action": "DeleteUserPolicy", "UserName": "alice"},
    {"Action": "DeleteUserPolicy", "UserName": "nobody"},
    {"Action": "DeleteUser", "UserName": "bob & <co>"},
    {"Action": "DeleteUser", "UserName": "bob & <co>"},
    {"Action": "NoSuchAction"},
    {"Action": ""},
    {},
    {"Action": "ListUsers"},
]
_IDS = re.compile(rb"<(RequestId|UserId)>[0-9a-f-]{36}</")


@pytest.mark.parametrize("filer", list(PKG))
def test_same_actions_leave_the_same_document(filer, world, monkeypatch):
    fu = world["clusters"][filer].filer_url
    got = {}
    for gw, (_, mod, _) in PKG.items():
        monkeypatch.setattr(mod, "secrets", _FixedSecrets())
        requests.delete(fu + KV, timeout=30)
        trail = []
        for step in _STEPS:
            r = requests.post(world["iam"][(gw, filer)] + "/", data=step,
                              timeout=30)
            doc = requests.get(fu + KV, timeout=30)
            trail.append((step.get("Action"), r.status_code,
                          r.headers["Content-Type"],
                          _IDS.sub(rb"<\1>ID</", r.content),
                          doc.status_code, doc.content))
        got[gw] = trail
    requests.delete(fu + KV, timeout=30)
    for ref, port in zip(got["reference"], got["port"]):
        assert port == ref, ref[:2]
    statuses = [s for _, s, *_ in got["port"]]
    assert (statuses.count(200), statuses.count(404), statuses.count(409),
            statuses.count(400)) == (14, 7, 1, 4)
    final = json.loads(got["port"][-1][-1])
    assert [(i["name"], [c["accessKey"] for c in i["credentials"]],
             i["actions"]) for i in final["identities"]] == [
        ("alice", ["AKI0000000000000002"], [])]


@pytest.mark.parametrize("gw", list(PKG))
def test_a_multipart_form_reads_as_a_url_encoded_one(gw, world,
                                                    monkeypatch):
    """aiohttp's `request.post()` reads multipart/form-data fields too;
    any other body reads as no field (InvalidAction)."""
    fu = world["clusters"]["port"].filer_url
    url = world["iam"][(gw, "port")] + "/"
    monkeypatch.setattr(PKG[gw][1], "secrets", _FixedSecrets())
    requests.delete(fu + KV, timeout=30)
    fields = {"Action": (None, "CreateAccessKey"),
              "UserName": (None, "erin")}
    r = requests.post(url, files=fields, timeout=30)
    assert r.status_code == 200, r.text
    assert "<AccessKeyId>AKI0000000000000000</AccessKeyId>" in r.text
    r = requests.post(url, data=b'{"Action": "ListUsers"}', timeout=30,
                      headers={"Content-Type": "application/json"})
    assert r.status_code == 400 and "<Code>InvalidAction</Code>" in r.text
    doc = json.loads(requests.get(fu + KV, timeout=30).content)
    requests.delete(fu + KV, timeout=30)
    assert [i["name"] for i in doc["identities"]] == ["erin"]


def _policies() -> list[dict]:
    rng = np.random.default_rng([SEED, 3])
    verbs = ["s3:*", "s3:GetObject", "s3:PutObject", "s3:DeleteObject",
             "s3:ListBucket", "s3:ListAllMyBuckets", "s3:GetObjectTagging",
             "s3:PutObjectTagging", "s3:DeleteObjectTagging",
             "s3:CreateBucket", "s3:AbortMultipartUpload", "*"]
    res = ["arn:aws:s3:::*", "arn:aws:s3:::b1", "arn:aws:s3:::b1/*",
           "arn:aws:s3:::b2/x/*", "arn:aws:s3:::", "*"]
    out = []
    for _ in range(48):
        sts = []
        for _ in range(int(rng.integers(1, 4))):
            acts = list(rng.choice(verbs, int(rng.integers(1, 4))))
            rs = list(rng.choice(res, int(rng.integers(1, 3))))
            sts.append({"Effect": str(rng.choice(["Allow", "Allow", "Deny"])),
                        "Action": acts[0] if len(acts) == 1 else acts,
                        "Resource": rs[0] if len(rs) == 1 else rs})
        out.append({"Statement": sts})
    return out + [{}, {"Statement": []}]


@pytest.mark.parametrize("i", range(50))
def test_policy_mapping_is_the_references(i):
    doc = _policies()[i]
    assert port_iam.policy_to_actions(doc) == ref_iam.policy_to_actions(doc)


def _signed_put(s3: str, bucket: str, key: str, ak: str, sk: str) -> int:
    url = f"{s3}/{bucket}/{key}"
    h = sign_request("PUT", url, ak, sk, payload=b"iam bytes")
    return requests.put(url, data=b"iam bytes", headers=h,
                        timeout=30).status_code


def _poll(pred, what: str, deadline: float = 20.0):
    end = time.monotonic() + deadline
    while not pred():
        assert time.monotonic() < end, what
        time.sleep(0.1)


@pytest.mark.parametrize("gw", list(PKG))
def test_a_minted_key_reaches_the_port_gateway(gw, world):
    c = world["clusters"]["port"]
    iam = world["iam"][(gw, "port")] + "/"
    requests.delete(c.filer_url + KV, timeout=30)
    for b in ("granted", "other"):
        assert requests.put(f"{c.filer_url}/buckets/{b}",
                            params={"mkdir": "1"}, timeout=30).ok
    user = f"carol-{gw}"
    assert requests.post(iam, data={"Action": "CreateUser",
                                    "UserName": user},
                         timeout=30).status_code == 200
    r = requests.post(iam, data={"Action": "CreateAccessKey",
                                 "UserName": user}, timeout=30)
    ak = re.search(r"<AccessKeyId>([^<]+)<", r.text).group(1)
    sk = re.search(r"<SecretAccessKey>([^<]+)<", r.text).group(1)
    policy = json.dumps({"Statement": [{
        "Effect": "Allow", "Action": ["s3:PutObject", "s3:GetObject"],
        "Resource": "arn:aws:s3:::granted/*"}]})
    assert requests.post(iam, data={
        "Action": "PutUserPolicy", "UserName": user, "PolicyName": "w",
        "PolicyDocument": policy}, timeout=30).status_code == 200
    t0 = time.monotonic()
    _poll(lambda: _signed_put(c.s3_url, "granted", "k1", ak, sk) == 200,
          "the gateway never took the minted key")
    took = time.monotonic() - t0
    assert took < 10
    assert _signed_put(c.s3_url, "other", "k1", ak, sk) == 403
    assert requests.put(f"{c.s3_url}/granted/anon", data=b"x",
                        timeout=30).status_code == 403
    assert requests.post(iam, data={"Action": "DeleteAccessKey",
                                    "UserName": user, "AccessKeyId": ak},
                         timeout=30).status_code == 200
    _poll(lambda: _signed_put(c.s3_url, "granted", "k2", ak, sk) == 403,
          "the gateway kept the deleted key")
    requests.delete(c.filer_url + KV, timeout=30)
