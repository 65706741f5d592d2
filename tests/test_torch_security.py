"""The port's JWT write authorization (seaweedfs_tpu_torch/utils/security.py,
the master's signing, the volume servers' guard, the filer's fid pool)
against the JAX package's, with tolerance 0.

* Tokens: both `sign_jwt`s give byte-equal tokens for the same secret,
  fid, expiry and second (seeded inputs, a pinned `time.time`), each
  package verifies the other's, and the tamper / expiry / fid / `_N`
  cases fail with the same reason in both.
* The reference's tests/test_security_jwt.py runs on the port
  (tests/torch_port_cases.py rebinds its names to the port's).
* The guard's statuses: the same requests (no token, a tampered
  signature, an expired token, another fid's token, a good one, a `_N`
  slot under its base fid's token) to a reference and a port cluster
  under one secret, on the primary and on a replica, give the same
  status and reason.
* The filer's fid pool skips a batch slot whose token is older than
  `_FID_TOKEN_MAX_AGE` (the reference's filer_server.py:189-192).
"""
import time

import numpy as np
import pytest
import requests

from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.utils import security as ref_security
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.utils import security

from tests import test_security_jwt as ref_cases
from tests.torch_port_cases import port_cases, run_case

SECRET = "parity-secret"
CASES = port_cases(ref_cases, sign_jwt=security.sign_jwt,
                   verify_jwt=security.verify_jwt, Guard=security.Guard,
                   Cluster=Cluster, verbs=verbs)


def _seeded_inputs(seed: int) -> tuple[str, str, int]:
    rng = np.random.default_rng(seed)
    secret = "".join(chr(c) for c in rng.integers(33, 127, 24))
    fid = f"{int(rng.integers(1, 1 << 16))},{int(rng.integers(1, 1 << 40)):x}" \
          f"{int(rng.integers(0, 1 << 32)):08x}"
    return secret, fid, int(rng.integers(-30, 3600))


@pytest.fixture(scope="module")
def jwt_cluster(tmp_path_factory):
    c = Cluster(str(tmp_path_factory.mktemp("jwtc")), n_volume_servers=2,
                volume_size_limit=8 << 20, jwt_secret=ref_cases.SECRET)
    yield c
    c.stop()


@pytest.mark.parametrize("case", list(CASES))
def test_reference_jwt_cases_on_the_port(case, jwt_cluster):
    run_case(CASES[case], {"jwt_cluster": jwt_cluster})


@pytest.mark.parametrize("seed", range(8))
def test_tokens_byte_equal(seed, monkeypatch):
    secret, fid, expires = _seeded_inputs(seed)
    monkeypatch.setattr(time, "time", lambda: 1_790_000_000.25 + seed)
    ours = security.sign_jwt(secret, fid, expires)
    theirs = ref_security.sign_jwt(secret, fid, expires)
    assert ours == theirs
    assert security.Guard(secret).sign(fid) == \
        ref_security.Guard(secret).sign(fid)
    assert security.Guard("").sign(fid) == ref_security.Guard("").sign(
        fid) == ""


@pytest.mark.parametrize("seed", range(4))
def test_each_package_verifies_the_others_tokens(seed):
    secret, fid, _ = _seeded_inputs(seed)
    a = security.sign_jwt(secret, fid, 60)
    b = ref_security.sign_jwt(secret, fid, 60)
    assert ref_security.verify_jwt(secret, a, fid) == \
        security.verify_jwt(secret, b, fid)
    ref_security.Guard(secret).check(f"Bearer {a}", f"{fid}_3")
    security.Guard(secret).check(f"Bearer {b}", f"{fid}_3")


def _reason(fn) -> str:
    try:
        fn()
    except PermissionError as e:
        return str(e)
    return "ok"


def _bad_tokens(secret: str, fid: str, mod) -> dict[str, tuple]:
    good = mod.sign_jwt(secret, fid, 60)
    h, p, s = good.split(".")
    return {
        "good": (f"Bearer {good}", fid),
        "slot": (f"Bearer {good}", f"{fid}_7"),
        "missing": (None, fid),
        "not bearer": (f"Basic {good}", fid),
        "malformed": ("Bearer not-a-jwt", fid),
        "tampered": (f"Bearer {h}.{p}.AAAA{s[4:]}", fid),
        "expired": (f"Bearer {mod.sign_jwt(secret, fid, -5)}", fid),
        "other fid": (f"Bearer {mod.sign_jwt(secret, '9,0badf00d', 60)}",
                      fid),
        "other slot base": (f"Bearer {good}", "9,0badf00d_7"),
        "wrong secret": (f"Bearer {mod.sign_jwt('x' + secret, fid, 60)}",
                         fid),
    }


@pytest.mark.parametrize("seed", range(3))
def test_guard_reasons_match(seed, monkeypatch):
    secret, fid, _ = _seeded_inputs(seed)
    monkeypatch.setattr(time, "time", lambda: 1_790_000_000.0 + seed)
    ours = _bad_tokens(secret, fid, security)
    theirs = _bad_tokens(secret, fid, ref_security)
    assert ours == theirs       # the same tokens, byte for byte
    for name, (auth, target) in ours.items():
        got = _reason(lambda: security.Guard(secret).check(auth, target))
        want = _reason(lambda: ref_security.Guard(secret).check(auth,
                                                                target))
        assert got == want, name
        assert (got == "ok") == (name in ("good", "slot")), (name, got)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    ref = RefCluster(str(tmp_path_factory.mktemp("jwt_ref")),
                     n_volume_servers=2, volume_size_limit=8 << 20,
                     jwt_secret=SECRET)
    try:
        port = Cluster(str(tmp_path_factory.mktemp("jwt_port")),
                       n_volume_servers=2, volume_size_limit=8 << 20,
                       jwt_secret=SECRET)
    except BaseException:
        ref.stop()
        raise
    yield {"reference": ref, "port": port}
    port.stop()
    ref.stop()


def _statuses(c, which: str) -> list[tuple[str, int, str]]:
    """The same sequence of guarded requests on a replicated volume:
    writes, reads and deletes on the primary and straight at the
    replica, each with (status, body text of a refusal)."""
    a = verbs.assign(c.master_url, replication="001", count=3)
    assert a.auth, "a guarded master signs every assign"
    vid = int(a.fid.split(",")[0])
    nodes = sorted(n.url for n in c.master.topo.lookup(vid))
    assert len(nodes) == 2
    replica = next(u for u in nodes if u != a.url)
    toks = _bad_tokens(SECRET, a.fid, security)
    out = []

    def record(label, r):
        out.append((label, r.status_code,
                    r.text if r.status_code == 401 else ""))

    for where in (a.url, replica):
        for name in ("missing", "not bearer", "malformed", "tampered",
                     "expired", "other fid", "other slot base",
                     "wrong secret"):
            auth, target = toks[name]
            hdr = {"Authorization": auth} if auth else {}
            record(f"POST {name} @{where == a.url}", requests.post(
                f"http://{where}/{target}", data=b"refused", headers=hdr,
                timeout=30))
            record(f"DELETE {name} @{where == a.url}", requests.delete(
                f"http://{where}/{target}", headers=hdr, timeout=30))
    good = {"Authorization": f"Bearer {a.auth}"}
    record("POST good", requests.post(f"http://{a.url}/{a.fid}",
                                      data=b"guarded", headers=good,
                                      timeout=30))
    for u in (a.url, replica):
        got = requests.get(f"http://{u}/{a.fid}", timeout=30)
        record(f"GET replica={u != a.url}", got)
        assert got.content == b"guarded", which
    for i in (1, 2):
        record(f"POST slot {i}", requests.post(
            f"http://{a.url}/{a.fid}_{i}", data=b"slot", headers=good,
            timeout=30))
    record("DELETE good", requests.delete(f"http://{a.url}/{a.fid}",
                                          headers=good, timeout=30))
    for u in (a.url, replica):
        record(f"GET after delete replica={u != a.url}",
               requests.get(f"http://{u}/{a.fid}", timeout=30))
    return out


def test_guard_statuses_match_on_primary_and_replica(clusters):
    ref = _statuses(clusters["reference"], "reference")
    port = _statuses(clusters["port"], "port")
    assert port == ref
    assert {s for _, s, _ in ref if s == 401}, ref


def test_filer_pool_skips_slots_whose_token_aged(monkeypatch):
    """A pooled batch slot older than 7 s is never handed out under a
    secret: its token would be refused (the master's are valid 10 s)."""
    fs = FilerServer.__new__(FilerServer)
    fs._fid_lock = __import__("threading").Lock()
    fs._fid_pools = {}
    fs.masters = type("M", (), {"masters": ["m"],
                                "master_url": "http://m"})()
    calls = []

    def assign(master, count, **kw):
        calls.append(count)
        n = len(calls)
        return verbs.AssignResult(fid=f"{n},0{n}aabbccdd", url="v:1",
                                  public_url="v:1", count=count,
                                  auth=f"tok{n}")
    monkeypatch.setattr(verbs, "assign", assign)
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    first = fs._assign("", "", "", "")
    assert first == ("v:1", "1,01aabbccdd", "tok1")
    assert fs._assign("", "", "", "") == ("v:1", "1,01aabbccdd_1", "tok1")
    clock[0] += FilerServer._FID_TOKEN_MAX_AGE + 0.5
    # every pooled slot of assign 1 is now too old: a new assign
    assert fs._assign("", "", "", "") == ("v:1", "2,02aabbccdd", "tok2")
    assert calls == [FilerServer.ASSIGN_BATCH] * 2
