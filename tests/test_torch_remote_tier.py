"""The port's remote tier against the JAX package's (tolerance 0).

* `remote_storage`: `LocalRemoteClient` round trips (write, ranged
  reads, head, traverse, directories, delete) give the same answers in
  both packages, and both refuse a key that escapes the root;
  `parse_remote_spec` / `make_client` accept and refuse the same specs
  (the `gcs` / `azure` REST clients included).
* `tier_shard_key` equal.
* A volume's .dat tiered to an S3 bucket (a port gateway):
  `Volume.tier_upload` writes the same .vif and the same object in both
  packages (clocks pinned), each package opens the other's tiered
  volume (ranged GETs) and reads every needle equal, and
  `tier_download` brings back the same .dat.
* EC shards offloaded to a cold `local` tier: `Store.tier_offload_ec`
  writes the same `.rsm` manifest and the same 14 objects in both
  packages; each package's Store, restarted on the other's directory,
  re-mounts the offloaded shards remote-backed from the manifest and
  reads every needle equal; `tier_recall_ec` restores every shard.
* Crash safety in both packages: a cold tier that fails after N
  shards, then a resume: exactly 14 objects (no duplicate, none
  missing), each equal to its shard; the same for a recall that fails
  mid-way.
* The reference's own cases of tests/test_tiering.py for the .dat tier
  (upload / read / download, a replicated volume uploaded once, a
  tiered volume that survives a remount, the rclone backend failing
  fast) run unchanged on the port's `Cluster`
  (tests/torch_port_cases.py).
"""
import functools
import hashlib
import json
import os
import types as pytypes

import numpy as np
import pytest
import requests

from seaweedfs_tpu.remote_storage import client as ref_remote
from seaweedfs_tpu.storage import backend as ref_backend
from seaweedfs_tpu.storage import needle as ref_ndl
from seaweedfs_tpu.storage import store as ref_store
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu_torch.ec import geometry as geo
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.remote_storage import client as port_remote
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.repl import run_command
from seaweedfs_tpu_torch.storage import backend as port_backend
from seaweedfs_tpu_torch.storage import needle as port_ndl
from seaweedfs_tpu_torch.storage import store as port_store
from seaweedfs_tpu_torch.storage import volume as port_volume

from tests import test_tiering as ref_cases
from tests.torch_port_cases import call_case, port_cases

T0 = 1_760_000_000_123_456_789
VID = 7
SEED = 20261017
PKGS = {
    "reference": pytypes.SimpleNamespace(
        remote=ref_remote, backend=ref_backend, store=ref_store,
        volume=ref_volume, Needle=ref_ndl.Needle, ec_backend="numpy"),
    "port": pytypes.SimpleNamespace(
        remote=port_remote, backend=port_backend, store=port_store,
        volume=port_volume, Needle=port_ndl.Needle, ec_backend="native"),
}
PortCluster = functools.partial(Cluster, ec_backend=CudaCodec(device="cpu"))


@pytest.fixture()
def pinned_clock(monkeypatch):
    clock = pytypes.SimpleNamespace(time_ns=lambda: T0,
                                    time=lambda: T0 / 1e9)
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.volume, "time", clock)
        monkeypatch.setattr(pkg.store, "time", clock)


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _file_digest(path) -> str:
    with open(path, "rb") as f:
        return _digest(f.read())


def _files(root) -> dict[str, str]:
    """{relative path: sha256} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = _file_digest(p)
    return out


def _needles(seed: int, target: int = 1_500_000) -> list[dict]:
    rng = np.random.default_rng(seed)
    out, total = [], 0
    while total < target:
        size = int(np.exp(rng.uniform(np.log(1 << 10), np.log(96 << 10))))
        out.append(dict(id=int(rng.integers(1, 1 << 40)),
                        cookie=int(rng.integers(0, 1 << 32)),
                        data=rng.bytes(size)))
        total += size
    return out


def _reads(store, needles) -> list:
    return [(kw["id"], _digest(bytes(store.read_needle(
        VID, kw["id"], kw["cookie"]).data))) for kw in needles]


# ----------------------------------------------------------------------
# remote_storage: the local client, specs, factory
# ----------------------------------------------------------------------
def _local_round_trip(mod, root) -> list:
    c = mod.LocalRemoteClient(root=str(root))
    out = []
    for i, key in enumerate(("a/b/one.bin", "/a/two.bin", "three.bin")):
        e = c.write_file(key, bytes([i]) * (1000 + i))
        out.append(("write", e.key, e.size, e.etag))
    out.append(("read", c.read_file("a/b/one.bin")[:5],
                c.read_file("a/b/one.bin", 998, 10),
                c.read_file("/a/two.bin", 3, -1)[:2]))
    h = c.head("a/two.bin")
    out.append(("head", h.key, h.size, c.head("nope")))
    out.append(("traverse", [(e.key, e.size) for e in c.traverse()],
                [e.key for e in c.traverse("a/")]))
    c.write_directory("d/e")
    out.append(("buckets", c.list_buckets()))
    c.remove_directory("d")
    c.delete_file("three.bin")
    c.delete_file("three.bin")          # absent: no error
    out.append(("after", sorted(e.key for e in c.traverse()),
                c.list_buckets()))
    for bad in ("../escape", "a/../../x", "/../../etc/passwd"):
        try:
            c.write_file(bad, b"x")
            out.append(("escaped", bad))
        except PermissionError as e:
            out.append(("refused", str(e)))
    return out


def test_local_client_round_trip(tmp_path):
    got = {name: _local_round_trip(pkg.remote, tmp_path / name)
           for name, pkg in PKGS.items()}
    assert got["port"] == got["reference"]
    assert sum(1 for r in got["port"] if r[0] == "refused") == 3
    assert not os.path.exists(tmp_path / "escape")


@pytest.mark.parametrize("spec", [
    "local:/mnt/cold", '{"type": "s3", "endpoint": "http://h:1", '
    '"bucket": "b"}', ' {"type": "local", "root": "/r"} ',
    "", "   ", "cold", "s3:/x", "{}", "[1, 2]", '{"root": "/r"}',
    "{not json",
])
def test_parse_remote_spec(spec):
    outs = []
    for pkg in PKGS.values():
        try:
            outs.append(("ok", pkg.remote.parse_remote_spec(spec)))
        except ValueError as e:
            outs.append((type(e).__name__, str(e)))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("conf", [
    {"type": "local", "root": ""}, {"type": "s3", "bucket": "b"},
    {"type": "s3", "endpoint": "http://h:1"}, {"type": "nope"},
    {"type": "aliyun"}, {"type": "hdfs", "x": 1}, {},
])
def test_make_client_refuses_as_the_reference(conf):
    outs = []
    for pkg in PKGS.values():
        with pytest.raises((KeyError, ValueError)) as ei:
            pkg.remote.make_client(dict(conf))
        # compare the messages up to the list of known types
        outs.append((ei.type, str(ei.value).split("; ")[0]))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("kind", ["gcs", "azure"])
def test_make_client_names_the_unported_clients(kind):
    """gcs and azure are ported now: both packages build the same client
    from the same conf and refuse an incomplete one alike."""
    conf = {"gcs": {"type": "gcs", "bucket": "b",
                    "endpoint": "http://127.0.0.1:1", "token": "t"},
            "azure": {"type": "azure", "account": "acct",
                      "key": "a2V5", "container": "c",
                      "endpoint": "http://127.0.0.1:1"}}[kind]
    import seaweedfs_tpu.remote_storage as ref_pkg
    import seaweedfs_tpu_torch.remote_storage as port_pkg

    built = {}
    for name, pkg in (("reference", ref_pkg), ("port", port_pkg)):
        c = pkg.make_client(dict(conf))
        built[name] = (type(c).__name__, {k: v for k, v in vars(c).items()
                                          if isinstance(v, str)})
        with pytest.raises(ValueError) as ei:
            pkg.make_client({"type": kind})
        built[name] += (str(ei.value),)
    assert built["port"] == built["reference"]
    assert built["port"][0] == {"gcs": "GcsRemoteClient",
                                "azure": "AzureRemoteClient"}[kind]


def test_make_client_builds_both_kinds(tmp_path):
    c = port_remote.make_client({"type": "local", "root": str(tmp_path)})
    assert isinstance(c, port_remote.LocalRemoteClient)
    s = port_remote.make_client({"type": "s3", "endpoint": "http://h:1",
                                 "bucket": "b"})
    assert isinstance(s, port_remote.S3RemoteClient)
    assert port_remote.parse_remote_spec(f"local:{tmp_path}") == \
        {"type": "local", "root": str(tmp_path)}


@pytest.mark.parametrize("col,vid,sid", [
    ("", 7, 0), ("cold", 7, 13), ("a_b", 123456, 9), ("x", 1, 31)])
def test_tier_shard_key_equal(col, vid, sid):
    assert port_store.tier_shard_key(col, vid, sid) == \
        ref_store.tier_shard_key(col, vid, sid)


# ----------------------------------------------------------------------
# the .dat tier: Volume.tier_upload / download and the .vif record
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bucket_gateway(tmp_path_factory):
    """A port cluster's S3 gateway with one bucket per package."""
    c = PortCluster(str(tmp_path_factory.mktemp("gw")),
                    n_volume_servers=1, volume_size_limit=64 << 20,
                    with_s3=True)
    try:
        for name in PKGS:
            requests.put(f"{c.s3_url}/dat-{name}",
                         timeout=10).raise_for_status()
        yield c.s3_url
    finally:
        c.stop()


def _tiered_volume(pkg, name, root, s3_url) -> dict:
    pkg.backend.configure_storage("s3.remotetier", endpoint=s3_url,
                                  bucket=f"dat-{name}")
    os.makedirs(root)
    v = pkg.volume.Volume(str(root), "c", VID, create=True)
    needles = _needles(SEED)
    for kw in needles:
        v.append_needle(pkg.Needle(**kw))
    v.delete_needle(needles[3]["id"])
    base = os.path.join(str(root), f"c_{VID}")
    v.sync()
    dat = _file_digest(base + ".dat")
    rf = v.tier_upload(pkg.backend.get_storage("s3.remotetier"))
    out = {"dat": dat, "rf": (rf.backend_name, rf.key, rf.file_size,
                              rf.modified_time),
           "exists": os.path.exists(base + ".dat"),
           "read_only": v.read_only, "remote": v.is_remote}
    with open(base + ".vif", "rb") as f:
        out["vif"] = f.read()
    with pytest.raises(PermissionError):
        v.append_needle(pkg.Needle(id=1, cookie=1, data=b"x"))
    with pytest.raises(PermissionError):
        v.compact()
    out["object"] = _digest(requests.get(
        f"{s3_url}/dat-{name}/{rf.key}", timeout=30).content)
    v.close()
    return out


def _read_volume(pkg, root) -> list:
    v = pkg.volume.Volume(str(root), "c", VID)
    try:
        out = [("remote", v.is_remote, v.read_only)]
        for kw in _needles(SEED):
            try:
                n = v.read_needle(kw["id"], kw["cookie"])
                out.append((kw["id"], _digest(bytes(n.data))))
            except KeyError:
                out.append((kw["id"], "gone"))
        return out
    finally:
        v.close()


def test_dat_tier_same_vif_and_object(tmp_path, pinned_clock,
                                      bucket_gateway):
    got = {name: _tiered_volume(pkg, name, tmp_path / name, bucket_gateway)
           for name, pkg in PKGS.items()}
    assert got["port"] == got["reference"]
    assert got["port"]["exists"] is False and got["port"]["remote"]
    assert got["port"]["object"] == got["port"]["dat"]
    vif = json.loads(got["port"]["vif"])
    assert vif["files"][0]["key"] == f"c_{VID}.dat"
    # each package opens the other's tiered volume through its own
    # registry (the objects are equal) and reads every needle
    reads = {(reader, writer): _read_volume(PKGS[reader], tmp_path / writer)
             for reader in PKGS for writer in PKGS}
    first = reads[("reference", "reference")]
    assert first[0] == ("remote", True, True)
    assert sum(1 for _, d in first[1:] if d == "gone") == 1
    assert all(r == first for r in reads.values())
    # and brings the .dat back, byte-equal, the object deleted
    for name, pkg in PKGS.items():
        v = pkg.volume.Volume(str(tmp_path / name), "c", VID)
        v.tier_download()
        base = os.path.join(str(tmp_path / name), f"c_{VID}")
        assert _file_digest(base + ".dat") == got[name]["dat"]
        assert not os.path.exists(base + ".vif")
        assert not v.read_only and not v.is_remote
        v.close()
        r = requests.head(f"{bucket_gateway}/dat-{name}/c_{VID}.dat",
                          timeout=10)
        assert r.status_code == 404


def test_destroy_deletes_the_remote_object(tmp_path, bucket_gateway):
    port_backend.configure_storage("s3.remotetier", endpoint=bucket_gateway,
                                   bucket="dat-port")
    v = port_volume.Volume(str(tmp_path), "d", VID, create=True)
    v.append_needle(port_ndl.Needle(id=5, cookie=6, data=b"y" * 5000))
    rf = v.tier_upload(port_backend.get_storage("s3.remotetier"))
    url = f"{bucket_gateway}/dat-port/{rf.key}"
    assert requests.head(url, timeout=10).status_code == 200
    v.destroy()
    assert requests.head(url, timeout=10).status_code == 404
    assert sorted(os.listdir(tmp_path)) == []


def test_tier_upload_twice_refused(tmp_path, bucket_gateway):
    port_backend.configure_storage("s3.remotetier", endpoint=bucket_gateway,
                                   bucket="dat-port")
    v = port_volume.Volume(str(tmp_path), "e", VID, create=True)
    v.append_needle(port_ndl.Needle(id=5, cookie=6, data=b"z" * 100))
    storage = port_backend.get_storage("s3.remotetier")
    v.tier_upload(storage)
    with pytest.raises(ValueError, match="already tiered"):
        v.tier_upload(storage)
    v.tier_download()
    with pytest.raises(ValueError, match="not tiered"):
        v.tier_download()
    v.close()


# ----------------------------------------------------------------------
# EC shards to the cold tier: the .rsm manifest, restart, recall
# ----------------------------------------------------------------------
def _ec_store(pkg, root):
    """A Store holding one sealed RS(10,4) volume of seeded needles,
    all 14 shards mounted, the plain volume dropped."""
    store = pkg.store.Store([str(root)], ec_backend=pkg.ec_backend)
    store.add_volume(VID, collection="c")
    needles = _needles(SEED + 1)
    for kw in needles:
        store.write_needle(VID, pkg.Needle(**kw))
    store.mark_readonly(VID)
    store.generate_ec_shards(VID)
    store.mount_ec_shards(VID, "c", range(geo.TOTAL_SHARDS))
    store.delete_volume(VID)
    return store, needles


def _shard_files(root) -> dict[int, str]:
    base = os.path.join(str(root), f"c_{VID}")
    return {sid: _file_digest(base + geo.shard_ext(sid))
            for sid in range(geo.TOTAL_SHARDS)
            if os.path.exists(base + geo.shard_ext(sid))}


def test_offload_same_manifest_and_objects(tmp_path, pinned_clock):
    got = {}
    for name, pkg in PKGS.items():
        root, cold = tmp_path / name, tmp_path / f"cold-{name}"
        store, needles = _ec_store(pkg, root)
        shards = _shard_files(root)
        conf = {"type": "local", "root": str(cold)}
        moved = []
        res = store.tier_offload_ec(VID, conf, throttle=moved.append)
        again = store.tier_offload_ec(VID, conf)
        with open(os.path.join(str(root), f"c_{VID}.rsm"), "rb") as f:
            man = f.read()
        got[name] = {
            "shards": shards, "res": res, "again": again, "moved": moved,
            "objects": _files(cold), "local_left": _shard_files(root),
            "remote": store.ec_remote_shards(VID),
            "hb": [(e["id"], e["remote"], e["shard_bits"])
                   for e in store.collect_heartbeat()["ec_shards"]],
            "reads": _reads(store, needles),
            "manifest": json.loads(man),
        }
        store.close()
    ref, port = got["reference"], got["port"]
    for k in ("shards", "res", "again", "moved", "local_left", "remote",
              "hb", "reads"):
        assert port[k] == ref[k], k
    # the same manifest but for the cold root each was given
    assert port["manifest"].pop("remote") == \
        {"type": "local", "root": str(tmp_path / "cold-port")}
    ref["manifest"].pop("remote")
    assert port["manifest"] == ref["manifest"]
    # 14 objects at the deterministic keys, each its shard's bytes
    want = {f"tier-ec/c/{VID}/{sid:02d}.ec": d
            for sid, d in port["shards"].items()}
    assert port["objects"] == ref["objects"] == want
    assert port["local_left"] == {}
    assert port["remote"] == list(range(geo.TOTAL_SHARDS))
    assert port["again"]["moved_bytes"] == 0


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_store_restart_remounts_the_other_packages_manifest(
        tmp_path, pinned_clock, writer, reader):
    """Offloaded by one package; the other's Store, started on that
    directory, mounts the shards remote-backed from the .rsm, serves
    every needle, and recalls them."""
    root, cold = tmp_path / "data", tmp_path / "cold"
    store, needles = _ec_store(PKGS[writer], root)
    shards = _shard_files(root)
    want = _reads(store, needles)
    store.tier_offload_ec(VID, {"type": "local", "root": str(cold)})
    store.close()
    other = PKGS[reader].store.Store([str(root)],
                                     ec_backend=PKGS[reader].ec_backend)
    try:
        assert other.ec_remote_shards(VID) == list(range(geo.TOTAL_SHARDS))
        assert _reads(other, needles) == want
        res = other.tier_recall_ec(VID)
        assert sorted(res["recalled"]) == list(range(geo.TOTAL_SHARDS))
        assert _shard_files(root) == shards
        assert _files(cold) == {}
        assert not os.path.exists(os.path.join(str(root), f"c_{VID}.rsm"))
        assert other.ec_remote_shards(VID) == []
        assert _reads(other, needles) == want
    finally:
        other.close()


class _Flaky:
    """A local cold tier whose writes (or reads of whole objects) fail
    once `budget` of them have succeeded."""

    budget = {"write": 1 << 30, "read": 1 << 30}

    def __init__(self, base):
        self.base = base

    def write_file(self, key, data):
        if self.budget["write"] <= 0:
            raise OSError("cold tier unreachable")
        self.budget["write"] -= 1
        return self.base.write_file(key, data)

    def read_file(self, key, offset=0, size=-1):
        if offset == 0 and size < 0:
            if self.budget["read"] <= 0:
                raise OSError("cold tier unreachable")
            self.budget["read"] -= 1
        return self.base.read_file(key, offset, size)

    def delete_file(self, key):
        self.base.delete_file(key)


@pytest.mark.parametrize("pkg_name", ["reference", "port"])
def test_offload_and_recall_resume_after_a_crash(tmp_path, pinned_clock,
                                                 pkg_name):
    pkg = PKGS[pkg_name]
    kind = f"flaky-{pkg_name}"
    pkg.remote.register_remote(
        kind, lambda root: _Flaky(pkg.remote.LocalRemoteClient(root=root)))
    root, cold = tmp_path / "data", tmp_path / "cold"
    conf = {"type": kind, "root": str(cold)}
    store, needles = _ec_store(pkg, root)
    shards = _shard_files(root)
    want = _reads(store, needles)
    try:
        _Flaky.budget = {"write": 5, "read": 1 << 30}
        with pytest.raises(OSError, match="unreachable"):
            store.tier_offload_ec(VID, conf)
        man = json.load(open(os.path.join(str(root), f"c_{VID}.rsm")))
        assert len(man["shards"]) == 5
        assert len(_shard_files(root)) == geo.TOTAL_SHARDS - 5
        assert _reads(store, needles) == want     # half cold, half local
        _Flaky.budget = {"write": 1 << 30, "read": 1 << 30}
        res = store.tier_offload_ec(VID, conf)
        assert len(res["offloaded"]) == geo.TOTAL_SHARDS - 5
        objects = _files(cold)
        assert objects == {f"tier-ec/c/{VID}/{sid:02d}.ec": d
                           for sid, d in shards.items()}
        assert _reads(store, needles) == want
        _Flaky.budget = {"write": 1 << 30, "read": 6}
        with pytest.raises(OSError, match="unreachable"):
            store.tier_recall_ec(VID)
        assert len(_shard_files(root)) == 6
        assert _files(cold) == objects            # nothing deleted yet
        _Flaky.budget = {"write": 1 << 30, "read": 1 << 30}
        res = store.tier_recall_ec(VID)
        assert len(res["recalled"]) == geo.TOTAL_SHARDS - 6
        assert _shard_files(root) == shards
        assert _files(cold) == {}
        assert _reads(store, needles) == want
    finally:
        _Flaky.budget = {"write": 1 << 30, "read": 1 << 30}
        store.close()


# ----------------------------------------------------------------------
# the reference's own .dat-tier cases on the port's Cluster
# ----------------------------------------------------------------------
CASES = port_cases(ref_cases, Cluster=PortCluster, backend=port_backend,
                   verbs=verbs, CommandEnv=CommandEnv,
                   run_command=run_command)


@pytest.fixture(scope="module")
def tier_cluster(tmp_path_factory):
    """tests/test_tiering.py's `cluster` fixture, on the port."""
    c = PortCluster(str(tmp_path_factory.mktemp("tier_cluster")),
                    n_volume_servers=2, volume_size_limit=8 << 20,
                    with_s3=True)
    requests.put(f"{c.s3_url}/tier-bucket", timeout=10).raise_for_status()
    port_backend.configure_storage("s3.default", endpoint=c.s3_url,
                                   bucket="tier-bucket")
    yield c
    c.stop()


@pytest.fixture()
def tier_env(tier_cluster):
    e = CommandEnv(tier_cluster.master_url, filer_url=tier_cluster.filer_url)
    e.acquire_lock()
    yield e
    e.close()


@pytest.mark.parametrize("case", [
    "test_tier_upload_read_download",
    "test_tiered_volume_survives_remount",
    "test_tier_replicated_volume_uploads_once",
    "test_rclone_backend_fails_fast",
])
def test_reference_case_on_the_port(case, tier_cluster, tier_env,
                                    tmp_path):
    call_case(CASES[case], {"cluster": tier_cluster, "env": tier_env,
                            "tmp_path": tmp_path})
