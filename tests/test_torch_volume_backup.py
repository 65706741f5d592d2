"""Incremental backup and tails on the port against the JAX package's,
with tolerance 0.

* Every case of the reference's tests/test_volume_backup.py runs twice,
  `[reference]` and `[port]` (tests/torch_port_cases.py rebinds
  `Volume`, the needle codec, `verbs`, `backup_volume`, `parse_file_id`
  and `Cluster`): append stamps recovered on reopen, offsets by stamp,
  raw segments applied and rolled back, the backup tool's full and
  incremental runs and its compaction check, a tail received from a
  peer.
* Each package's `backup_volume` pulls from the other package's volume
  server: a full copy of seeded needles, then an increment of more
  needles, an overwrite and a delete. The copy's .dat and .idx are
  byte-equal to the source's, and the increment pulled exactly the
  bytes appended. /admin/volume_sync_status and
  /admin/volume_incremental_copy answer both packages' servers with
  equal bodies for the same volume bytes.
* Each package's /admin/volume_tail_receive follows the other's
  /admin/volume_tail into an empty volume: byte-equal .dat.
"""
import functools
import hashlib
import os

import numpy as np
import pytest
import requests

from seaweedfs_tpu.operation import backup as ref_backup
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.storage import needle as ref_ndl
from seaweedfs_tpu_torch.operation import backup, verbs
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage.types import parse_file_id
from seaweedfs_tpu_torch.storage.volume import Volume

from tests import test_volume_backup as ref_cases
from tests.torch_port_cases import port_cases, run_case

SEED = 20261017
PortCluster = functools.partial(Cluster, ec_backend="native")
SIDES = {
    "reference": (port_cases(ref_cases), RefCluster),
    "port": (port_cases(ref_cases, Cluster=PortCluster, verbs=verbs,
                        backup_volume=backup.backup_volume, ndl=ndl,
                        parse_file_id=parse_file_id, Volume=Volume),
             PortCluster),
}
CASES = list(SIDES["port"][0])
BACKUP = {"reference": ref_backup.backup_volume,
          "port": backup.backup_volume}


def test_every_reference_case_is_mirrored():
    assert CASES == list(port_cases(ref_cases))
    assert len(CASES) == 8


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Two volume servers of each package, the reference fixture's
    shape."""
    out = {}
    try:
        for side, (_, cls) in SIDES.items():
            out[side] = cls(str(tmp_path_factory.mktemp(side)),
                            n_volume_servers=2, volume_size_limit=64 << 20)
        yield out
    finally:
        for c in out.values():
            c.stop()


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, side, clusters, tmp_path):
    run_case(SIDES[side][0][case], {"cluster": clusters[side],
                                    "tmp_path": tmp_path})


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _source(cluster, vid: int):
    """(store, volume) of the server that holds vid, synced."""
    for store in cluster.stores:
        v = store.find_volume(vid)
        if v is not None:
            v.sync()
            return store, v
    raise AssertionError(f"volume {vid} not held")


def _write(cluster, rng, collection: str, n: int, fids: list) -> int:
    """n seeded needles of uneven size into `collection`; -> bytes."""
    total = 0
    for _ in range(n):
        a = verbs.assign(cluster.master_url, collection=collection)
        body = rng.bytes(int(rng.integers(1, 40_000)))
        verbs.upload(a, body, name=f"n{len(fids)}.bin")
        fids.append((a, body))
        total += len(body)
    return total


@pytest.mark.parametrize("client,server", [("reference", "port"),
                                           ("port", "reference")])
def test_backup_across_packages(client, server, clusters, tmp_path):
    cluster = clusters[server]
    rng = np.random.default_rng([SEED, 1 if client == "port" else 2])
    col = f"x{client[0]}"
    fids: list = []
    _write(cluster, rng, col, 24, fids)
    vid = int(fids[0][0].fid.split(",")[0])
    fids = [(a, b) for a, b in fids if a.fid.startswith(f"{vid},")]
    dest = str(tmp_path / "copy")
    out = BACKUP[client](cluster.master_url, vid, dest, collection=col)
    assert out["mode"] == "full (new)"
    _, v = _source(cluster, vid)
    full_size = v.dat.size()
    # the increment: more needles, an overwrite, a delete
    more: list = []
    while len(more) < 12:
        _write(cluster, rng, col, 1, more)
        more = [(a, b) for a, b in more if a.fid.startswith(f"{vid},")]
    a0, _ = fids[0]
    verbs.upload(a0, b"overwritten " * 99)
    verbs.delete(f"http://{fids[1][0].url}/{fids[1][0].fid}")
    out = BACKUP[client](cluster.master_url, vid, dest, collection=col)
    assert out["mode"] == "incremental"
    store, v = _source(cluster, vid)
    base = os.path.join(dest, f"{col}_{vid}")
    assert out["tail_offset"] == v.dat.size() > full_size
    assert _sha(base + ".dat") == _sha(v.file_name() + ".dat")
    assert _sha(base + ".idx") == _sha(v.file_name() + ".idx")
    # nothing new: an increment of 0 records
    out = BACKUP[client](cluster.master_url, vid, dest, collection=col)
    assert (out["mode"], out["records_applied"]) == ("incremental", 0)


def test_sync_routes_equal(clusters):
    """The same seeded needles, with pinned stamps, into one volume of
    each package: equal sync status and incremental bodies."""
    rng = np.random.default_rng([SEED, 3])
    rows = [(i + 1, int(rng.integers(1 << 32)),
             rng.bytes(int(rng.integers(1, 5000))),
             1_700_000_000_000_000_000 + 1000 * i) for i in range(20)]
    urls = {}
    for side, c in clusters.items():
        mod = ndl if side == "port" else ref_ndl
        vid = 300 + (side == "port")
        r = requests.post(f"{c.volume_url(0)}/admin/assign_volume",
                          json={"volume": vid, "collection": "sync"},
                          timeout=10)
        assert r.status_code < 300, r.text
        v = c.stores[0].find_volume(vid)
        for key, cookie, data, ns in rows:
            v.append_needle(mod.Needle(id=key, cookie=cookie, data=data,
                                       append_at_ns=ns))
        urls[side] = (c.volume_url(0), vid)
    stamp = rows[7][3]
    got = {}
    for side, (url, vid) in urls.items():
        st = requests.get(f"{url}/admin/volume_sync_status",
                          params={"volume": vid}, timeout=10).json()
        inc = requests.get(f"{url}/admin/volume_incremental_copy",
                           params={"volume": vid, "since_ns": stamp},
                           timeout=10)
        got[side] = ({k: st[k] for k in ("tail_offset", "compact_revision",
                                          "last_append_at_ns")},
                     inc.status_code, inc.content)
    assert got["port"] == got["reference"]
    assert got["port"][2] and got["port"][0]["last_append_at_ns"] == \
        rows[-1][3]


@pytest.mark.parametrize("receiver,sender", [("port", "reference"),
                                             ("reference", "port")])
def test_tail_receive_across_packages(receiver, sender, clusters):
    src, dst = clusters[sender], clusters[receiver]
    rng = np.random.default_rng([SEED, 4])
    vid = 310 + (receiver == "port")   # past what either cluster grows
    for c in (src, dst):
        r = requests.post(f"{c.volume_url(0)}/admin/assign_volume",
                          json={"volume": vid, "collection": "tail"},
                          timeout=10)
        assert r.status_code < 300, r.text
    for i in range(10):
        fid = f"{vid},{i + 1:x}{int(rng.integers(1 << 32)):08x}"
        r = requests.post(f"{src.volume_url(0)}/{fid}",
                          data=rng.bytes(int(rng.integers(1, 40_000))),
                          timeout=10)
        assert r.status_code == 201, r.text
    src_url = src.volume_url(0).split("//", 1)[1]
    r = requests.post(f"{dst.volume_url(0)}/admin/volume_tail_receive",
                      json={"volume": vid, "source": src_url,
                            "since_ns": 0, "idle_timeout": 0.5},
                      timeout=60)
    assert r.status_code == 200, r.text
    assert r.json()["applied"] == 10
    sv = src.stores[0].find_volume(vid)
    dv = dst.stores[0].find_volume(vid)
    dv.sync()
    sv.sync()
    assert _sha(dv.file_name() + ".dat") == _sha(sv.file_name() + ".dat")
