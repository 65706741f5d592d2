"""The port's mount core (seaweedfs_tpu_torch/mount/) against the JAX
package's, at the library level.

* The cases of the reference's tests/test_mount.py (the dirty-page
  pipeline and its swap-file spill, the inode registry, the chunk
  cache, WeedFS's POSIX operations over a live filer) and
  tests/test_mount_quota.py (the mount.conf quota, filer.backup's
  replicator, the filer.meta.tail process) run twice, `[reference]`
  and `[port]`: each package's WeedFS over its own in-process cluster
  (the port's with `ec_backend="native"`), through
  tests/torch_port_cases.py.
* Across the packages, byte for byte: each package's WeedFS writes the
  same seeded tree (sequential, sparse and random writes, a dirty-page
  spill past a 1 MiB memory limit, a rename while a handle is open, a
  chmod, an xattr, a symlink) into each package's filer. The entries
  the two mounts leave on one filer are equal (chunks' offsets and
  sizes, attributes, `extended`) and equal across the filers, and each
  mount reads the other's files equal to the model.
* `FilerClient.stop_subscription` returns within 1 s from an open,
  idle metadata stream of either filer.
* Where the port parts from the reference (a fault of the reference's,
  found driving a fresh mount over a filer with history): its
  subscription streams the events from its start, where the
  reference's replays the filer's buffered history; and an event only
  invalidates the meta cache, where the reference's installs the
  event's entry over a newer one the mount put itself, so a file just
  written reads 0 bytes until the next event.
"""
import functools
import hashlib
import time

import numpy as np
import pytest
import requests

from seaweedfs_tpu.mount.filer_client import FilerClient as RefFilerClient
from seaweedfs_tpu.mount.weedfs import WeedFS as RefWeedFS
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.filer import filechunks
from seaweedfs_tpu_torch.mount import weedfs
from seaweedfs_tpu_torch.mount.chunk_cache import (MemoryChunkCache,
                                                   TieredChunkCache)
from seaweedfs_tpu_torch.mount.filer_client import FilerClient
from seaweedfs_tpu_torch.mount.inode_registry import InodeRegistry
from seaweedfs_tpu_torch.mount.page_writer import DirtyPages
from seaweedfs_tpu_torch.replication import replicator, sink
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_mount as ref_mount
from tests import test_mount_quota as ref_quota
from tests import torch_port_procs
from tests.torch_port_cases import port_cases, run_case, swap_modules, within

SEED = 20261017
SIDES = ("reference", "port")
PortCluster = functools.partial(Cluster, ec_backend="native")
CLUSTER = {"reference": RefCluster, "port": PortCluster}
WEEDFS = {"reference": RefWeedFS, "port": weedfs.WeedFS}

CASES = {
    "reference": {**port_cases(ref_mount), **port_cases(ref_quota)},
    "port": {**port_cases(ref_mount, MemoryChunkCache=MemoryChunkCache,
                          TieredChunkCache=TieredChunkCache,
                          InodeRegistry=InodeRegistry,
                          DirtyPages=DirtyPages),
             **port_cases(ref_quota, Cluster=PortCluster)},
}
# what a port case imports inside its body
PORT_MODULES = {"seaweedfs_tpu.mount.weedfs": weedfs,
                "seaweedfs_tpu.filer.filechunks": filechunks,
                "seaweedfs_tpu.replication.replicator": replicator,
                "seaweedfs_tpu.replication.sink": sink}
TAIL = "TestMetaTailCli.test_tail_prints_events"


def test_every_reference_case_is_here():
    assert len(CASES["port"]) == 36
    assert list(CASES["port"]) == list(CASES["reference"])


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Each package's cluster with a filer, and each package's WeedFS
    over it as the reference's `mount_fs` fixture makes it."""
    out = {}
    mounts = []
    try:
        for side in SIDES:
            base = tmp_path_factory.mktemp(f"mount_{side}")
            c = within(60, CLUSTER[side], str(base), n_volume_servers=1,
                       with_filer=True)
            out[side] = {"cluster": c}
            c.wait_for_nodes(1)
            fs = WEEDFS[side](c.filer_url, master_url=c.master_url,
                              root="/mnt-root", chunk_size=256,
                              cache_dir=str(base / "cache"),
                              upload_workers=4, subscribe=True, meta_ttl=30)
            mounts.append(fs)
            out[side]["mount_fs"] = fs
        yield out
    finally:
        for fs in mounts:
            within(30, fs.destroy)
        for side in out.values():
            within(30, side["cluster"].stop)


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("case", list(CASES["port"]))
def test_reference_case(case, side, clusters, tmp_path):
    swaps = dict(PORT_MODULES) if side == "port" else {}
    if case == TAIL and side == "port":
        swaps["subprocess"] = torch_port_procs   # imported in the case
    with swap_modules(swaps, parents=True):
        run_case(CASES[side][case], {**clusters[side], "tmp_path": tmp_path})


# ----------------------------------------------------------------------
# one seeded tree through each package's mount into each package's filer
# ----------------------------------------------------------------------
CHUNK = 64 << 10
MEMORY_LIMIT = 1 << 20
RANDOM_FILE = 3 << 20


def _write_tree(fs) -> tuple[dict[str, bytes], int]:
    """The seeded tree through one WeedFS. -> (path -> bytes the files
    must hold, the random-write handle's swap bytes before its
    flush)."""
    rng = np.random.default_rng([SEED, 22])
    model: dict[str, bytes] = {}
    fs.mkdir("/d0")
    fs.mkdir("/d1")
    fs.mkdir("/d1/sub")
    for i in range(6):      # sequential writes in seeded pieces
        path = f"/d{i % 2}/small-{i}.bin"
        data = rng.bytes(int(rng.integers(1, 40 << 10)))
        fh = fs.create(path)
        pos = 0
        while pos < len(data):
            n = int(rng.integers(1, 9000))
            fs.write(fh, pos, data[pos:pos + n])
            pos += n
        fs.release(fh)
        model[path] = data
    # sparse: blocks with holes between them
    sparse = bytearray(300_000 + 777)
    fh = fs.create("/d1/sub/sparse.bin")
    for off in (0, 100_000, 300_000):
        blk = rng.bytes(777)
        fs.write(fh, off, blk)
        sparse[off:off + 777] = blk
    fs.release(fh)
    model["/d1/sub/sparse.bin"] = bytes(sparse)
    # random writes over a preallocated file: the sealed payloads pass
    # the 1 MiB dirty limit and spill to the swap file
    rand = bytearray(RANDOM_FILE)
    fh = fs.create("/d0/random.bin")
    fs.write(fh, 0, bytes(RANDOM_FILE))
    for _ in range(48):
        off = int(rng.integers(0, RANDOM_FILE - (16 << 10)))
        blk = rng.bytes(16 << 10)
        fs.write(fh, off, blk)
        rand[off:off + len(blk)] = blk
    spilled = fs._handle(fh).dirty.swap_bytes
    fs.release(fh)
    model["/d0/random.bin"] = bytes(rand)
    # a rename while a handle is open: the handle's later writes and
    # its flush land under the new name
    first, second = rng.bytes(100_000), rng.bytes(50_000)
    fh = fs.create("/d0/moving.bin")
    fs.write(fh, 0, first)
    fs.rename("/d0/moving.bin", "/d1/moved.bin")
    fs.write(fh, len(first), second)
    fs.release(fh)
    model["/d1/moved.bin"] = first + second
    fs.chmod("/d0/small-0.bin", 0o600)
    fs.setxattr("/d1/small-1.bin", "user.tag", b"seeded \x00\xff")
    fs.symlink("/d0/small-0.bin", "/d1/link")
    return model, spilled


def _listing(filer: str, path: str) -> list[dict]:
    r = requests.get(f"{filer}{path}", params={"limit": "1000"},
                     headers={"Accept": "application/json"}, timeout=30)
    r.raise_for_status()
    return r.json()["entries"]


def _entries(filer: str, root: str) -> dict[str, dict]:
    """Every entry under root, by path relative to it: the chunks'
    offsets and sizes and the attributes; fids and clocks masked."""
    out = {}
    todo = [root]
    while todo:
        d = todo.pop()
        for e in _listing(filer, d):
            rel = e["full_path"][len(root):]
            out[rel] = {
                "mode": e["mode"], "uid": e.get("uid", 0),
                "gid": e.get("gid", 0), "mime": e.get("mime", ""),
                "symlink_target": e.get("symlink_target", ""),
                "extended": e.get("extended", {}),
                "content": e.get("content", ""),
                "chunks": [(c["offset"], c["size"],
                            c.get("cipher_key", ""),
                            c.get("is_chunk_manifest", False))
                           for c in e.get("chunks") or []]}
            if e["mode"] & 0o40000:
                todo.append(e["full_path"])
    return out


def _read_all(fs, model: dict[str, bytes]) -> dict[str, str]:
    out = {}
    for path, data in model.items():
        fh = fs.open(path)
        got = fs.read(fh, 0, len(data) + 4096)
        fs.release(fh)
        out[path] = hashlib.sha256(got).hexdigest()
    return out


@pytest.fixture(scope="module")
def trees(clusters, tmp_path_factory):
    """Each package's WeedFS writes the tree into each package's filer,
    under /x-<mount>; -> {(filer, mount): (model, spilled)}."""
    out = {}
    for filer_side in SIDES:
        c = clusters[filer_side]["cluster"]
        for mount_side in SIDES:
            fs = WEEDFS[mount_side](
                c.filer_url, master_url=c.master_url,
                root=f"/x-{mount_side}", chunk_size=CHUNK,
                cache_dir=str(tmp_path_factory.mktemp("xcache")),
                upload_workers=4, subscribe=True,
                write_memory_limit=MEMORY_LIMIT)
            try:
                out[filer_side, mount_side] = _write_tree(fs)
            finally:
                within(30, fs.destroy)
    return out


@pytest.mark.parametrize("filer_side", SIDES)
def test_both_mounts_leave_the_same_entries(filer_side, clusters, trees):
    filer = clusters[filer_side]["cluster"].filer_url
    ref = _entries(filer, "/x-reference")
    port = _entries(filer, "/x-port")
    assert len(ref) == 13
    assert port == ref
    assert ref["/d0/small-0.bin"]["mode"] & 0o7777 == 0o600
    assert ref["/d1/link"]["symlink_target"] == "/d0/small-0.bin"
    assert "xattr-user.tag" in ref["/d1/small-1.bin"]["extended"]
    assert "/d0/moving.bin" not in ref
    # more than one chunk where the file spans slots, and each handle
    # spilled past its 1 MiB dirty limit
    assert len(ref["/d0/random.bin"]["chunks"]) > RANDOM_FILE // CHUNK
    for mount_side in SIDES:
        model, spilled = trees[filer_side, mount_side]
        assert spilled > 0, mount_side
        assert model == trees[filer_side, "reference"][0]


def test_the_entries_are_equal_across_the_filers(clusters, trees):
    got = {(f, m): _entries(clusters[f]["cluster"].filer_url, f"/x-{m}")
           for f in SIDES for m in SIDES}
    assert got["port", "port"] == got["reference", "reference"]
    assert got["reference", "port"] == got["port", "reference"]


@pytest.mark.parametrize("filer_side", SIDES)
def test_each_mount_reads_the_others_files(filer_side, clusters, trees):
    c = clusters[filer_side]["cluster"]
    for reader, writer in (("port", "reference"), ("reference", "port")):
        model, _ = trees[filer_side, writer]
        want = {p: hashlib.sha256(d).hexdigest() for p, d in model.items()}
        fs = WEEDFS[reader](c.filer_url, master_url=c.master_url,
                            root=f"/x-{writer}", chunk_size=CHUNK,
                            subscribe=False)
        try:
            assert _read_all(fs, model) == want, (reader, writer)
            assert fs.readlink("/d1/link") == "/d0/small-0.bin"
            assert fs.getxattr("/d1/small-1.bin", "user.tag") == \
                b"seeded \x00\xff"
            assert fs.getattr("/d1/sub/sparse.bin")["st_size"] == 300_777
        finally:
            within(30, fs.destroy)


@pytest.mark.parametrize("filer_side", SIDES)
def test_stop_subscription_returns_within_a_second(filer_side, clusters):
    filer = clusters[filer_side]["cluster"].filer_url
    client = FilerClient(filer)
    got = []
    client.subscribe_meta("/subwait", got.append)
    try:
        # an event through the stream: it is open, then idle
        end = time.monotonic() + 15
        while not any((e.get("new_entry") or {}).get("full_path") ==
                      "/subwait/x.txt" for e in list(got)):
            assert time.monotonic() < end, "the stream carried no event"
            requests.post(f"{filer}/subwait/x.txt", data=b"x", timeout=10)
            time.sleep(0.2)
        time.sleep(0.5)
    finally:
        t0 = time.monotonic()
        client.stop_subscription()
        took = time.monotonic() - t0
    assert took < 1.0, took


@pytest.mark.parametrize("side", SIDES)
def test_a_subscription_streams_from_its_start(side, clusters):
    """[reference] replays the filer's buffered history to a new
    subscriber; [port] streams from its start, as SeaweedFS's mount
    subscribes."""
    filer = clusters[side]["cluster"].filer_url
    requests.post(f"{filer}/history/before.txt", data=b"old", timeout=10)
    client = {"reference": RefFilerClient, "port": FilerClient}[side](filer)
    seen = []
    client.subscribe_meta("/history", seen.append)
    try:
        end = time.monotonic() + 15
        while not any((e.get("new_entry") or {}).get("full_path") ==
                      "/history/after.txt" for e in list(seen)):
            assert time.monotonic() < end, "the stream carried no event"
            requests.post(f"{filer}/history/after.txt", data=b"new",
                          timeout=10)
            time.sleep(0.2)
    finally:
        within(10, client.stop_subscription)
    replayed = any((e.get("new_entry") or {}).get("full_path") ==
                   "/history/before.txt" for e in seen)
    assert replayed == (side == "reference")


@pytest.mark.parametrize("side", SIDES)
def test_an_event_does_not_install_a_stale_entry(side, clusters):
    """The create event of a file the mount has since flushed, applied
    late: [reference] installs its empty entry and the file reads 0
    bytes; [port] invalidates, reads the filer, and gets the file."""
    c = clusters[side]["cluster"]
    fs = WEEDFS[side](c.filer_url, master_url=c.master_url,
                      root="/stale", subscribe=False)
    try:
        data = np.random.default_rng([SEED, 22, 5]).bytes(3000)
        fh = fs.create("/f.bin")
        created = fs.client.lookup_entry("/stale/f.bin").to_dict()
        fs.write(fh, 0, data)
        fs.release(fh)
        fs._on_meta_event({"directory": "/stale", "old_entry": None,
                           "new_entry": created})
        want = 0 if side == "reference" else len(data)
        assert fs.getattr("/f.bin")["st_size"] == want
        fh = fs.open("/f.bin")
        assert fs.read(fh, 0, 4096) == data[:want]
        fs.release(fh)
    finally:
        within(30, fs.destroy)

