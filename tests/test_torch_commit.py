"""The port's group commit (seaweedfs_tpu_torch/storage/commit.py,
`Volume.commit_batch`, the volume server's durability modes) against
the JAX package's, with tolerance 0.

* The scheduler's contracts against a counting fsync shim: the
  reference's tests/test_durability_contract.py TestSchedulerContract
  runs on the port's CommitScheduler (a batch ack never releases before
  its covering fsync, buffered never fsyncs, many acks share one fsync,
  the mode is validated).
* The same PUTs to a reference and a port volume server under each of
  `buffered`, `batch` and `sync`: the statuses, the X-Sw-Durability
  header, the `?fsync=true` upgrade, the keys and the mode of
  /debug/commit, and byte-equal read-back from a cold reopen of the
  volume after the cluster stopped (each package's Volume reads the
  other's files too).
* Under the native front (native/dataplane.cc's own commit queue): the
  reference's TestNativeFront cases (batch header and coalescing with a
  cold restart, sync as a per-write fsync oracle, buffered pays no
  fsync, the mode validated) on each package's plane, `[reference|
  port]`; and the same PUTs through a reference and a port volume
  server behind its front (`Cluster(filer_native=True)` puts server 0
  there, a filer's front beside it) under each mode: equal statuses
  and X-Sw-Durability, the port's native commit counters moving as the
  mode says, byte-equal read-back.
* SIGKILL mid group commit: the reference's
  tests/test_chaos_group_commit.py scenario through the port — a child
  process appends on 4 threads through the port's Volume and
  CommitScheduler in batch mode and prints an id only after its
  covering fsync; it is killed at a seeded point; a cold reopen must
  read every acked id bit for bit, end the .dat on the 8-byte grid and
  hold no torn record. 3 seeds here; the reference's 20 are marked
  `slow`, as the reference marks its own.
"""
import hashlib
import os
import random
import signal
import struct
import subprocess
import sys
import time

import pytest
import requests

from seaweedfs_tpu.native import dataplane as ref_dpmod
from seaweedfs_tpu.operation import verbs as ref_verbs
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.native import dataplane as dpmod
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.commit import (DURABILITY_MODES,
                                                CommitScheduler)
from seaweedfs_tpu_torch.storage.volume import Volume

from tests import test_chaos_group_commit as ref_chaos
from tests import test_durability_contract as ref_contract
from tests.torch_port_cases import port_cases, run_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {k: v for k, v in port_cases(
    ref_contract, CommitScheduler=CommitScheduler,
    DURABILITY_MODES=DURABILITY_MODES).items()
    if k.startswith("TestSchedulerContract.")}


@pytest.mark.parametrize("case", list(CASES))
def test_scheduler_contract_on_the_port(case):
    run_case(CASES[case], {})


NATIVE_CASES = {
    side: {k: v for k, v in port_cases(ref_contract, **subs).items()
           if k.startswith("TestNativeFront.")}
    for side, subs in (("reference", {}),
                       ("port", {"dpmod": dpmod, "Volume": Volume}))}
PLANES = {"reference": ref_dpmod, "port": dpmod}


@pytest.mark.parametrize("side", list(NATIVE_CASES))
@pytest.mark.parametrize("case", list(NATIVE_CASES["port"]))
def test_native_front_contract(case, side, tmp_path):
    d = PLANES[side].DataPlane()
    d.start(0, 1)
    try:
        run_case(NATIVE_CASES[side][case], {"tmp_path": tmp_path, "dp": d})
    finally:
        # the commit mode is plane-global: later cases see buffered
        d.set_commit("buffered", 0.002, 4 << 20)
        d.stop()


@pytest.mark.parametrize("mode", DURABILITY_MODES)
def test_durability_modes_match_under_the_native_front(tmp_path, mode):
    out, native = {}, None
    for name, cls, vmod in (("reference", RefCluster, ref_verbs),
                            ("port", Cluster, verbs)):
        c = cls(str(tmp_path / name), n_volume_servers=1,
                commit_durability=mode, commit_max_delay=0.002,
                with_filer=True, filer_native=True)
        try:
            if name == "port":
                dp = c.volume_servers[0].dp
                before = dp.commit_stats()
            out[name] = _drive(c, vmod, mode)
            if name == "port":
                after = dp.commit_stats()
                native = {k: after[k] - before[k]
                          for k in ("writes", "fsyncs", "batches")}
                served = dp.http_stats()
        finally:
            c.stop()
    (ref_seen, _, _), (seen, acked, snap) = out["reference"], out["port"]
    assert seen == ref_seen
    assert [h for _, s, h, *_ in seen if s == 201] == \
        [mode] * 3 + ["sync"] + [mode] * 2
    # the port's writes were the front's own, through its commit queue
    assert served["fast_post"] >= 5 and "native" in snap
    # buffered acks after the pwrite: its queue never sees the write
    assert (native["writes"] >= 5) == (mode != "buffered")
    assert (native["fsyncs"] > 0) == (mode != "buffered")
    vdir = str(tmp_path / "port" / "vol0_0")
    vids = {_parse_fid(f)[0] for f, _ in acked}
    for vcls in (Volume, RefVolume):
        vols = {vid: vcls(vdir, "", vid) for vid in vids}
        try:
            for fid, payload in acked:
                vid, key, cookie = _parse_fid(fid)
                assert vols[vid].read_needle(key, cookie).data == payload
        finally:
            for v in vols.values():
                v.close()


def _payload(seed: bytes, n: int) -> bytes:
    """Bytes gzip cannot shrink (a sha256 chain): the stored needle is
    the payload on every path."""
    out, block = bytearray(), seed
    while len(out) < n:
        block = hashlib.sha256(block).digest()
        out += block
    return bytes(out[:n])


def _parse_fid(fid: str) -> tuple[int, int, int]:
    vid_s, rest = fid.split(",")
    rest = rest.split("_")[0]
    return int(vid_s), int(rest[:-8] or "0", 16), int(rest[-8:], 16)


def _drive(c, vmod, mode: str) -> tuple[list, list, dict]:
    """The same writes to a one-server cluster of either package: ->
    (what the client saw, the acked (fid, payload) pairs,
    /debug/commit's snapshot)."""
    seen, acked = [], []
    for i in range(6):
        payload = _payload(b"%s-%d" % (mode.encode(), i), 1024 + 97 * i)
        a = vmod.assign(c.master_url)
        q = "?fsync=true" if i == 3 else ""
        r = requests.post(f"http://{a.url}/{a.fid}{q}", data=payload,
                          headers={"Content-Type":
                                   "application/octet-stream"},
                          timeout=30)
        seen.append((i, r.status_code, r.headers.get("X-Sw-Durability"),
                     r.json()["size"]))
        got = requests.get(f"http://{a.url}/{a.fid}", timeout=30)
        seen.append((i, got.status_code, got.content == payload))
        acked.append((a.fid, payload))
    snap = requests.get(f"{c.volume_url(0)}/debug/commit",
                        timeout=30).json()
    return seen, acked, snap


@pytest.mark.parametrize("mode", DURABILITY_MODES)
def test_durability_modes_match(tmp_path, mode):
    out = {}
    for name, cls, vmod in (("reference", RefCluster, ref_verbs),
                            ("port", Cluster, verbs)):
        c = cls(str(tmp_path / name), n_volume_servers=1,
                commit_durability=mode, commit_max_delay=0.002)
        try:
            out[name] = _drive(c, vmod, mode)
        finally:
            c.stop()
    (ref_seen, ref_acked, ref_snap), (seen, acked, snap) = \
        out["reference"], out["port"]
    assert seen == ref_seen
    assert [h for _, s, h, *_ in seen if s == 201] == \
        [mode] * 3 + ["sync"] + [mode] * 2
    assert set(snap) == set(ref_snap)
    for k in ("durability", "max_delay_seconds", "max_bytes"):
        assert snap[k] == ref_snap[k], k
    # the ?fsync=true write never enqueues; batch pays fsyncs, buffered
    # and sync none through the scheduler (a buffered ack does not wait
    # for its batch to close: count what is still queued too)
    assert [s["commits"] + s["queue_depth"] for s in (snap, ref_snap)] \
        == [5 if mode != "sync" else 0] * 2
    assert (snap["fsyncs"] > 0) == (ref_snap["fsyncs"] > 0) == \
        (mode == "batch")
    # a cold reopen of each package's volume, by both packages' Volume
    for name, pairs in (("reference", ref_acked), ("port", acked)):
        vdir = str(tmp_path / name / "vol0_0")
        vids = {_parse_fid(f)[0] for f, _ in pairs}
        for vcls in (Volume, RefVolume):
            vols = {vid: vcls(vdir, "", vid) for vid in vids}
            try:
                for fid, payload in pairs:
                    vid, key, cookie = _parse_fid(fid)
                    assert vols[vid].read_needle(key, cookie).data == \
                        payload, (name, vcls.__module__, fid)
            finally:
                for v in vols.values():
                    v.close()


def test_batch_fan_out_acks_after_both_fsyncs(tmp_path):
    """A replicated batch-mode write: the primary's and the replica's
    schedulers each commit it before the 201, and both copies read
    back; a later ?fsync=true write reaches the replica as sync."""
    c = Cluster(str(tmp_path), n_volume_servers=2,
                commit_durability="batch")
    try:
        a = verbs.assign(c.master_url, replication="001")
        payload = _payload(b"fan-out", 4000)
        r = requests.post(f"http://{a.url}/{a.fid}", data=payload,
                          timeout=30)
        assert r.status_code == 201
        assert r.headers["X-Sw-Durability"] == "batch"
        snaps = [requests.get(f"{c.volume_url(i)}/debug/commit",
                              timeout=30).json() for i in range(2)]
        assert [s["commits"] for s in snaps] == [1, 1]
        assert all(s["fsyncs"] >= 1 for s in snaps)
        for vs in c.volume_servers:
            assert vs.store.read_needle(
                int(a.fid.split(",")[0]),
                *_parse_fid(a.fid)[1:]).data == payload
        b = verbs.assign(c.master_url, replication="001")
        r = requests.post(f"http://{b.url}/{b.fid}?fsync=true",
                          data=payload, timeout=30)
        assert r.headers["X-Sw-Durability"] == "sync"
        # fsynced inline on both copies: neither enqueued it
        assert [requests.get(f"{c.volume_url(i)}/debug/commit",
                             timeout=30).json()["commits"]
                for i in range(2)] == [1, 1]
    finally:
        c.stop()


# -- SIGKILL mid group commit -----------------------------------------

CHILD = ref_chaos.CHILD.replace("seaweedfs_tpu.", "seaweedfs_tpu_torch.")


def _sigkill_case(tmp_path, seed: int) -> None:
    rng = random.Random(ref_chaos.BASE_SEED + seed)
    vdir = tmp_path / "vol"
    vdir.mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(seed), str(vdir), REPO],
        stdout=subprocess.PIPE, env={**os.environ,
                                     "JAX_PLATFORMS": "cpu"})
    try:
        assert proc.stdout.readline() == b"R\n"  # the volume exists
        time.sleep(rng.uniform(0.05, 0.4))  # the seeded kill point
    finally:
        os.kill(proc.pid, signal.SIGKILL)
    out, _ = proc.communicate(timeout=10)
    acked = {int(line.split()[1]) for line in out.splitlines()
             if line.startswith(b"A ")}
    assert acked, "no write was acked before the kill"
    v = Volume(str(vdir), "", 1)
    try:
        for j in sorted(acked):
            n = v.read_needle(j, ref_chaos.COOKIE)
            assert n.data == ref_chaos._payload(seed, j), \
                f"acked id {j} corrupt"
        size = os.path.getsize(vdir / "1.dat")
        assert size % 8 == 0
        survivors = 0
        for key, off, sz in list(v.nm.live_items()):
            assert v.read_needle(key, ref_chaos.COOKIE).data == \
                ref_chaos._payload(seed, key), f"surviving id {key} torn"
            survivors += 1
        assert survivors >= len(acked)
        offset = v.super_block.block_size
        with open(vdir / "1.dat", "rb") as f:
            while offset + t.NEEDLE_HEADER_SIZE <= size:
                f.seek(offset)
                head = f.read(t.NEEDLE_HEADER_SIZE)
                _, _nid, size_u32 = struct.unpack(">IQI", head)
                nsize = max(t.u32_to_size(size_u32), 0)
                disk = ndl.disk_size(nsize, v.version)
                assert offset + disk <= size, "torn record survived"
                f.seek(offset)
                ndl.Needle.from_bytes(f.read(disk), v.version)
                offset += disk
        assert offset == size
    finally:
        v.close()


def test_child_runs_the_port():
    assert "seaweedfs_tpu_torch.storage.commit" in CHILD
    assert "from seaweedfs_tpu." not in CHILD


@pytest.mark.parametrize("seed", range(3))
def test_sigkill_mid_group_commit_loses_no_acked_write(tmp_path, seed):
    _sigkill_case(tmp_path, seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(20))
def test_sigkill_mid_group_commit_reference_seeds(tmp_path, seed):
    _sigkill_case(tmp_path, seed)
