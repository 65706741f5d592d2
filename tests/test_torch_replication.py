"""The port's replication/ (sinks, Replicator, FilerSync,
FilerMetaBackup) and the notifier against the JAX package's.

* Every case of tests/test_replication.py runs twice, `[reference]` on
  the JAX package's cluster and `[port]` on the port's
  (tests/torch_port_cases.py rebinds the case's names; an import inside
  a case gets the port's module): the local and S3 sinks, resume from
  the offset, active-active sync with no loop, the meta backup, the
  memory and log queues, and the queue factory's errors.
* Across packages (tolerance 0: paths, bytes, counts):
  - the port's FilerSync between a reference filer and a port filer
    mirrors both ways with exactly one create per path on each side;
  - each package's Replicator resumes from the offset the other's
    saved in the filer KV, and applies no event twice;
  - each package's store reads the sqlite file the other's
    FilerMetaBackup wrote, and its FilerMetaBackup resumes from it;
  - B2Sink's `Authorization: Basic` header is the one `requests` sends
    for auth=, and both packages' sinks send the same one to B2.
Each cluster's start and stop and each worker's stop go through
`within`, so a stuck subscription fails a test instead of the run.
"""
import functools
import os
import time

import pytest
import requests

import seaweedfs_tpu_torch.notification as port_notification
import seaweedfs_tpu_torch.notification.queues as port_queues
import seaweedfs_tpu_torch.replication as port_replication
import seaweedfs_tpu_torch.replication.filer_sync as port_filer_sync
import seaweedfs_tpu_torch.server.filer_server as port_filer_server
from seaweedfs_tpu.filer.filerstore import make_store as ref_make_store
from seaweedfs_tpu.replication import LocalSink as RefLocalSink
from seaweedfs_tpu.replication import Replicator as RefReplicator
from seaweedfs_tpu.replication.meta_backup import \
    FilerMetaBackup as RefMetaBackup
from seaweedfs_tpu.replication.sink import B2Sink as RefB2Sink
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.filer.filerstore import make_store
from seaweedfs_tpu_torch.replication import LocalSink, Replicator
from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
from seaweedfs_tpu_torch.replication.meta_backup import FilerMetaBackup
from seaweedfs_tpu_torch.replication.sink import B2Sink, basic_auth
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_replication as ref_cases
from tests.torch_port_cases import port_cases, run_case, swap_modules, within

PortCluster = functools.partial(Cluster, ec_backend="native")
SIDES = {
    "reference": (port_cases(ref_cases), {}),
    "port": (port_cases(
        ref_cases, Cluster=PortCluster, ServerThread=ServerThread,
        MemoryQueue=port_notification.MemoryQueue,
        attach_notifier=port_notification.attach_notifier,
        LocalSink=LocalSink, Replicator=Replicator,
        FilerMetaBackup=FilerMetaBackup),
        {"seaweedfs_tpu.replication": port_replication,
         "seaweedfs_tpu.replication.filer_sync": port_filer_sync,
         "seaweedfs_tpu.server.filer_server": port_filer_server,
         "seaweedfs_tpu.notification": port_notification,
         "seaweedfs_tpu.notification.queues": port_queues}),
}
CASES = list(SIDES["port"][0])
PKG = {"reference": dict(Cluster=RefCluster, Replicator=RefReplicator,
                         LocalSink=RefLocalSink, MetaBackup=RefMetaBackup,
                         make_store=ref_make_store),
       "port": dict(Cluster=PortCluster, Replicator=Replicator,
                    LocalSink=LocalSink, MetaBackup=FilerMetaBackup,
                    make_store=make_store)}


def test_every_reference_case_is_mirrored():
    assert CASES == list(SIDES["reference"][0])
    assert CASES == [
        "TestLocalSinkReplication.test_create_update_delete_mirrored",
        "TestLocalSinkReplication.test_offset_resume_skips_replayed",
        "TestS3SinkReplication.test_mirror_into_s3_bucket",
        "TestFilerSync.test_active_active_no_loop",
        "TestMetaBackup.test_backup_applies_and_resumes",
        "TestNotifications.test_memory_queue_receives_events",
        "TestNotifications.test_log_queue_appends_jsonl",
        "TestGatedQueues.test_all_queue_backends_are_real"]


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """The reference fixture's cluster (a filer and the S3 gateway),
    one per package."""
    out = {}
    try:
        for side, pkg in PKG.items():
            c = within(60, pkg["Cluster"], str(tmp_path_factory.mktemp(
                f"repl_{side}")), n_volume_servers=1, with_filer=True,
                with_s3=True)
            out[side] = c
            within(30, c.wait_for_nodes, 1)
        yield out
    finally:
        for c in out.values():
            within(30, c.stop)


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, side, clusters, tmp_path, tmp_path_factory):
    cases, swaps = SIDES[side]
    c = clusters[side]
    with swap_modules(swaps, parents=True):
        run_case(cases[case], {
            "repl_cluster": {"cluster": c, "base": str(tmp_path)},
            "tmp_path": tmp_path, "tmp_path_factory": tmp_path_factory})


# ----------------------------------------------------------------------
# across packages
# ----------------------------------------------------------------------
def _wait(pred, timeout=20.0, msg="condition"):
    end = time.monotonic() + timeout
    while True:
        out = pred()
        if out:
            return out
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.05)


def _creates(filer, prefix: str) -> dict[str, int]:
    """path -> create events in a filer's event log under prefix."""
    out: dict[str, int] = {}
    for ev in filer.meta_log.replay(0, prefix):
        if ev["old_entry"] is None and ev["new_entry"] is not None:
            p = ev["new_entry"]["full_path"]
            out[p] = out.get(p, 0) + 1
    return out


def _get(url: str) -> bytes | None:
    r = requests.get(url, timeout=10)
    return r.content if r.status_code == 200 else None


def test_port_sync_between_a_reference_and_a_port_filer(clusters):
    a, b = clusters["reference"], clusters["port"]
    sync = FilerSync(a.filer_url, b.filer_url, path_prefix="/xs")
    sync.start()
    try:
        files = {f"/xs/a{i}.bin": os.urandom(300 + i) for i in range(3)}
        for p, d in files.items():
            requests.put(f"{a.filer_url}{p}", data=d,
                         timeout=10).raise_for_status()
        back = {f"/xs/b{i}.bin": os.urandom(500 + i) for i in range(3)}
        for p, d in back.items():
            requests.put(f"{b.filer_url}{p}", data=d,
                         timeout=10).raise_for_status()
        _wait(lambda: all(_get(f"{b.filer_url}{p}") == d
                          for p, d in files.items()), msg="A -> B")
        _wait(lambda: all(_get(f"{a.filer_url}{p}") == d
                          for p, d in back.items()), msg="B -> A")
        # quiet: the counters settle, nothing bounces
        time.sleep(2.0)
        counts = (sync.a_to_b.applied, sync.b_to_a.applied)
        time.sleep(1.5)
        assert (sync.a_to_b.applied, sync.b_to_a.applied) == counts
        assert sync.a_to_b.failed == sync.b_to_a.failed == 0
        every = {**files, **back}
        for c in (a, b):
            creates = _creates(c.filer.filer, "/xs")
            assert {p: creates.get(p) for p in every} == \
                {p: 1 for p in every}
        # B's events for A's writes name A's signature
        sig_a = requests.get(f"{a.filer_url}/status",
                             timeout=10).json()["signature"]
        for ev in b.filer.filer.meta_log.replay(0, "/xs"):
            if (ev["new_entry"] or {}).get("full_path") in files:
                assert sig_a in ev["signatures"]
    finally:
        within(15, sync.stop)


@pytest.mark.parametrize("first,second", [("reference", "port"),
                                          ("port", "reference")])
def test_replicator_resumes_from_the_others_offset(first, second, clusters,
                                                   tmp_path):
    c = clusters["port"]
    prefix, key = f"/rs_{first}", f"test/rs_{first}/offset"
    mirror = str(tmp_path / "mirror")
    r1 = PKG[first]["Replicator"](c.filer_url, PKG[first]["LocalSink"](
        mirror), path_prefix=prefix, offset_key=key)
    r1.start()
    try:
        requests.put(f"{c.filer_url}{prefix}/one.txt", data=b"1",
                     timeout=10).raise_for_status()
        _wait(lambda: os.path.exists(f"{mirror}/one.txt"), msg="one")
        _wait(lambda: _get(f"{c.filer_url}/kv/{key}"), msg="the offset")
    finally:
        within(15, r1.stop)
    saved = int(_get(f"{c.filer_url}/kv/{key}"))
    requests.put(f"{c.filer_url}{prefix}/two.txt", data=b"2",
                 timeout=10).raise_for_status()
    os.remove(f"{mirror}/one.txt")
    r2 = PKG[second]["Replicator"](c.filer_url, PKG[second]["LocalSink"](
        mirror), path_prefix=prefix, offset_key=key)
    r2.start()
    try:
        _wait(lambda: os.path.exists(f"{mirror}/two.txt"), msg="two")
        time.sleep(0.5)
        assert not os.path.exists(f"{mirror}/one.txt")
        assert (r2.applied, r2.failed) == (1, 0)
        assert int(_get(f"{c.filer_url}/kv/{key}")) > saved
    finally:
        within(15, r2.stop)


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_meta_backup_file_read_by_the_other(writer, reader, clusters,
                                            tmp_path):
    c = clusters[writer]
    prefix = f"/mb_{writer}"
    db = str(tmp_path / "meta.db")
    b = PKG[writer]["MetaBackup"](c.filer_url, db, path_prefix=prefix)
    b.start()
    try:
        for name in ("x.txt", "sub/y.txt"):
            requests.put(f"{c.filer_url}{prefix}/{name}", data=b"12345",
                         timeout=10).raise_for_status()
        _wait(lambda: b.find_entry(f"{prefix}/sub/y.txt") is not None,
              msg="the backup")
    finally:
        within(15, b.stop)
    offset = int(b.store.kv_get("meta_backup/offset"))
    names = [e.full_path for e in b.list_entries(prefix)]
    b.store.close()
    other = PKG[reader]["make_store"]("sqlite", path=db)
    try:
        assert int(other.kv_get("meta_backup/offset")) == offset
        assert [e.full_path for e in other.list_directory_entries(prefix)] \
            == names == [f"{prefix}/sub", f"{prefix}/x.txt"]
        e = other.find_entry(f"{prefix}/x.txt")
        assert e.file_size == 5 and e.chunks
    finally:
        other.close()
    # the reader's backup resumes there: one later event, applied once
    b2 = PKG[reader]["MetaBackup"](c.filer_url, db, path_prefix=prefix)
    b2.start()
    try:
        requests.delete(f"{c.filer_url}{prefix}/x.txt",
                        timeout=10).raise_for_status()
        _wait(lambda: b2.find_entry(f"{prefix}/x.txt") is None,
              msg="the delete")
        time.sleep(0.3)
        assert b2.applied == 1
    finally:
        within(15, b2.stop)
        b2.store.close()


def test_b2_basic_auth_is_what_requests_sends(monkeypatch):
    from tests import minicloud

    assert basic_auth("kid", "akey") == \
        requests.auth._basic_auth_str("kid", "akey")
    assert basic_auth("kéy", "s:crêt") == \
        requests.auth._basic_auth_str("kéy", "s:crêt")
    seen = []
    orig = minicloud._B2Handler.do_GET

    def record(self):
        seen.append(self.headers.get("Authorization"))
        return orig(self)

    monkeypatch.setattr(minicloud._B2Handler, "do_GET", record)
    s = minicloud.MiniB2()
    try:
        s.store.buckets["pics"] = {}
        for cls in (RefB2Sink, B2Sink):
            cls(bucket="pics", key_id="kid", application_key="akey",
                api_base=s.endpoint)
    finally:
        s.close()
    assert len(seen) == 2 and seen[0] == seen[1] == \
        requests.auth._basic_auth_str("kid", "akey")
