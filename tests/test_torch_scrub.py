"""The port of tests/test_scrub.py: volume.scrub's full-read CRC
verification with quarantine, and ec.verify's parity check of spread
shards with its repair request — against the port's cluster, whose
volume servers run the kernel's plain version (CudaCodec(device="cpu")).

Beyond the reference file:

* ec.verify's enqueued rebuild lands: with -repair.enabled the
  watchdog rebuilds the quarantined shard sha256-equal to the original,
  and a second ec.verify passes.
* The reports of volume.scrub and ec.verify equal the reference's on
  the same seeded writes (tolerance 0; both volume clocks and both
  masters' cookies pinned, servers compared by rank).
"""
import hashlib
import random
import secrets
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.operation import verbs as ref_verbs
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu.server import master_server as ref_ms
from seaweedfs_tpu.shell import commands_ec as ref_cmd_ec
from seaweedfs_tpu.shell import commands_volume as ref_cmd_vol
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server import master_server as port_ms
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell import commands_ec, commands_volume
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage import volume as port_volume

T0 = 1_760_000_000_123_456_789


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _wait(pred, timeout=15, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise TimeoutError(f"{msg} never became true")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = Cluster(str(tmp_path_factory.mktemp("scrub")),
                n_volume_servers=3, volume_size_limit=4 << 20,
                max_volumes=40, ec_backend=CudaCodec(device="cpu"))
    yield c
    c.stop()


@pytest.fixture(scope="module")
def env(cluster):
    e = CommandEnv(cluster.master_url)
    e.acquire_lock()
    return e


def fill_volume(cluster, col, n=20, size=4096, replication=""):
    rng = np.random.default_rng(1)
    a0 = verbs.assign(cluster.master_url, collection=col,
                      replication=replication)
    vid = int(a0.fid.split(",")[0])
    verbs.upload(a0, rng.bytes(size))
    for _ in range(n - 1):
        a = verbs.assign(cluster.master_url, collection=col,
                         replication=replication)
        verbs.upload(a, rng.bytes(size))
    return vid


def repair_pending(cluster) -> set:
    r = session().get(cluster.master_url + "/debug/repair",
                      timeout=30).json()
    return {(p["volume"], p["kind"]) for p in r["pending"]}


def _flip_needle_byte(v) -> tuple[int, int, bytes]:
    """Flip a data byte of the volume's first live needle behind the
    server's back. -> (needle id, byte offset, original byte)."""
    key, off, _size = next(v.nm.live_items())
    byte_off = t.offset_to_actual(off) + t.NEEDLE_HEADER_SIZE + 2
    orig = v.dat.read_at(1, byte_off)
    v.dat.write_at(bytes([orig[0] ^ 0xFF]), byte_off)
    return key, byte_off, orig


def _flip_shard_byte(shard, off: int = 10) -> bytes:
    orig = shard.read_at(off, 1)
    with open(shard.path, "r+b") as f:
        f.seek(off)
        f.write(bytes([orig[0] ^ 0x5A]))
    return orig


def _restore_shard_byte(shard, orig: bytes, off: int = 10) -> None:
    with open(shard.path, "r+b") as f:
        f.seek(off)
        f.write(orig)


class TestVolumeScrub:
    def test_clean_volume_scrubs_clean(self, cluster, env):
        col = "sc" + secrets.token_hex(3)
        vid = fill_volume(cluster, col)
        out = commands_volume.volume_scrub(env, volume_id=vid)
        assert out and all(r["bad"] == [] for r in out)
        assert sum(r["checked"] for r in out) >= 1

    def test_corruption_detected(self, cluster, env):
        col = "bad" + secrets.token_hex(3)
        vid = fill_volume(cluster, col, n=8)
        store = next(s for s in cluster.stores
                     if s.find_volume(vid) is not None)
        v = store.find_volume(vid)
        key, byte_off, orig = _flip_needle_byte(v)
        out = commands_volume.volume_scrub(env, volume_id=vid)
        bad = [b for r in out for b in r["bad"]]
        assert any(b["id"] == key for b in bad)
        # single replica: quarantine can only freeze it (readonly) —
        # dropping the last copy would lose the healthy needles too
        q = [r["quarantine"] for r in out if r.get("bad")]
        assert q and q[0]["action"] == "readonly"
        assert not q[0]["repair_enqueued"]
        v.dat.write_at(orig, byte_off)

    def test_corrupt_replica_quarantined_and_repair_enqueued(
            self, cluster, env):
        col = "qr" + secrets.token_hex(3)
        vid = fill_volume(cluster, col, n=6, replication="001")
        locs = set(env.volume_locations(vid))
        assert len(locs) == 2
        store = next(s for s in cluster.stores
                     if s.find_volume(vid) is not None)
        corrupt_url = store.public_url
        _flip_needle_byte(store.find_volume(vid))
        out = commands_volume.volume_scrub(env, volume_id=vid)
        q = [r for r in out if r.get("bad")]
        assert len(q) == 1 and q[0]["server"] == corrupt_url
        assert q[0]["quarantine"]["action"] == "unmounted"
        assert q[0]["quarantine"]["repair_enqueued"] is True
        # the corrupt replica left the topology; the healthy one serves
        _wait(lambda: corrupt_url not in env.volume_locations(vid),
              timeout=10, msg="corrupt replica gone")
        # and the loss is on the master's repair queue as pending work
        assert (vid, "replica") in repair_pending(cluster)

    def test_scrub_report_only_mode(self, cluster, env):
        col = "ro" + secrets.token_hex(3)
        vid = fill_volume(cluster, col, n=4)
        store = next(s for s in cluster.stores
                     if s.find_volume(vid) is not None)
        v = store.find_volume(vid)
        _key, byte_off, orig = _flip_needle_byte(v)
        try:
            out = commands_volume.volume_scrub(env, volume_id=vid,
                                               quarantine=False)
            assert any(r["bad"] for r in out)
            assert all("quarantine" not in r for r in out)
        finally:
            v.dat.write_at(orig, byte_off)

    def test_scrub_all_with_limit(self, cluster, env):
        out = commands_volume.volume_scrub(env, limit=3)
        assert all(r["checked"] <= 3 for r in out)


class TestEcVerify:
    def test_verify_after_encode(self, cluster, env):
        col = "ev" + secrets.token_hex(3)
        vid = fill_volume(cluster, col, n=12, size=8192)
        commands_ec.ec_encode(env, vid)
        out = commands_ec.ec_verify(env, vid, sample_mb=1)
        assert out["verified"] is True
        assert out["bytes_checked_per_shard"] > 0

    def test_verify_detects_shard_corruption(self, cluster, env):
        col = "evc" + secrets.token_hex(3)
        vid = fill_volume(cluster, col, n=12, size=8192)
        commands_ec.ec_encode(env, vid)
        ecv = next(s.ec_volumes[vid] for s in cluster.stores
                   if vid in s.ec_volumes)
        _sid, shard = next(iter(ecv.shards.items()))
        orig = _flip_shard_byte(shard)
        try:
            out = commands_ec.ec_verify(env, vid, sample_mb=1,
                                        quarantine=False)
            assert out["verified"] is False
        finally:
            _restore_shard_byte(shard, orig)

    def test_corrupt_shard_quarantined_and_rebuild_enqueued(
            self, cluster, env):
        col = "evq" + secrets.token_hex(3)
        vid = fill_volume(cluster, col, n=12, size=8192)
        commands_ec.ec_encode(env, vid)
        ecv = next(s.ec_volumes[vid] for s in cluster.stores
                   if vid in s.ec_volumes)
        sid, shard = next(iter(ecv.shards.items()))
        _flip_shard_byte(shard)
        out = commands_ec.ec_verify(env, vid, sample_mb=1)
        assert out["verified"] is False
        assert out["corrupt_shard"] == sid
        assert out["quarantined"] is True
        assert out["repair_enqueued"] is True
        # the corrupt shard is gone from its holder and the rebuild is
        # pending on the master's repair queue
        _wait(lambda: sid not in env.ec_shard_locations(vid),
              timeout=10, msg="corrupt shard gone")
        assert (vid, "ec") in repair_pending(cluster)
        # still recoverable: 13 of 14 shards live
        live = sum(len(u) for u in env.ec_shard_locations(vid).values())
        assert live == 13

    def test_missing_shards_reported(self, env):
        out = commands_ec.ec_verify(env, 999_999)
        assert out["verified"] is False and out["missing_shards"]


def test_verify_repair_request_is_rebuilt_sha256_equal(tmp_path):
    """The loop ec.verify opens closes: with -repair.enabled the
    watchdog rebuilds the quarantined shard, byte for byte, and a
    second full-shard verify passes."""
    c = Cluster(str(tmp_path), n_volume_servers=3, pulse_seconds=0.3,
                volume_size_limit=4 << 20, max_volumes=40,
                ec_backend=CudaCodec(device="cpu"), repair_enabled=True,
                repair_interval=0.5,
                # rides out ec.encode's server-by-server mounts; the
                # repair ec.verify asks for starts at once
                repair_grace=5.0)
    try:
        env = CommandEnv(c.master_url)
        env.acquire_lock()
        vid = fill_volume(c, "heal", n=16, size=8192)
        commands_ec.ec_encode(env, vid)
        assert session().get(c.master_url + "/debug/repair",
                             timeout=5).json()["recent"] == []
        paths = {sid: shard.path for s in c.stores
                 for sid, shard in (s.ec_volumes[vid].shards.items()
                                    if vid in s.ec_volumes else ())}
        orig = {sid: _digest(p) for sid, p in paths.items()}
        ecv = next(s.ec_volumes[vid] for s in c.stores
                   if vid in s.ec_volumes)
        sid = sorted(ecv.shards)[-1]
        _flip_shard_byte(ecv.shards[sid], off=100)
        out = commands_ec.ec_verify(env, vid, sample_mb=0)
        assert (out["verified"], out["corrupt_shard"], out["quarantined"],
                out["repair_enqueued"]) == (False, sid, True, True)

        def healed():
            rep = session().get(c.master_url + "/debug/repair",
                                timeout=5).json()
            return any(r["volume"] == vid and r["ok"]
                       for r in rep["recent"])

        _wait(healed, timeout=20, msg="ec repair done")
        rec = next(r for r in session().get(
            c.master_url + "/debug/repair", timeout=5).json()["recent"]
            if r["volume"] == vid)
        assert (rec["kind"], rec["reason"]) == ("ec", "scrub")
        assert rec["detail"]["rebuilt"] == [sid]
        now = {s2: _digest(shard.path) for s in c.stores
               for s2, shard in (s.ec_volumes[vid].shards.items()
                                 if vid in s.ec_volumes else ())}
        assert now == orig
        again = commands_ec.ec_verify(env, vid, sample_mb=0)
        assert again["verified"] is True
    finally:
        c.stop()


# ----------------------------------------------------------------------
# the reports against the reference's, on the same seeded writes
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    clock = types.SimpleNamespace(time_ns=lambda: T0, time=lambda: T0 / 1e9)
    for mod in (ref_volume, port_volume):
        mp.setattr(mod, "time", clock)
    for mod in (ref_ms, port_ms):
        cookies = random.Random(7)
        mp.setattr(mod, "_new_cookie",
                   lambda rng=cookies: rng.getrandbits(32))
    base = tmp_path_factory.mktemp("pair")
    ref = port = None
    try:
        ref = ref_cluster_mod.Cluster(str(base / "ref"), n_volume_servers=3,
                                      volume_size_limit=4 << 20,
                                      max_volumes=8, ec_backend="numpy")
        port = Cluster(str(base / "port"), n_volume_servers=3,
                       volume_size_limit=4 << 20, max_volumes=8,
                       ec_backend=CudaCodec(device="cpu"))
        envs = RefEnv(ref.master_url), CommandEnv(port.master_url)
        for e in envs:
            e.acquire_lock()
        yield ((ref, envs[0], ref_verbs, ref_cmd_vol, ref_cmd_ec),
               (port, envs[1], verbs, commands_volume, commands_ec))
    finally:
        for c in (port, ref):
            if c is not None:
                c.stop()
        mp.undo()


def _urls(c) -> list[str]:
    return sorted(f"{s.ip}:{s.port}" for s in c.stores)


def _seeded_volume(side, col: str, seed: int, n: int = 24) -> int:
    """Grow a volume on the rank-0 server, write seeded needles."""
    c, env, verbs_mod = side[0], side[1], side[2]
    urls = _urls(c)
    assert env.master_get("/vol/grow", collection=col, count=1,
                          dataNode=urls[0])["count"] == 1
    rng = np.random.default_rng(seed)
    vids = set()
    for _ in range(n):
        a = verbs_mod.assign(env.master_url, collection=col)
        assert a.url == urls[0]
        verbs_mod.upload(f"http://{urls[0]}/{a.fid}",
                         rng.bytes(int(rng.integers(500, 30000))))
        vids.add(int(a.fid.split(",")[0]))
    assert len(vids) == 1
    return vids.pop()


def _ranked(c, report: list[dict]) -> list[dict]:
    urls = _urls(c)
    return [{**r, "server": urls.index(r["server"])} for r in report]


def test_scrub_reports_equal_to_the_reference(pair):
    outs = []
    for side in pair:
        c, env, _, cmd_vol, _ = side
        vid = _seeded_volume(side, "scr", seed=21)
        clean = cmd_vol.volume_scrub(env, volume_id=vid)
        v = next(s.find_volume(vid) for s in c.stores
                 if s.find_volume(vid) is not None)
        _flip_needle_byte(v)
        bad = cmd_vol.volume_scrub(env, volume_id=vid)
        limited = cmd_vol.volume_scrub(env, volume_id=vid, limit=5,
                                       quarantine=False)
        outs.append((vid, _ranked(c, clean), _ranked(c, bad),
                     _ranked(c, limited)))
    assert outs[1] == outs[0]
    vid, clean, bad, _ = outs[1]
    assert clean[0]["bad"] == [] and clean[0]["checked"] == 24
    assert len(bad[0]["bad"]) == 1
    assert bad[0]["quarantine"] == {"action": "readonly",
                                    "repair_enqueued": False}


def test_ec_verify_reports_equal_to_the_reference(pair):
    outs = []
    for side in pair:
        c, env, _, _, cmd_ec = side
        vid = _seeded_volume(side, "ver", seed=22, n=40)
        cmd_ec.ec_encode(env, vid)
        clean = cmd_ec.ec_verify(env, vid, sample_mb=0)
        ecv = next(s.ec_volumes[vid] for s in c.stores
                   if vid in s.ec_volumes and 7 in s.ec_volumes[vid].shards)
        _flip_shard_byte(ecv.shards[7], off=333)
        report_only = cmd_ec.ec_verify(env, vid, sample_mb=0,
                                       quarantine=False)
        quarantined = cmd_ec.ec_verify(env, vid, sample_mb=0)
        pending = session().get(env.master_url + "/debug/repair",
                                timeout=10).json()["pending"]
        outs.append((clean, report_only, quarantined,
                     [(p["volume"], p["kind"], p["reason"])
                      for p in pending if p["volume"] == vid]))
    assert outs[1] == outs[0]
    clean, report_only, quarantined, pending = outs[1]
    assert clean["verified"] is True
    assert report_only["verified"] is False
    assert quarantined["corrupt_shard"] == 7
    assert quarantined["repair_enqueued"] is True
    assert pending == [(quarantined["volume"], "ec", "scrub")]
