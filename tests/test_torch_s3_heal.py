"""S3 objects erasure-coded under a live watchdog at grace 0, behind the
filer's DLM lock, and healed — the port on the CPU
(CudaCodec(device="cpu"), the kernel's plain version).

A port cluster with a filer, the S3 gateway and 5 volume servers over 3
racks, `-repair.enabled` with `-repair.grace` 0. Objects are PUT
through S3 (SigV4), then a shell with `-filer` takes `lock` through the
filer's DLM and runs `ec.encode` on every volume of the bucket's
collection while the watchdog runs:

* no rebuild ran during the encodes, and no shard is listed twice;
* a shard deleted while the shell still holds the lock is a deficit the
  watchdog sees and tries to repair, and each attempt is refused by the
  lock ("cannot acquire admin lock") — nothing is rebuilt until
  `unlock`, and then the watchdog rebuilds it;
* a stopped server's shards are rebuilt by the watchdog, and every
  object reads back byte-equal through S3, its ETag as the PUT's.

Without a filer the same shell's lock is process-local (the reference's
single-operator mode): tests/test_torch_dlm.py.
"""
import hashlib
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell import repl
from seaweedfs_tpu_torch.shell.env import CommandEnv

from tests.s3v4client import S3V4Client

SEED = 20261017
TOPOLOGY = [("dc1", "rA"), ("dc1", "rA"), ("dc1", "rB"), ("dc1", "rB"),
            ("dc1", "rC")]
AK, SK = "HEALAK", "heal-secret"
CFG = {"identities": [{"name": "op", "actions": ["Admin"],
                       "credentials": [{"accessKey": AK, "secretKey": SK}]}]}
BUCKET = "healme"


def _wait(pred, timeout=30.0, msg="condition"):
    end = time.monotonic() + timeout
    while True:
        out = pred()
        if out:
            return out
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.05)


def _objects():
    rng = np.random.default_rng(SEED)
    out = {}
    for i in range(40):
        if i % 5 == 0:
            body = ("\n".join(f'{{"i": {i}, "v": {j}}}'
                              for j in range(200))).encode()
            out[f"logs/{i:03d}.json"] = body
        else:
            out[f"data/{i:03d}.bin"] = rng.bytes(
                int(rng.integers(1 << 10, 700 << 10)))
    return out


def _compressed_flags(c, objs) -> dict[str, bool]:
    """{key: FLAG_IS_COMPRESSED of its one chunk's needle}, read from
    the stores of the plain volumes."""
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.storage import needle as ndl
    from seaweedfs_tpu_torch.storage.types import parse_file_id

    out = {}
    for key in objs:
        meta = session().get(f"{c.filer_url}/buckets/{BUCKET}/{key}",
                             params={"meta": "1"}, timeout=10).json()
        vid, nid, cookie = parse_file_id(meta["chunks"][0]["fid"])
        s = next(s for s in c.stores if s.has_volume(vid))
        out[key] = bool(s.read_needle(vid, nid, cookie).flags
                        & ndl.FLAG_IS_COMPRESSED)
    return out


@pytest.fixture(scope="module")
def healed(tmp_path_factory):
    """Runs the whole scenario once; the tests read its record."""
    c = Cluster(str(tmp_path_factory.mktemp("s3heal")),
                n_volume_servers=len(TOPOLOGY), max_volumes=8,
                volume_size_limit=6 << 20, pulse_seconds=0.3,
                topology=TOPOLOGY, repair_enabled=True, repair_interval=0.5,
                repair_grace=0.0, ec_backend=CudaCodec(device="cpu"),
                with_filer=True, filer_store="sqlite", with_s3=True,
                s3_config=CFG)
    env = CommandEnv(c.master_url, filer_url=c.filer_url)
    rec = {"cluster": c}
    try:
        s3 = S3V4Client(c.s3_url, AK, SK)
        assert s3.put(f"/{BUCKET}").status == 200
        objs = _objects()
        for key, body in objs.items():
            r = s3.put(f"/{BUCKET}/{key}", body)
            assert r.status == 200
            assert r.header("etag") == f'"{hashlib.md5(body).hexdigest()}"'
        rec["objects"] = objs
        rec["gzipped"] = _compressed_flags(c, objs)
        time.sleep(1.0)                 # heartbeats carry final sizes
        vids = sorted({int(v) for n in env.data_nodes()
                       for v, col in n["collections"].items()
                       if col == BUCKET})
        rec["vids"] = vids

        assert repl.run_command(env, "lock") == "locked"
        since = time.time()
        for vid in vids:
            repl.run_command(env, f"ec.encode -volumeId={vid}")
        rec["after_encode"] = env.master_get("/debug/repair")["recent"]
        rec["encode_window"] = (since, time.time())
        rec["locations"] = {vid: env.ec_shard_locations(vid)
                            for vid in vids}

        # a shard lost while the shell holds the lock
        vid = vids[0]
        locs = env.ec_shard_locations(vid)
        index = {f"{s.ip}:{s.port}": i for i, s in enumerate(c.stores)}
        c.admin(index[locs[5][0]], "/admin/ec/delete",
                {"volume": vid, "shard_ids": [5]})

        def refused():
            rep = env.master_get("/debug/repair")
            return [r for r in rep["recent"] if r["volume"] == vid
                    and not r["ok"] and "cannot acquire admin lock"
                    in r["error"]]

        rec["refused"] = _wait(refused, msg="a refused repair attempt")
        rec["before_unlock"] = env.master_get("/debug/repair")["recent"]
        rec["locked_shards"] = sorted(env.ec_shard_locations(vid))
        assert repl.run_command(env, "unlock") == "unlocked"
        t_unlock = time.time()
        _wait(lambda: len(env.ec_shard_locations(vid)) == 14,
              msg="shard 5 rebuilt after unlock")
        # the master lists the rebuilt shard (the volume server replies
        # once its heartbeat is acknowledged) just before the watchdog's
        # worker records its result: wait for the result too, or it
        # lands in the lost-server window below
        rec["after_unlock"] = _wait(
            lambda: [r for r in env.master_get("/debug/repair")["recent"]
                     if r["finished_at"] >= t_unlock and r["ok"]
                     and r["volume"] == vid], msg="the result after unlock")

        # a lost server, healed by the watchdog
        held = {}
        for v in vids:
            for sid, urls in env.ec_shard_locations(v).items():
                held.setdefault(urls[0], []).append((v, sid))
        victim = min(held, key=lambda u: (len(held[u]), u))
        rec["lost"] = sorted(held[victim])
        t_kill = time.time()
        c.volume_threads[index[victim]].stop()
        _wait(lambda: any(e["volume"] in vids for e in
                          env.master_get("/cluster/status")["UnderParity"]),
              msg="the deficit")
        _wait(lambda: not env.master_get("/cluster/status")["UnderParity"]
              and all(len(env.ec_shard_locations(v)) == 14 for v in vids),
              timeout=60, msg="14 live shards on every volume")
        lost_vids = {v for v, _ in rec["lost"]}

        def heal_results():
            # the master may list the rebuilt shards just before the
            # worker records its result
            got = [r for r in env.master_get("/debug/repair")["recent"]
                   if r["finished_at"] >= t_kill and r["ok"]
                   and r["detail"].get("rebuilt")]
            return got if {r["volume"] for r in got} >= lost_vids else None

        rec["heal"] = _wait(heal_results, msg="the watchdog's results")
        rec["final_locations"] = {v: env.ec_shard_locations(v)
                                  for v in vids}
        rec["gets"] = {k: s3.get(f"/{BUCKET}/{k}") for k in objs}
        rec["listing"] = s3.get(f"/{BUCKET}", **{"list-type": "2"})
        yield rec
    finally:
        env.close()
        c.stop()


def test_no_rebuild_during_encode(healed):
    since, until = healed["encode_window"]
    during = [r for r in healed["after_encode"]
              if since <= r["finished_at"] <= until]
    assert not [r for r in during if r["ok"] and r["detail"].get("rebuilt")]
    assert not [r for r in during if not r["ok"] and
                "cannot acquire admin lock" not in r["error"]]


def test_every_shard_once_after_encode(healed):
    assert healed["vids"]
    for vid, locs in healed["locations"].items():
        assert sorted(locs) == list(range(14)), vid
        assert all(len(urls) == 1 for urls in locs.values()), locs


def test_the_lock_refuses_repairs_until_unlock(healed):
    vid = healed["vids"][0]
    assert healed["refused"]
    assert healed["locked_shards"] == [s for s in range(14) if s != 5]
    assert not [r for r in healed["before_unlock"]
                if r["volume"] == vid and r["ok"]
                and r["detail"].get("rebuilt")]
    assert any(r["volume"] == vid and r["detail"].get("rebuilt") == [5]
               for r in healed["after_unlock"])


def test_lost_server_rebuilt_by_the_watchdog(healed):
    lost = {}
    for vid, sid in healed["lost"]:
        lost.setdefault(vid, []).append(sid)
    rebuilt = {r["volume"]: sorted(r["detail"]["rebuilt"])
               for r in healed["heal"] if r["detail"].get("rebuilt")}
    assert rebuilt == {v: sorted(s) for v, s in lost.items()}
    for vid, locs in healed["final_locations"].items():
        assert sorted(locs) == list(range(14))
        assert all(len(urls) == 1 for urls in locs.values())


def test_every_object_reads_back_through_s3(healed):
    for key, body in healed["objects"].items():
        r = healed["gets"][key]
        assert r.status == 200, key
        assert r.body == body, key
        assert r.header("etag") == f'"{hashlib.md5(body).hexdigest()}"'
    assert healed["listing"].status == 200
    assert healed["listing"].body.count(b"<Key>") == len(healed["objects"])


def test_json_objects_stored_gzipped(healed):
    """The filer passed the .json names on, so the volume servers
    stored those chunks gzipped (and the .bin ones raw)."""
    flags = healed["gzipped"]
    assert flags and all(flags[k] == k.endswith(".json") for k in flags)
