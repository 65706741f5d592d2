"""The port's volume admin commands: the ports of `TestVolumeCommands`
(tests/test_shell_fs_volume.py) and `TestVolumeExt` / `TestServerLeave`
(tests/test_shell_ext.py) against the port's cluster, the repl's
dispatch of every volume.* name, the master's /vol/vacuum routes, and
the reference held against the port on the same seeded writes
(tolerance 0; both volume clocks and both masters' cookies pinned,
servers compared by rank): the .dat and .idx after a vacuum and the
reports of volume.vacuum, volume.fsck and volume.check.disk.

The port has no filer, so volume.fsck walks a stub filer: a tiny HTTP
app serving the filer's JSON listing (entries with chunk fids), which
the reference's walker reads the same way.
"""
import hashlib
import random
import threading
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.operation import verbs as ref_verbs
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu.server import master_server as ref_ms
from seaweedfs_tpu.shell import commands_volume as ref_cmd_vol
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.rpc.http import App, ServerThread, json_response
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server import master_server as port_ms
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell import commands_volume, repl
from seaweedfs_tpu_torch.shell.env import CommandEnv, ShellError
from seaweedfs_tpu_torch.storage import volume as port_volume

T0 = 1_760_000_000_123_456_789
DIR_MODE = 0o40000 | 0o755


def _get(url: str, **kw):
    return session().get(url, timeout=30, **kw)


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class StubFiler:
    """The filer's JSON listing over HTTP: {dir: {name: [fids]}}, each
    file entry with one chunk per fid."""

    def __init__(self):
        self.dirs: dict[str, dict[str, list[str]]] = {}
        self._lock = threading.Lock()
        app = App()
        app.get("/", self._list)
        app.route("GET", "/{path:.+}", self._list)
        self.thread = ServerThread(app).start()

    @property
    def url(self) -> str:
        return self.thread.url

    def put(self, path: str, fids: list[str]) -> None:
        d, _, name = path.rpartition("/")
        with self._lock:
            self.dirs.setdefault(d or "/", {})[name] = fids

    def remove(self, path: str) -> None:
        d, _, name = path.rpartition("/")
        with self._lock:
            self.dirs[d or "/"].pop(name)

    def _list(self, req):
        path = "/" + req.match_info.get("path", "").rstrip("/")
        with self._lock:
            subdirs = sorted({d for d in self.dirs if d != path and
                              d.rpartition("/")[0] == (path
                                                       if path != "/"
                                                       else "")})
            files = dict(self.dirs.get(path, {}))
        base = "" if path == "/" else path
        entries = [{"full_path": d, "mode": DIR_MODE} for d in subdirs]
        entries += [{"full_path": f"{base}/{name}", "mode": 0o644,
                     "chunks": [{"fid": f, "offset": 0, "size": 1}
                                for f in fids]}
                    for name, fids in sorted(files.items())]
        return json_response({"path": path, "entries": entries,
                              "shouldDisplayLoadMore": False,
                              "lastFileName": ""})

    def stop(self) -> None:
        self.thread.stop()


@pytest.fixture(scope="module")
def filer():
    f = StubFiler()
    yield f
    f.stop()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = Cluster(str(tmp_path_factory.mktemp("vol_cluster")),
                n_volume_servers=3, volume_size_limit=4 << 20,
                max_volumes=40, ec_backend=CudaCodec(device="cpu"))
    yield c
    c.stop()


@pytest.fixture(scope="module")
def env(cluster, filer):
    e = CommandEnv(cluster.master_url, filer_url=filer.url)
    e.acquire_lock()
    yield e
    e.close()


def _fill_volume(cluster, col):
    a = verbs.assign(cluster.master_url, collection=col)
    verbs.upload(a, b"payload-" + col.encode())
    return int(a.fid.split(",")[0]), a.fid


# ----------------------------------------------------------------------
# tests/test_shell_fs_volume.py TestVolumeCommands
# ----------------------------------------------------------------------
class TestVolumeCommands:
    def test_copy_and_move(self, cluster, env):
        vid, fid = _fill_volume(cluster, "mvcol")
        src = env.volume_locations(vid)[0]
        others = [n["url"] for n in env.data_nodes() if n["url"] != src]
        target = others[0]
        commands_volume.volume_copy(env, vid, src, target)
        for url in (src, target):
            assert _get(f"http://{url}/{fid}").status_code == 200
        commands_volume.volume_delete(env, vid, server=target)
        commands_volume.volume_move(env, vid, src, others[1])
        r = _get(f"http://{others[1]}/{fid}")
        assert r.status_code == 200

    def test_mount_unmount(self, cluster, env):
        vid, fid = _fill_volume(cluster, "mntcol")
        server = env.volume_locations(vid)[0]
        commands_volume.volume_unmount(env, vid, server)
        r = _get(f"http://{server}/{fid}")
        assert r.status_code in (301, 404)
        commands_volume.volume_mount(env, vid, server)
        assert _get(f"http://{server}/{fid}").status_code == 200

    def test_mark_readonly_blocks_writes(self, cluster, env):
        vid, _ = _fill_volume(cluster, "markcol")
        commands_volume.volume_mark(env, vid, writable=False)
        url = env.volume_locations(vid)[0]
        r = session().post(f"http://{url}/{vid},00000001deadbeef",
                           data=b"x", timeout=30)
        assert r.status_code in (403, 409, 500)
        commands_volume.volume_mark(env, vid, writable=True)

    def test_check_disk_repairs_divergence(self, cluster, env):
        vid, _fid = _fill_volume(cluster, "divcol")
        src = env.volume_locations(vid)[0]
        target = next(n["url"] for n in env.data_nodes()
                      if n["url"] != src)
        commands_volume.volume_copy(env, vid, src, target)
        # two-way divergence: one needle only on src, one only on target
        only_src = only_target = None
        for _ in range(8):
            a = verbs.assign(cluster.master_url, collection="divcol")
            if int(a.fid.split(",")[0]) != vid:
                continue
            if only_src is None:
                only_src = a.fid
                session().post(f"http://{src}/{only_src}?type=replicate",
                               data=b"only-on-src", timeout=30)
            else:
                only_target = a.fid
                session().post(
                    f"http://{target}/{only_target}?type=replicate",
                    data=b"only-on-target", timeout=30)
                break
        assert only_src and only_target
        out = commands_volume.volume_check_disk(env, vid)
        assert out["diverged"] and out["repaired"]
        for f, data in ((only_src, b"only-on-src"),
                        (only_target, b"only-on-target")):
            for url in (src, target):
                r = _get(f"http://{url}/{f}")
                assert r.status_code == 200 and r.content == data, \
                    (f, url)
        assert not commands_volume.volume_check_disk(env, vid)["diverged"]

    def test_check_disk_propagates_tombstone(self, cluster, env):
        """A delete applied on one replica must not be undone by sync —
        the tombstone wins over the stale live copy."""
        vid, fid = _fill_volume(cluster, "tombcol")
        src = env.volume_locations(vid)[0]
        target = next(n["url"] for n in env.data_nodes()
                      if n["url"] != src)
        commands_volume.volume_copy(env, vid, src, target)
        r = session().delete(f"http://{src}/{fid}?type=replicate",
                             timeout=30)
        assert r.status_code < 300
        out = commands_volume.volume_check_disk(env, vid)
        assert any("deleted_on" in rep for rep in out["repaired"])
        for url in (src, target):
            r = _get(f"http://{url}/{fid}")
            assert r.status_code == 404, url
        assert not commands_volume.volume_check_disk(env, vid)["diverged"]

    def test_fsck_clean_then_orphan(self, cluster, env, filer):
        vid, fid = _fill_volume(cluster, "fsckcol")
        filer.put("/fsck_zone/file.bin", [fid])
        out = commands_volume.volume_fsck(env)
        assert out["volumes_checked"] >= 1
        assert vid not in out["orphans"] and vid not in out["missing"]
        # orphan: the entry goes, its chunk stays
        filer.remove("/fsck_zone/file.bin")
        out = commands_volume.volume_fsck(env)
        assert any(out["orphans"].values())
        with pytest.raises(ShellError, match="needs a filer"):
            commands_volume.volume_fsck(CommandEnv(cluster.master_url))

    def test_evacuate(self, cluster, env):
        vid, fid = _fill_volume(cluster, "evaccol")
        server = env.volume_locations(vid)[0]
        moves = commands_volume.volume_evacuate(env, server)
        assert any(m.get("volume") == vid for m in moves)
        locs = env.volume_locations(vid)
        assert locs and server not in locs
        assert _get(f"http://{locs[0]}/{fid}").status_code == 200

    def test_grow_and_collections(self, cluster, env):
        commands_volume.volume_grow(env, count=1, collection="growcol")
        assert "growcol" in commands_volume.collection_list(env)
        assert commands_volume.collection_delete(env, "growcol")
        assert "growcol" not in commands_volume.collection_list(env)

    def test_balance_evens_volume_counts(self, cluster, env):
        # pile three fresh volumes onto one server, then balance
        heavy = env.data_nodes()[0]["url"]
        for i in range(3):
            env.master_get("/vol/grow", collection=f"bal{i}", count=1,
                           dataNode=heavy)
        counts = {n["url"]: len(n["volumes"]) for n in env.data_nodes()}
        target = -(-sum(counts.values()) // len(counts))
        moves = commands_volume.volume_balance(env)
        assert moves
        for m in moves:
            assert counts[m["from"]] > target
            locs = env.volume_locations(m["volume"])
            assert m["to"] in locs and m["from"] not in locs


# ----------------------------------------------------------------------
# tests/test_shell_ext.py TestVolumeExt / TestServerLeave
# ----------------------------------------------------------------------
class TestVolumeExt:
    def test_configure_replication(self, cluster, env):
        vid, _ = _fill_volume(cluster, "vrcol")
        out = commands_volume.volume_configure_replication(env, vid, "001")
        assert all(r["replication"] == "001" for r in out)
        out2 = commands_volume.volume_configure_replication(env, vid,
                                                            "000")
        assert all(r["replication"] == "000" for r in out2)

    def test_bad_replication_rejected(self, env):
        with pytest.raises(ValueError):
            commands_volume.volume_configure_replication(env, 1, "9z")

    def test_delete_empty(self, cluster, env):
        commands_volume.volume_grow(env, count=1, collection="emptycol")
        before = {v["volume"] for v in commands_volume.volume_list(env)
                  if v.get("server")}
        deleted = commands_volume.volume_delete_empty(env, force=True)
        assert deleted
        for d in deleted:
            assert d["volume"] in before

    def test_vacuum_toggle(self, cluster, env):
        out = commands_volume.volume_vacuum_toggle(env, disable=True)
        assert out["vacuum_disabled"] is True
        assert env.master_get("/cluster/status")["VacuumDisabled"] is True
        with pytest.raises(ShellError, match="disabled"):
            commands_volume.volume_vacuum(env)
        r = session().post(cluster.master_url + "/vol/vacuum", timeout=30)
        assert (r.status_code, r.json()) == (409,
                                             {"error": "vacuum disabled"})
        out = commands_volume.volume_vacuum_toggle(env, disable=False)
        assert out["vacuum_disabled"] is False
        commands_volume.volume_vacuum(env)  # runs again

    def test_dispatch_new_commands(self, cluster, env):
        assert repl.run_command(env, "volume.vacuum.enable")[
            "vacuum_disabled"] is False
        assert isinstance(
            repl.run_command(env, "volume.deleteEmpty -force"), list)


def test_delete_reaches_a_replica_moved_within_the_lookup_ttl(cluster,
                                                               env):
    """The primary's cached peers still name a server that dropped its
    replica (moved within LOOKUP_TTL): a delete it answers with 404 is
    fanned out again to the peers the master lists now, so the moved
    replica does not keep the needle."""
    a = verbs.assign(cluster.master_url, collection="ttlcol",
                     replication="001")
    vid = int(a.fid.split(",")[0])
    fids = [a.fid]
    verbs.upload(a, b"first")
    for i in range(3):      # primes the primary's peer cache
        b = verbs.assign(cluster.master_url, collection="ttlcol",
                         replication="001")
        verbs.upload(b, b"more-%d" % i)
        fids.append(b.fid)
    holders = env.volume_locations(vid)
    assert len(holders) == 2
    primary = a.url
    old = next(u for u in holders if u != primary)
    new = next(n["url"] for n in env.data_nodes()
               if n["url"] not in holders)
    commands_volume.volume_copy(env, vid, primary, new)
    commands_volume.volume_delete(env, vid, server=old)
    assert sorted(env.volume_locations(vid)) == sorted([primary, new])
    verbs.delete(f"http://{primary}/{fids[0]}")
    for url in (primary, new):
        assert _get(f"http://{url}/{fids[0]}").status_code == 404, url
        assert _get(f"http://{url}/{fids[1]}").status_code == 200, url


def test_repl_dispatches_every_volume_command(cluster, env):
    vid, fid = _fill_volume(cluster, "replcol")
    src = env.volume_locations(vid)[0]
    other = next(n["url"] for n in env.data_nodes() if n["url"] != src)
    run = lambda line: repl.run_command(env, line)  # noqa: E731
    assert run("cluster.check")["nodes"] == 3
    assert "replcol" in run("collection.list")
    assert run(f"volume.scrub -volumeId={vid}")[0]["bad"] == []
    assert run(f"volume.mark -volumeId={vid} -readonly") == [src]
    assert run(f"volume.mark -volumeId={vid} -writable") == [src]
    run(f"volume.copy -volumeId={vid} -source={src} -target={other}")
    assert not run(f"volume.check.disk -volumeId={vid}")["diverged"]
    run(f"volume.delete -volumeId={vid} -server={other}")
    run(f"volume.unmount -volumeId={vid} -server={src}")
    run(f"volume.mount -volumeId={vid} -server={src}")
    assert run(f"volume.configure.replication -volumeId={vid} "
               f"-replication=000")[0]["replication"] == "000"
    assert run("volume.fix.replication") == []
    assert isinstance(run("volume.vacuum -threshold=0.9"), list)
    assert run("volume.fsck")["volumes_checked"] >= 1
    run(f"volume.move -volumeId={vid} -source={src} -target={other}")
    assert _get(f"http://{other}/{fid}").status_code == 200
    assert run("volume.grow -count=1 -collection=replgrow")["count"] == 1
    assert run("collection.delete replgrow")
    # last: balance may move any volume, vid included
    assert isinstance(run("volume.balance"), list)
    for name in ("volume.tier.move", "volume.tier.upload",
                 "volume.tier.download", "volume.tier.offload",
                 "volume.tier.recall"):
        with pytest.raises(ShellError, match="not yet ported"):
            run(f"{name} -volumeId={vid}")
    with pytest.raises(ShellError, match="unknown command"):
        run("fs.ls /")


def test_vacuum_routes_answer_as_the_reference(cluster):
    ref = ref_cluster_mod.Cluster(
        str(cluster.base_dir) + "_ref", n_volume_servers=0)
    try:
        for path, method in (("/vol/vacuum?garbageThreshold=abc", "get"),
                             ("/vol/vacuum/disable", "post"),
                             ("/vol/vacuum?garbageThreshold=0.5", "post"),
                             ("/vol/vacuum/enable", "post"),
                             ("/vol/vacuum?garbageThreshold=0.5", "get")):
            out = [getattr(session(), method)(url + path, timeout=30)
                   for url in (ref.master_url, cluster.master_url)]
            if path.endswith("0.5") and out[0].status_code == 200:
                # both ran the vacuum: only their shapes compare
                assert out[1].status_code == 200
                assert set(out[1].json()) == set(out[0].json())
                continue
            assert (out[1].status_code, out[1].json()) == \
                (out[0].status_code, out[0].json()), path
    finally:
        ref.stop()


class TestServerLeave:
    def test_leave_removes_from_topology(self, tmp_path):
        c = Cluster(str(tmp_path), n_volume_servers=2,
                    volume_size_limit=4 << 20,
                    ec_backend=CudaCodec(device="cpu"))
        try:
            e = CommandEnv(c.master_url)
            e.acquire_lock()
            nodes = e.data_nodes()
            assert len(nodes) == 2
            victim = nodes[0]["url"]
            out = commands_volume.volume_server_leave(e, victim)
            assert out.get("left")
            deadline = time.time() + 10
            while time.time() < deadline:
                if victim not in {n["url"] for n in e.data_nodes()}:
                    break
                time.sleep(0.2)
            assert victim not in {n["url"] for n in e.data_nodes()}
            # it serves on until shut down
            assert _get(f"http://{victim}/status").status_code == 200
        finally:
            c.stop()


# ----------------------------------------------------------------------
# the reference against the port on the same seeded writes
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
        yield ((ref, envs[0], ref_verbs, ref_cmd_vol, RefEnv),
               (port, envs[1], verbs, commands_volume, CommandEnv))
    finally:
        for c in (port, ref):
            if c is not None:
                c.stop()
        mp.undo()


def _urls(c) -> list[str]:
    return sorted(f"{s.ip}:{s.port}" for s in c.stores)


def _seeded_volume(side, col: str, seed: int, n: int = 40):
    """Grow a volume on the rank-0 server and write seeded needles.
    -> (vid, [fids])."""
    c, env, verbs_mod = side[0], side[1], side[2]
    urls = _urls(c)
    assert env.master_get("/vol/grow", collection=col, count=1,
                          dataNode=urls[0])["count"] == 1
    rng = np.random.default_rng(seed)
    fids = []
    for _ in range(n):
        a = verbs_mod.assign(env.master_url, collection=col)
        assert a.url == urls[0]
        verbs_mod.upload(f"http://{urls[0]}/{a.fid}",
                         rng.bytes(int(rng.integers(500, 30000))))
        fids.append(a.fid)
    vids = {int(f.split(",")[0]) for f in fids}
    assert len(vids) == 1
    return vids.pop(), fids


def _volume_on(c, vid):
    return next(s.find_volume(vid) for s in c.stores
                if s.find_volume(vid) is not None)


def test_vacuum_bytes_and_report_equal_to_the_reference(pair):
    outs = []
    for side in pair:
        c, env, verbs_mod, cmd_vol, _ = side
        vid, fids = _seeded_volume(side, "vac", seed=31)
        rng = np.random.default_rng(32)
        dead = rng.choice(len(fids), int(len(fids) * 0.3), replace=False)
        urls = _urls(c)
        for i in sorted(dead):
            verbs_mod.delete(f"http://{urls[0]}/{fids[i]}")
        v = _volume_on(c, vid)
        v.sync()
        before = v.content_size()
        report = cmd_vol.volume_vacuum(env, garbage_threshold=0.2)
        v = _volume_on(c, vid)
        v.sync()
        base = v.file_name()
        outs.append((vid, before, v.content_size(),
                     [{**r, "replicas": [urls.index(u)
                                         for u in r["replicas"]]}
                      for r in report],
                     {ext: _digest(base + ext) for ext in (".dat", ".idx")}))
        live = [f for i, f in enumerate(fids) if i not in set(dead)]
        for f in live:
            assert side[0] is c
            r = session().get(f"http://{urls[0]}/{f}", timeout=30)
            assert r.status_code == 200
    assert outs[1] == outs[0]
    _vid, before, after, report, _ = outs[1]
    assert after < before and report and report[0]["replicas"] == [0]


def test_check_disk_report_equal_to_the_reference(pair):
    outs = []
    for side in pair:
        c, env, verbs_mod, cmd_vol, _ = side
        vid, fids = _seeded_volume(side, "cdk", seed=33, n=12)
        urls = _urls(c)
        cmd_vol.volume_copy(env, vid, urls[0], urls[1])
        # the reference's copy replies before its heartbeat lands
        deadline = time.monotonic() + 15
        while len(env.volume_locations(vid)) < 2:
            assert time.monotonic() < deadline, "copy never registered"
            time.sleep(0.05)
        # a needle only on the copy, a tombstone only on the source
        a = verbs_mod.assign(env.master_url, collection="cdk")
        session().post(f"http://{urls[1]}/{a.fid}?type=replicate",
                       data=b"only-on-the-copy", timeout=30)
        session().delete(f"http://{urls[0]}/{fids[3]}?type=replicate",
                         timeout=30)
        out = cmd_vol.volume_check_disk(env, vid)
        rank = {u: urls.index(u) for u in urls}
        out["repaired"] = [{k: (rank[v] if k in ("to", "deleted_on",
                                                 "overwrote") else v)
                            for k, v in rep.items()}
                           for rep in out["repaired"]]
        again = cmd_vol.volume_check_disk(env, vid)
        outs.append((out, again["diverged"]))
    assert outs[1] == outs[0]
    out, again = outs[1]
    assert out["diverged"] and len(out["repaired"]) == 2 and not again


def test_fsck_report_equal_to_the_reference(pair, filer):
    outs = []
    for side in pair:
        c, env, _, cmd_vol, env_cls = side
        vid, fids = _seeded_volume(side, "fsk", seed=34, n=10)
        outs.append((vid, fids))
    assert outs[1] == outs[0]        # pinned cookies: the same fids
    vid, fids = outs[0]
    filer.put("/pair/kept.bin", fids[:7])
    filer.put("/pair/sub/gone.bin", [f"{vid},{99 << 32 | 0xfeed:x}"
                                     "00000001"])
    reports = []
    for side in pair:
        c, env, _, cmd_vol, env_cls = side
        # fsck takes no admin lock: an unlocked env names the filer
        reports.append(cmd_vol.volume_fsck(env_cls(c.master_url,
                                                   filer_url=filer.url)))
    assert reports[1] == reports[0]
    assert len(reports[1]["orphans"][vid]) == 3
    assert reports[1]["missing"] == {vid: [99 << 32 | 0xfeed]}
