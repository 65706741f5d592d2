"""The port's cluster — master, volume servers, shell — against the JAX
package's, over HTTP (tolerance 0).

* The same seeded writes and the same ec.encode / shard loss /
  ec.rebuild (partial, then full) / ec.decode through each package's
  own client and shell: the port under CudaCodec(device="cpu") (the
  kernel's plain version), the reference under "numpy", both volume
  clocks and both masters' cookies pinned. Needle bytes on every read
  pass, the .dat and .idx, every shard's sha256, the .ecx, the decoded
  .dat and .idx and the placement must be equal. Placement is compared
  by node rank (a server's index in the sorted server urls), which is
  the order the spread and the rebuilder choice rank servers in; ports
  are ephemeral, so the rank, not the url, is what two clusters share.
* The wire contract both ways: the port's CommandEnv and verbs drive
  the reference's aiohttp cluster, and the reference's CommandEnv and
  verbs drive the port's.
* No route turns an error into a 200: a codec that raises inside
  ec/generate fails ec.encode; a volume server on "cuda" raises
  without a GPU.
* Two admin routes at once on one shared codec, with reads running.
* Heartbeats by POST: a silent server is unregistered and comes back;
  a volume server beats at the master's pulse where it is shorter.
* The data plane's routes and the master's status routes.
* `python -m seaweedfs_tpu_torch server` and the shell against it.
"""
import hashlib
import os
import random
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import requests
import torch

from seaweedfs_tpu.operation import verbs as ref_verbs
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu.server import master_server as ref_ms
from seaweedfs_tpu.shell import commands_ec as ref_cmd
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.shell.env import ShellError as RefShellError
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu_torch.ec import geometry as geo
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server import master_server as port_ms
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell import commands_ec, repl
from seaweedfs_tpu_torch.shell.env import CommandEnv, ShellError
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage import volume as port_volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_760_000_000_123_456_789
DAT_TARGET = 2_200_000      # needle data on shards 0-2 of the 1 MiB rows


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _get(url: str):
    return session().get(url, timeout=30)


class Side:
    """One cluster and the client stack that drives it."""

    def __init__(self, cluster, env, verbs_mod, cmd_mod, get):
        self.cluster = cluster
        self.env = env
        self.verbs = verbs_mod
        self.cmd = cmd_mod
        self.get = get
        self.urls = sorted(f"{s.ip}:{s.port}" for s in cluster.stores)

    def rank(self, url: str) -> int:
        return self.urls.index(url)

    def store_at(self, url: str):
        return next(s for s in self.cluster.stores
                    if f"{s.ip}:{s.port}" == url)

    def shard_files(self, vid: int) -> dict[int, str]:
        out = {}
        for store in self.cluster.stores:
            ecv = store.ec_volumes.get(vid)
            for sid, shard in (ecv.shards.items() if ecv else ()):
                out[sid] = shard.path
        return out

    def drop(self, vid: int, sids) -> None:
        locs = self.env.ec_shard_locations(vid)
        for sid in sids:
            for url in locs.get(sid, []):
                self.env.vs_post(url, "/admin/ec/delete",
                                 {"volume": vid, "shard_ids": [sid]})
        deadline = time.monotonic() + 20
        while set(sids) & set(self.env.ec_shard_locations(vid)):
            assert time.monotonic() < deadline, "shard loss not registered"
            time.sleep(0.05)


def _ref_get(url: str):
    return requests.get(url, timeout=30)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The reference's cluster and the port's, with pinned volume clocks
    and a pinned cookie sequence in both masters."""
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
                                      volume_size_limit=16 << 20,
                                      max_volumes=8, ec_backend="numpy")
        port = Cluster(str(base / "port"), n_volume_servers=3,
                       volume_size_limit=16 << 20, max_volumes=8,
                       ec_backend=CudaCodec(device="cpu"))
        ref_env, port_env = RefEnv(ref.master_url), CommandEnv(port.master_url)
        ref_env.acquire_lock()
        port_env.acquire_lock()
        yield (Side(ref, ref_env, ref_verbs, ref_cmd, _ref_get),
               Side(port, port_env, verbs, commands_ec, _get))
    finally:
        for c in (port, ref):
            if c is not None:
                c.stop()
        mp.undo()


def _write(side: Side, collection: str, seed: int):
    """Grow one volume on the rank-0 server, then seeded needles through
    assign + upload: 1 KiB-256 KiB log-uniform, 5% overwrites, then 2%
    of the fids deleted. -> (vid, {fid: bytes}, deleted fids)."""
    grown = side.env.master_get("/vol/grow", collection=collection,
                                count=1, dataNode=side.urls[0])
    assert grown["count"] == 1
    rng = np.random.default_rng(seed)
    live, total = {}, 0
    while total < DAT_TARGET:
        data = rng.bytes(int(np.exp(rng.uniform(np.log(1 << 10),
                                                np.log(256 << 10)))))
        if live and rng.random() < 0.05:
            fids = sorted(live)
            fid = fids[int(rng.integers(0, len(fids)))]
        else:
            a = side.verbs.assign(side.env.master_url,
                                  collection=collection)
            assert a.url == side.urls[0]
            fid = a.fid
        side.verbs.upload(f"http://{side.urls[0]}/{fid}", data)
        live[fid] = data
        total += len(data)
    dead = [str(f) for f in rng.choice(sorted(live), len(live) // 50,
                                       replace=False)]
    for fid in dead:
        side.verbs.delete(f"http://{side.urls[0]}/{fid}")
        del live[fid]
    vids = {int(f.split(",")[0]) for f in live}
    assert len(vids) == 1
    return vids.pop(), live, dead


def _read_all(side: Side, server: str, live: dict) -> None:
    for fid, data in live.items():
        r = side.get(f"http://{server}/{fid}")
        assert r.status_code == 200, (fid, r.status_code)
        assert r.content == data, fid


def _lifecycle(ref: Side, port: Side, collection: str, seed: int,
               compare_files: bool) -> None:
    """The EC lifecycle on both sides, compared step by step."""
    (vid, live, dead), (pvid, plive, pdead) = \
        _write(ref, collection, seed), _write(port, collection, seed)
    assert (pvid, list(plive), pdead) == (vid, list(live), dead)
    assert plive == live
    if compare_files:
        rvol = ref.store_at(ref.urls[0]).find_volume(vid)
        pvol = port.store_at(port.urls[0]).find_volume(vid)
        rvol.sync()                 # both buffer appends in user space
        pvol.sync()
        rbase, pbase = rvol.file_name(), pvol.file_name()
        for ext in (".dat", ".idx"):
            assert _digest(pbase + ext) == _digest(rbase + ext), ext

    # ec.encode: generate on the source, spread by ec/copy, drop the volume
    placements = [side.cmd.ec_encode(side.env, vid) for side in (ref, port)]
    assert {s: port.rank(u) for s, u in placements[1].items()} == \
        {s: ref.rank(u) for s, u in placements[0].items()}
    shards = [side.shard_files(vid) for side in (ref, port)]
    assert sorted(shards[1]) == list(range(geo.TOTAL_SHARDS))
    orig = {s: _digest(p) for s, p in shards[0].items()}
    if compare_files:
        assert {s: _digest(p) for s, p in shards[1].items()} == orig
        for sid in (0, 13):
            assert _digest(shards[1][sid][:-len(geo.shard_ext(sid))]
                           + ".ecx") == \
                _digest(shards[0][sid][:-len(geo.shard_ext(sid))] + ".ecx")
    for side, pl in ((ref, placements[0]), (port, placements[1])):
        _read_all(side, pl[1], live)

    # three shards lost: degraded reads, then the partial rebuild
    for side in (ref, port):
        side.drop(vid, (0, 5, 11))
    for side, pl in ((ref, placements[0]), (port, placements[1])):
        _read_all(side, pl[1], live)
    outs = [side.cmd.ec_rebuild(side.env, vid) for side in (ref, port)]
    shard_size = os.path.getsize(shards[0][1])
    for side, out in zip((ref, port), outs):
        assert out["mode"] == "partial" and out["rebuilt"] == [0, 5, 11]
        out["rebuilder"] = side.rank(out["rebuilder"])
        # first-k-wins keeps every reply that lands in the same wait, on
        # both sides, so the bytes fetched vary with timing: between the
        # k ranges a chunk needs and every surviving remote shard
        fetched = out.pop("read_bytes")
        assert 0 < fetched <= 11 * shard_size
    assert outs[1] == outs[0]
    for side in (ref, port):
        now = side.shard_files(vid)
        assert {s: _digest(p) for s, p in now.items()} == orig

    # the same loss through the full rebuild
    for side in (ref, port):
        side.drop(vid, (0, 5, 11))
    outs = [side.cmd.ec_rebuild(side.env, vid, partial=False)
            for side in (ref, port)]
    for side, out in zip((ref, port), outs):
        assert out["mode"] == "full"
        out["rebuilder"] = side.rank(out["rebuilder"])
    assert outs[1] == outs[0]
    for side, pl in ((ref, placements[0]), (port, placements[1])):
        now = side.shard_files(vid)
        assert {s: _digest(p) for s, p in now.items()} == orig
        _read_all(side, pl[1], live)

    # two data shards lost, decode back to a volume
    for side in (ref, port):
        side.drop(vid, (0, 5))
    decoded = []
    for side in (ref, port):
        out = side.cmd.ec_decode(side.env, vid)
        v = side.store_at(out["server"]).find_volume(vid)
        decoded.append({ext: _digest(v.file_name() + ext)
                        for ext in (".dat", ".idx")})
        _read_all(side, out["server"], live)
    assert decoded[1] == decoded[0]


def test_lifecycle_byte_equal_to_the_reference(pair):
    ref, port = pair
    _lifecycle(ref, port, "cmp", seed=11, compare_files=True)


def test_wire_contract_both_ways(pair):
    """Swap the client stacks: the reference's shell and verbs drive the
    port's servers, the port's shell and verbs the reference's."""
    ref, port = pair
    port_on_ref = Side(ref.cluster, CommandEnv(ref.cluster.master_url),
                       verbs, commands_ec, _get)
    ref_on_port = Side(port.cluster, RefEnv(port.cluster.master_url),
                       ref_verbs, ref_cmd, _ref_get)
    for side in (port_on_ref, ref_on_port):
        side.env.acquire_lock()
    _lifecycle(port_on_ref, ref_on_port, "wire", seed=12,
               compare_files=False)
    # the reference's shell sees the port's errors as its own
    with pytest.raises(RefShellError, match="not found"):
        ref_cmd.ec_encode(ref_on_port.env, 424242)
    with pytest.raises(ShellError, match="not found"):
        commands_ec.ec_encode(port_on_ref.env, 424242)


class _Raising(CudaCodec):
    """A codec whose kernel fails, as a device fault would."""

    def _kernel(self, *a, **k):
        raise RuntimeError("injected codec fault")


def test_codec_error_fails_ec_encode(tmp_path):
    c = Cluster(str(tmp_path), n_volume_servers=2,
                ec_backend=_Raising(device="cpu"))
    try:
        env = CommandEnv(c.master_url)
        repl.run_command(env, "lock")
        fid = verbs.upload_data(c.master_url, b"x" * 5000, collection="e")
        vid = int(fid.split(",")[0])
        with pytest.raises(ShellError, match="injected codec fault"):
            repl.run_command(env, f"ec.encode -volumeId={vid}")
        # the volume was never dropped and still serves its needle
        url = env.volume_locations(vid)[0]
        assert _get(f"http://{url}/{fid}").content == b"x" * 5000
        r = session().post(f"http://{url}/admin/ec/generate",
                           json={"volume": vid})
        assert r.status_code == 500
        assert "injected codec fault" in r.json()["error"]
    finally:
        c.stop()


def test_cuda_volume_server_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda backend builds here")
    with pytest.raises(RuntimeError):
        Cluster(str(tmp_path), n_volume_servers=1, ec_backend="cuda")


def test_two_admin_routes_at_once_on_one_codec(tmp_path):
    """A partial rebuild of one volume and the generate of another run
    at the same time on one shared CudaCodec, while degraded reads of
    the first run beside them; every byte stays right."""
    codec = CudaCodec(device="cpu")
    c = Cluster(str(tmp_path), n_volume_servers=3, max_volumes=8,
                volume_size_limit=16 << 20, ec_backend=codec)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        env = CommandEnv(c.master_url)
        env.acquire_lock()
        rng = np.random.default_rng(3)
        vols = []
        for col in ("a", "b"):
            live = {}
            for _ in range(40):
                data = rng.bytes(int(rng.integers(1000, 200_000)))
                live[verbs.upload_data(c.master_url, data,
                                       collection=col)] = data
            vols.append((int(next(iter(live)).split(",")[0]), live))
        (va, live_a), (vb, live_b) = vols
        placement = commands_ec.ec_encode(env, va)
        files = {sid: p for s in c.stores if s.ec_volumes.get(va)
                 for sid, p in ((i, sh.path) for i, sh in
                                s.ec_volumes[va].shards.items())}
        orig = {s: _digest(p) for s, p in files.items()}
        Side(c, env, verbs, commands_ec, _get).drop(va, (2, 9))
        errors, outs = [], {}

        def run(name, fn):
            try:
                outs[name] = fn()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append((name, e))

        def reads():
            for _ in range(2):
                _read_all(Side(c, env, verbs, commands_ec, _get),
                          placement[1], live_a)
            return True

        env_a, env_b = CommandEnv(c.master_url), CommandEnv(c.master_url)
        env_a.acquire_lock()
        env_b.acquire_lock()
        threads = [
            threading.Thread(target=run, args=(
                "rebuild", lambda: commands_ec.ec_rebuild(env_a, va))),
            threading.Thread(target=run, args=(
                "encode", lambda: commands_ec.ec_encode(env_b, vb))),
            threading.Thread(target=run, args=("reads", reads)),
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        assert outs["rebuild"]["mode"] == "partial"
        now = {sid: _digest(sh.path) for s in c.stores
               if s.ec_volumes.get(va)
               for sid, sh in s.ec_volumes[va].shards.items()}
        assert now == orig
        _read_all(Side(c, env, verbs, commands_ec, _get),
                  outs["encode"][3], live_b)
        assert commands_ec.ec_verify(env, vb, sample_mb=0)["verified"]
    finally:
        sys.setswitchinterval(old)
        c.stop()


def test_silent_server_is_unregistered_then_returns(tmp_path):
    c = Cluster(str(tmp_path), n_volume_servers=2, pulse_seconds=0.1)
    try:
        vs = c.volume_servers[1]
        node = f"{vs.store.ip}:{vs.store.port}"
        assert node in c.master.topo.nodes
        vs._stop.set()                      # heartbeats stop
        vs._hb_thread.join(timeout=5)
        deadline = time.monotonic() + 10
        while node in c.master.topo.nodes:
            assert time.monotonic() < deadline, "never unregistered"
            time.sleep(0.05)
        vs.start()                          # and resume
        c.wait_for_nodes(2, timeout=10)
        assert node in c.master.topo.nodes
    finally:
        c.stop()


def test_volume_server_beats_at_the_masters_shorter_pulse(tmp_path):
    """A volume server built with the default 5 s pulse, under a master
    that reaps after 5 of its 0.2 s pulses, takes the master's pulse
    from the heartbeat reply and stays registered."""
    from seaweedfs_tpu_torch.rpc.http import ServerThread
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.store import Store

    ms = port_ms.MasterServer(pulse_seconds=0.2)
    mt = ServerThread(ms.app).start()
    ms.start()                              # its reaper
    store = Store([str(tmp_path)], ip="127.0.0.1", port=0,
                  ec_backend="numpy")
    vs = VolumeServer(store, mt.url)
    vt = ServerThread(vs.app).start()
    store.port = vt.port
    try:
        assert vs.pulse_seconds == 5.0
        vs.start()
        node = f"127.0.0.1:{vt.port}"
        deadline = time.monotonic() + 10
        while node not in ms.topo.nodes:
            assert time.monotonic() < deadline, "never registered"
            time.sleep(0.05)
        assert vs.pulse_seconds == 0.2
        time.sleep(2.0)                     # 10 of the master's pulses
        assert node in ms.topo.nodes
    finally:
        vs.stop()
        vt.stop()
        mt.stop()
        ms.stop()


def test_data_plane_and_status_routes(tmp_path):
    c = Cluster(str(tmp_path), n_volume_servers=2)
    try:
        s = session()
        master = c.master_url
        body = bytes(range(256)) * 40
        a = verbs.assign(master, collection="r")
        assert set(vars(a)) >= {"fid", "url", "public_url", "count"}
        verbs.upload(a, body, name="n.bin", mime="image/png")
        url = f"http://{a.url}/{a.fid}"
        r = s.get(url)
        assert r.content == body and r.headers["Content-Type"] == "image/png"
        assert r.headers["Etag"].strip('"')
        h = s.head(url)
        assert h.content == b"" and int(h.headers["Content-Length"]) == 10240
        r = s.get(url, headers={"Range": "bytes=100-199"})
        assert r.status_code == 206 and r.content == body[100:200]
        assert r.headers["Content-Range"] == "bytes 100-199/10240"
        r = s.get(url, headers={"Range": "bytes=0-9,20-29"})
        assert r.status_code == 200 and r.content == body
        assert s.get(url, headers={"Range": "bytes=99999-"}).status_code \
            == 416
        vid, key, cookie = t.parse_file_id(a.fid)
        wrong = t.format_file_id(vid, key, cookie ^ 1)
        assert s.get(f"http://{a.url}/{wrong}").status_code == 403
        other = next(th.address for th in c.volume_threads
                     if th.address != a.url)
        r = s.get(f"http://{other}/{a.fid}")     # not followed
        assert r.status_code == 301 and r.headers["Location"] == url
        assert s.delete(url).status_code == 202
        assert s.get(url).status_code == 404
        assert s.get(f"http://{a.url}/999,01637037d6").status_code == 404
        # a replicated volume's write and delete reach every replica
        a2 = verbs.assign(master, collection="rep", replication="001")
        verbs.upload(a2, b"twice", name="n\xe9.txt", mime="text/x-y")
        vid2 = int(a2.fid.split(",")[0])
        locs = [loc["url"] for loc in s.get(
            f"{master}/dir/lookup", params={"volumeId": vid2}).json()
            ["locations"]]
        assert len(locs) == 2
        for u in locs:
            r = s.get(f"http://{u}/{a2.fid}")
            assert r.content == b"twice"
            assert r.headers["Content-Type"] == "text/x-y"
        assert s.delete(f"http://{a2.url}/{a2.fid}").status_code == 202
        assert [s.get(f"http://{u}/{a2.fid}").status_code
                for u in locs] == [404, 404]
        # master status routes
        topo = s.get(f"{master}/dir/status").json()["Topology"]
        assert len([n for dc in topo["datacenters"] for r in dc["racks"]
                    for n in r["nodes"]]) == 2
        assert s.get(f"{master}/vol/status").json()["Volumes"] == \
            s.get(f"{master}/cluster/status").json()["Topology"]
        assert s.get(f"{master}/dir/lookup",
                     params={"volumeId": "4242"}).status_code == 404
        assert s.post(f"{master}/cluster/announce", json={
            "address": "f:1", "type": "filer"}).json() == {"ok": True}
        assert [n["address"] for n in s.get(
            f"{master}/cluster/nodes",
            params={"type": "filer"}).json()["nodes"]] == ["f:1"]
        for base in (master, f"http://{a.url}"):
            assert "/debug/ec" in s.get(f"{base}/debug").json()["endpoints"]
            assert "probe" in s.get(f"{base}/debug/ec").json()
        st = s.get(f"http://{a.url}/status").json()
        assert st["Version"] == "seaweedfs-tpu-torch"
        assert {v["id"] for v in st["volumes"]} >= {vid}
    finally:
        c.stop()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_cli_server_and_shell(tmp_path):
    mport, vport = _free_port(), _free_port()
    env_vars = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server",
         "-dir", str(tmp_path), "-master.port", str(mport),
         "-volume.port", str(vport), "-ec.backend", "native"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env_vars,
        cwd=str(tmp_path))
    master = f"http://127.0.0.1:{mport}"
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                env = CommandEnv(master)
                if len(env.data_nodes()) == 1:
                    break
            except (OSError, ShellError):
                pass
            assert time.monotonic() < deadline, "server never came up"
            time.sleep(0.2)
        live = {verbs.upload_data(master, bytes([i]) * (3000 + i),
                                  collection="cli"): bytes([i]) * (3000 + i)
                for i in range(20)}
        vid = int(next(iter(live)).split(",")[0])
        assert repl.run_command(env, "lock") == "locked"
        placement = repl.run_command(env, f"ec.encode -volumeId={vid}")
        assert set(placement.values()) == {f"127.0.0.1:{vport}"}
        assert any(v.get("ec_shards") == 14
                   for v in repl.run_command(env, "volume.list"))
        out = repl.run_command(env, f"ec.decode -volumeId={vid}")
        for fid, data in live.items():
            assert _get(f"http://{out['server']}/{fid}").content == data
        with pytest.raises(ShellError, match="unknown command"):
            repl.run_command(env, "fs.ls /")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
