"""The heartbeat stream (/ws/heartbeat) of the port against the JAX
package's (tolerance 0).

* Mixed clusters both ways: two reference and two port volume servers
  register with a port master, and with a reference master. Each
  server serves an assign, an upload and a read by fid, and an
  ec.encode of one server's volume spreads 14 shards over the mixed
  set, which the master lists and reads go through.
* `[reference|port]` at the default 5 s pulse: when a volume server
  stops, its master's /dir/lookup and /dir/assign stop naming it
  within 2 s (the stream's end, not 5 silent pulses).
* A follower ends the stream at the first report, and the volume
  server re-registers with the leader.
* A `wss://` stream reaches a TLS master.
* `poke_heartbeat(wait=True)` returns only once the master holds the
  change.
* `MasterServer.stop()` ends every stream and leaves no thread.
* The master's `/` page is the same on both packages for the same
  topology, whichever package's client sent the reports.
* A stream that answers no ping is dropped (the reference's
  `heartbeat=30`, shortened); `receive(timeout=)` keeps the stream.
* Where a server reconnected before its old stream ended, only the
  newest stream's end unregisters it.

Every wait polls for the state it asserts, up to a deadline; clusters
start and stop through `within`.
"""
import asyncio
import ssl
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.operation import verbs as ref_verbs
from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefVolume
from seaweedfs_tpu.shell import commands_ec as ref_cmd
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.rpc import websocket
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import commands_ec
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.utils import tls

from tests.torch_port_cases import within

SEED = 20261018
# the default pulse of both packages' masters and volume servers
DEFAULT_PULSE = 5.0
# what "at once" means at that pulse: under half of one
DROP_WITHIN = 2.0


def _wait(pred, timeout=20.0, msg="condition", step=0.02):
    end = time.monotonic() + timeout
    while True:
        out = pred()
        if out:
            return out
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(step)


def _nodes(master_url: str) -> set[str]:
    topo = session().get(f"{master_url}/dir/status",
                         timeout=10).json()["Topology"]
    return {n["url"] for dc in topo["datacenters"] for r in dc["racks"]
            for n in r["nodes"]}


# ----------------------------------------------------------------------
# mixed clusters
# ----------------------------------------------------------------------
class Mixed:
    """A master of one package with two volume servers of each: the
    port's on CudaCodec(device="cpu") (the kernel's plain version), the
    reference's on "numpy"."""

    def __init__(self, base: str, master: str):
        self.kind = master
        self.threads: list = []
        self.masters: list = []
        if master == "port":
            self.master = MasterServer(pulse_seconds=0.3)
            mt = ServerThread(self.master.app).start()
        else:
            self.master = RefMaster(pulse_seconds=0.3)
            mt = RefServerThread(self.master.app).start()
        self.master_url = mt.url
        self.master.admin_scripts_url = mt.url
        self.masters.append(mt)
        self.urls: dict[str, str] = {}      # url -> package
        for i, pkg in enumerate(("reference", "port", "reference",
                                 "port")):
            d = f"{base}/vol{i}"
            if pkg == "port":
                store = Store([d], ip="127.0.0.1", port=0,
                              ec_backend=CudaCodec(device="cpu"))
                vs = VolumeServer(store, mt.url, pulse_seconds=0.3)
                t = ServerThread(vs.app).start()
            else:
                store = RefStore([d], ip="127.0.0.1", port=0,
                                 ec_backend="numpy")
                vs = RefVolume(store, mt.url, pulse_seconds=0.3)
                t = RefServerThread(vs.app).start()
            store.port, store.public_url = t.port, t.address
            self.threads.append(t)
            self.urls[t.address] = pkg
        _wait(lambda: _nodes(self.master_url) == set(self.urls),
              msg="every volume server registered")

    def env(self):
        return (CommandEnv if self.kind == "port" else RefEnv)(
            self.master_url)

    def stop(self) -> None:
        if self.kind == "port":
            self.master.stop_maintenance()
        for t in self.threads + self.masters:
            t.stop()


@pytest.mark.parametrize("master", ["port", "reference"])
def test_mixed_cluster_serves_and_seals(master, tmp_path):
    """Both packages' volume servers on one master: each holds a grown
    volume that serves an assign, an upload and a read by fid; then an
    ec.encode of a volume of the other package's server lists 14 shards
    over the mixed set and every needle reads back."""
    c = within(60, Mixed, str(tmp_path), master)
    env = None
    try:
        env = c.env()
        cmd = commands_ec if master == "port" else ref_cmd
        vb = verbs if master == "port" else ref_verbs
        rng = np.random.default_rng(SEED)
        written: dict[str, tuple[str, bytes]] = {}
        for i, url in enumerate(sorted(c.urls)):
            col = f"m{i}"
            grown = env.master_get("/vol/grow", collection=col, count=1,
                                   dataNode=url)
            assert grown["count"] == 1
            for j in range(8):
                a = vb.assign(c.master_url, collection=col)
                assert a.url == url, (c.urls[url], a.url)
                data = rng.bytes(int(rng.integers(1 << 10, 64 << 10)))
                vb.upload(f"http://{a.url}/{a.fid}", data)
                written[a.fid] = (url, data)
        for fid, (url, data) in written.items():
            r = session().get(f"http://{url}/{fid}", timeout=30)
            assert r.status_code == 200 and r.content == data, fid
        # seal a volume of the package that is not the master's
        other = next(u for u in sorted(c.urls) if c.urls[u] != master)
        vid = int(next(f for f, (u, _) in written.items()
                       if u == other).split(",")[0])
        time.sleep(3 * 0.3)                 # heartbeats carry the sizes
        env.acquire_lock()
        cmd.ec_encode(env, vid)
        locs = _wait(lambda: (lambda m: m if sorted(m) == list(range(14))
                              else None)(env.ec_shard_locations(vid)),
                     msg="14 shards listed")
        holders = {u for urls in locs.values() for u in urls}
        assert {c.urls[u] for u in holders} == {"port", "reference"}
        for fid, (url, data) in written.items():
            if int(fid.split(",")[0]) != vid:
                continue
            for holder in sorted(holders):
                r = session().get(f"http://{holder}/{fid}", timeout=30)
                assert r.status_code == 200 and r.content == data, \
                    (fid, holder)
    finally:
        if env is not None:
            env.close()
        within(60, c.stop)


# ----------------------------------------------------------------------
# a stopped server leaves at once, at the default pulse
# ----------------------------------------------------------------------
@pytest.mark.parametrize("side", ["reference", "port"])
def test_a_stopped_server_leaves_within_2_s(side, tmp_path):
    """Two volume servers, one grown volume each, at the 5 s default
    pulse: once one server stops, /dir/lookup of its volume no longer
    names it and no /dir/assign hands it out, within 2 s (the port's
    former reaper took 5 silent pulses, 25 s)."""
    make = Cluster if side == "port" else ref_cluster_mod.Cluster
    backend = CudaCodec(device="cpu") if side == "port" else "numpy"
    c = within(60, make, str(tmp_path), n_volume_servers=2,
               pulse_seconds=DEFAULT_PULSE, ec_backend=backend)
    try:
        urls = [t.address for t in c.volume_threads]
        for url in urls:
            r = session().get(f"{c.master_url}/vol/grow",
                              params={"collection": "d", "count": 1,
                                      "dataNode": url}, timeout=30)
            assert r.status_code == 200 and r.json()["count"] == 1, r.text
        vids = {f"{st.ip}:{st.port}": v for st in c.stores
                for loc in st.locations for v in loc.volumes}
        gone = urls[1]
        start = time.monotonic()
        within(30, c.volume_threads[1].stop)

        def named() -> set[str]:
            out = set()
            for url in urls:
                r = session().get(f"{c.master_url}/dir/lookup",
                                  params={"volumeId": vids[url]},
                                  timeout=10)
                if r.status_code == 200:
                    out |= {loc["url"] for loc in r.json()["locations"]}
            return out

        _wait(lambda: gone not in named(), timeout=DROP_WITHIN,
              msg=f"{side}: /dir/lookup to drop {gone}", step=0.01)
        took = time.monotonic() - start
        assert took < DROP_WITHIN, took
        for _ in range(20):
            r = session().get(f"{c.master_url}/dir/assign",
                              params={"collection": "d"}, timeout=10)
            assert r.status_code == 200 and r.json()["url"] == urls[0], \
                r.text
    finally:
        within(60, c.stop)


# ----------------------------------------------------------------------
# a follower ends the stream; wss; poke; stop
# ----------------------------------------------------------------------
def test_a_follower_ends_the_stream(tmp_path):
    """Three raft masters. A volume server sent to a follower first has
    its stream ended at its first report, finds the leader and
    registers there; the follower's topology stays empty."""
    c = within(90, Cluster, str(tmp_path / "c"), n_volume_servers=1,
               n_masters=3, raft_tick=2.0, pulse_seconds=0.3,
               ec_backend=CudaCodec(device="cpu"))
    vt = vs = None
    try:
        leader = c.master_url
        urls = c.master_urls.split(",")
        follower_i = next(i for i, u in enumerate(urls) if u != leader)
        follower = c.masters[follower_i]
        store = Store([str(tmp_path / "v")], ip="127.0.0.1", port=0,
                      ec_backend=CudaCodec(device="cpu"))
        vs = VolumeServer(store, c.master_urls, pulse_seconds=0.3)
        probes: list[str] = []
        real = vs._find_leader

        def find_leader() -> str:
            url = urls[follower_i] if not probes else real()
            probes.append(url)
            return url

        vs._find_leader = find_leader
        vt = ServerThread(vs.app).start()
        store.port, store.public_url = vt.port, vt.address
        _wait(lambda: vt.address in c.master.topo.nodes,
              msg="registered with the leader")
        assert probes[0] == urls[follower_i]
        assert probes[1:] and all(p == leader for p in probes[1:])
        assert vt.address not in follower.topo.nodes
        assert not follower._hb_streams
    finally:
        if vt is not None:
            within(30, vt.stop)
        within(60, c.stop)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return tls.generate_self_signed(str(tmp_path_factory.mktemp("certs")))


def test_wss_stream_reaches_a_tls_master(certs, tmp_path, monkeypatch):
    """An https master: the volume server's stream is wss:// (a TLS
    socket), registers, and drops the server when it stops."""
    monkeypatch.setenv("REQUESTS_CA_BUNDLE", certs["ca_cert"])
    ctx = tls.server_ssl_context(certs["cert"], certs["key"])
    c = within(60, Cluster, str(tmp_path), n_volume_servers=2,
               pulse_seconds=DEFAULT_PULSE, tls={"master": ctx},
               ec_backend=CudaCodec(device="cpu"))
    try:
        assert c.master_url.startswith("https://")
        vs = c.volume_servers[1]
        ws = _wait(lambda: vs._hb_ws, msg="the stream")
        assert isinstance(ws.sock, ssl.SSLSocket)
        assert len(c.master._hb_streams) == 2
        gone = c.volume_threads[1].address
        within(30, c.volume_threads[1].stop)
        _wait(lambda: gone not in c.master.topo.nodes,
              timeout=DROP_WITHIN, msg="the TLS stream's end")
    finally:
        within(60, c.stop)


def test_poke_wait_returns_once_the_master_holds_the_change(tmp_path):
    """At a 5 s pulse a volume added to the store is not on the master
    until the next beat; poke_heartbeat(wait=True) returns once it is,
    well before that beat."""
    c = within(60, Cluster, str(tmp_path), n_volume_servers=1,
               pulse_seconds=DEFAULT_PULSE,
               ec_backend=CudaCodec(device="cpu"))
    try:
        vs = c.volume_servers[0]
        node = c.master.topo.nodes[c.volume_threads[0].address]
        time.sleep(0.3)                 # the first beat's reply is in
        vs.store.add_volume(77, "poke")
        time.sleep(0.3)
        assert 77 not in node.volumes   # no beat since
        start = time.monotonic()
        vs.poke_heartbeat(wait=True)
        assert 77 in node.volumes
        assert time.monotonic() - start < 2.0
        # and it goes the same way: the deletion is on the master too
        vs.store.delete_volume(77)
        vs.poke_heartbeat(wait=True)
        assert 77 not in node.volumes
    finally:
        within(60, c.stop)


def test_master_stop_ends_every_stream(tmp_path):
    """MasterServer.stop() aborts every heartbeat stream and waits for
    its thread: no stream thread outlives it, its servers are
    unregistered, and the volume servers' reconnects are refused."""
    c = within(60, Cluster, str(tmp_path), n_volume_servers=3,
               pulse_seconds=0.3, ec_backend=CudaCodec(device="cpu"))
    try:
        ms = c.master
        streams = _wait(lambda: (lambda s: s if len(s) == 3 else None)(
            dict(ms._hb_streams)), msg="three streams")
        within(30, ms.stop)
        assert not any(th.is_alive() for th in streams.values())
        assert not ms._hb_streams and not ms.topo.nodes
        time.sleep(1.5)                 # the servers' reconnects
        assert not ms._hb_streams and not ms.topo.nodes
        left = [t.name for t in threading.enumerate()
                if t.name == "master-heartbeat-stream" and t.is_alive()]
        assert left == []
    finally:
        within(60, c.stop)


# ----------------------------------------------------------------------
# the master's / page
# ----------------------------------------------------------------------
def _reports() -> list[dict]:
    return [{"ip": "10.0.0.1", "port": 8080, "public_url": "10.0.0.1:8080",
             "max_volume_count": 8, "data_center": "dc1", "rack": "r1",
             "volumes": [{"id": 3, "collection": "a", "size": 1024,
                          "file_count": 2, "replica_placement": "000"}],
             "ec_shards": []},
            {"ip": "10.0.0.2", "port": 8080, "public_url": "10.0.0.2:8080",
             "max_volume_count": 4, "data_center": "dc1", "rack": "r2",
             "volumes": [{"id": 5, "collection": "", "size": 7,
                          "file_count": 1, "replica_placement": "000"}],
             "ec_shards": [{"id": 9, "collection": "e",
                            "shard_bits": 0b11}]}]


def _port_client_pages(urls: list[str]) -> list[tuple[str, str]]:
    socks = []
    try:
        for url in urls:
            for hb in _reports():
                ws = websocket.connect(f"{url}/ws/heartbeat")
                socks.append(ws)
                ws.send_json(hb)
                assert ws.receive(timeout=10) is not None
        out = []
        for url in urls:
            r = session().get(f"{url}/", timeout=10)
            out.append((r.headers["Content-Type"], r.text))
        return out
    finally:
        for ws in socks:
            ws.close()


def _reference_client_pages(urls: list[str]) -> list[tuple[str, str]]:
    import aiohttp

    async def run():
        async with aiohttp.ClientSession() as sess:
            socks = []
            try:
                for url in urls:
                    for hb in _reports():
                        ws = await sess.ws_connect(
                            url.replace("http", "ws", 1) + "/ws/heartbeat")
                        socks.append(ws)
                        await ws.send_json(hb)
                        msg = await ws.receive(timeout=10)
                        assert msg.type == aiohttp.WSMsgType.TEXT
                out = []
                for url in urls:
                    async with sess.get(f"{url}/") as r:
                        out.append((r.headers["Content-Type"],
                                    await r.text()))
                return out
            finally:
                for ws in socks:
                    await ws.close()

    return asyncio.run(run())


@pytest.mark.parametrize("client", ["reference", "port"])
def test_master_ui_page_is_the_same(client):
    """The same two reports on a reference and a port master, sent by
    one package's client: both masters' `/` pages are the same text
    (nodes: 2, the max volume id, the topology as JSON)."""
    ref = RefMaster(pulse_seconds=DEFAULT_PULSE)
    port = MasterServer(pulse_seconds=DEFAULT_PULSE)
    rt = RefServerThread(ref.app).start()
    pt = ServerThread(port.app).start()
    try:
        pages = (_port_client_pages if client == "port"
                 else _reference_client_pages)([rt.url, pt.url])
        (ref_type, ref_page), (port_type, port_page) = pages
        assert port_page == ref_page
        assert port_type == ref_type
        assert "nodes: 2, max volume id: 9" in port_page
    finally:
        within(30, pt.stop)
        within(30, rt.stop)


# ----------------------------------------------------------------------
# the stream's own timers
# ----------------------------------------------------------------------
def test_a_silent_stream_is_pinged_then_dropped(monkeypatch):
    """A stream that stays open but answers no ping is ended as the
    reference's `heartbeat=30` ends it (here at 0.3 s): the node is
    unregistered. One whose client reads (and so answers the pings)
    stays registered with no report at all."""
    from seaweedfs_tpu_torch.server import master_server as port_ms

    monkeypatch.setattr(port_ms, "HEARTBEAT_KEEPALIVE", 0.3)
    ms = MasterServer(pulse_seconds=DEFAULT_PULSE)
    mt = ServerThread(ms.app).start()
    mute = live = None
    try:
        mute, live = (websocket.connect(f"{mt.url}/ws/heartbeat")
                      for _ in range(2))
        for ws, hb in zip((mute, live), _reports()):
            ws.send_json(hb)
        assert live.receive(timeout=10) is not None

        def drain() -> None:            # answers each ping as it reads
            while live.receive() is not None:
                pass

        threading.Thread(target=drain, daemon=True).start()
        _wait(lambda: set(ms.topo.nodes) == {"10.0.0.1:8080",
                                             "10.0.0.2:8080"},
              msg="both registered")
        _wait(lambda: "10.0.0.1:8080" not in ms.topo.nodes, timeout=5,
              msg="the mute stream dropped")
        time.sleep(1.5)                 # five of its ping intervals
        assert set(ms.topo.nodes) == {"10.0.0.2:8080"}
    finally:
        for ws in (mute, live):
            if ws is not None:
                ws.close()
        within(30, mt.stop)


def test_receive_deadline_keeps_the_stream():
    """receive(timeout=) raises socket.timeout at its deadline with the
    stream intact and the socket's own timeout restored; the next
    report is answered on the same stream."""
    import socket

    ms = MasterServer(pulse_seconds=DEFAULT_PULSE)
    mt = ServerThread(ms.app).start()
    ws = None
    try:
        ws = websocket.connect(f"{mt.url}/ws/heartbeat", timeout=7.0)
        start = time.monotonic()
        with pytest.raises(socket.timeout):
            ws.receive(timeout=0.2)
        assert 0.2 <= time.monotonic() - start < 2.0
        assert ws.sock.gettimeout() == 7.0 and not ws.closed
        ws.send_json(_reports()[0])
        reply = ws.receive(timeout=10)
        assert '"pulse_seconds": 5.0' in reply
        assert "10.0.0.1:8080" in ms.topo.nodes
    finally:
        if ws is not None:
            ws.close()
        within(30, mt.stop)


def test_only_the_newest_stream_unregisters_its_node():
    """A server that reconnects before its old stream's end is seen:
    the old stream's end leaves the node registered, the new one's
    drops it."""
    ms = MasterServer(pulse_seconds=DEFAULT_PULSE)
    mt = ServerThread(ms.app).start()
    old = new = None
    try:
        old, new = (websocket.connect(f"{mt.url}/ws/heartbeat")
                    for _ in range(2))
        for ws in (old, new):
            ws.send_json(_reports()[0])
            assert ws.receive(timeout=10) is not None
        old.close()
        _wait(lambda: len(ms._hb_streams) == 1, msg="the old stream's end")
        assert "10.0.0.1:8080" in ms.topo.nodes
        new.close()
        _wait(lambda: "10.0.0.1:8080" not in ms.topo.nodes, timeout=5,
              msg="the newest stream's end")
    finally:
        for ws in (old, new):
            if ws is not None:
                ws.close()
        within(30, mt.stop)
