"""The port's master follower and KeepConnected stream against the JAX
package's (tolerance 0).

* The three cases of tests/test_master_follower.py on the port's
  MasterFollower over a port cluster (tests/torch_port_cases.py rebinds
  them): lookups by volume id and by file id, the stream-fed cache, and
  the 404 / 400 answers.
* KeepConnected across packages: the reference's
  MasterClient(subscribe=True) and the port's, subscribed to one master
  (a port master, then a reference one), hold the same location and
  EC-shard maps from the snapshot on, and again after a /vol/grow and
  after an EC encode mounts 14 shards.
* A KeepConnected subscriber that stops reading blocks neither the
  heartbeats, nor /vol/grow, nor an unregistration: its messages queue, and
  it is dropped once its backlog is full.

Every wait polls for the state it asserts, up to a deadline.
"""
import socket
import time

import pytest

from seaweedfs_tpu.operation import verbs as ref_verbs
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.shell import repl as ref_repl
from seaweedfs_tpu.shell.env import CommandEnv as RefCommandEnv
from seaweedfs_tpu.wdclient.client import MasterClient as RefMasterClient
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.server import master_server
from seaweedfs_tpu_torch.server.master_follower import MasterFollower
from seaweedfs_tpu_torch.shell import repl
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.wdclient.client import MasterClient

from tests import test_master_follower as ref_cases
from tests.torch_port_cases import call_case, port_cases

CASES = port_cases(ref_cases, verbs=verbs, ServerThread=ServerThread,
                   MasterFollower=MasterFollower)


def _wait(pred, timeout=20.0, msg="condition"):
    end = time.monotonic() + timeout
    while True:
        out = pred()
        if out:
            return out
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.05)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference fixture's layout on the port."""
    c = Cluster(str(tmp_path_factory.mktemp("mfol")), n_volume_servers=1,
                volume_size_limit=8 << 20, ec_backend=CudaCodec(device="cpu"))
    mf = MasterFollower(c.master_url)
    t = ServerThread(mf.build_app()).start()
    yield c, mf, t
    mf.client.stop()
    t.stop()
    c.stop()


@pytest.mark.parametrize("case", list(CASES))
def test_master_follower_cases_on_the_port(case, setup):
    call_case(CASES[case], {"setup": setup})


def _maps(client) -> tuple[dict, dict]:
    with client._lock:
        return dict(client._vid_cache), dict(client._ec_cache)


@pytest.mark.parametrize("master", ["port", "reference"])
def test_keepconnected_across_packages(tmp_path, master):
    if master == "port":
        c = Cluster(str(tmp_path), n_volume_servers=2,
                    volume_size_limit=8 << 20,
                    ec_backend=CudaCodec(device="cpu"))
        v, env = verbs, CommandEnv(c.master_url)
        run = repl.run_command
    else:
        c = RefCluster(str(tmp_path), n_volume_servers=2,
                       volume_size_limit=8 << 20, ec_backend="numpy")
        v, env = ref_verbs, RefCommandEnv(c.master_url)
        run = ref_repl.run_command
    clients = []
    try:
        fids = [v.upload_data(c.master_url, bytes([i]) * (1000 + i))
                for i in range(20)]
        vid = int(fids[0].split(",")[0])
        clients = [RefMasterClient(c.master_url, subscribe=True),
                   MasterClient(c.master_url, subscribe=True)]

        def agree(pred):
            maps = [_maps(cl) for cl in clients]
            return pred(maps[0]) and maps[0] == maps[1] and maps[0]

        snap = _wait(lambda: agree(lambda m: vid in m[0]),
                     msg="both snapshots")
        assert snap[1] == {}
        grown = session().get(f"{c.master_url}/vol/grow",
                              params={"collection": "kc"}, timeout=30)
        assert grown.json()["count"] == 1
        after_grow = _wait(lambda: agree(lambda m: len(m[0]) > len(snap[0])),
                           msg="the grow's delta on both")
        assert set(after_grow[0]) - set(snap[0])
        assert run(env, "lock") == "locked"
        run(env, f"ec.encode -volumeId={vid}")
        ec = _wait(lambda: agree(lambda m: vid in m[1] and
                                 len(m[1][vid]) == 14 and
                                 all(loc.get("ec") for loc in m[0][vid])),
                   msg="the EC mount's delta on both")
        assert sorted(ec[1][vid]) == list(range(14))
    finally:
        for cl in clients:
            cl.stop()
        env.close()
        c.stop()


def test_a_stalled_subscriber_blocks_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(master_server, "KEEPCONNECTED_BACKLOG", 8)
    c = Cluster(str(tmp_path), n_volume_servers=2, max_volumes=32,
                volume_size_limit=1 << 20, pulse_seconds=0.2,
                ec_backend=CudaCodec(device="cpu"))
    # a subscriber with a small receive buffer that never reads
    stalled = socket.socket()
    try:
        stalled.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        host, port = c.master_thread.address.split(":")
        stalled.connect((host, int(port)))
        stalled.sendall(
            b"GET /ws/keepconnected HTTP/1.1\r\nHost: x\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
            b"Sec-WebSocket-Version: 13\r\n\r\n")
        master = c.master
        sub = _wait(lambda: next(iter(master._clients), None),
                    msg="the subscriber")
        sub.ws.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        # every grow and every heartbeat queues a delta for it
        for _ in range(24):
            start = time.monotonic()
            grown = session().get(f"{c.master_url}/vol/grow", timeout=30)
            assert grown.json()["count"] == 1
            assert time.monotonic() - start < 5
        _wait(lambda: not master._clients, msg="the subscriber dropped")
        grown = session().get(f"{c.master_url}/vol/grow", timeout=30)
        assert grown.json()["count"] == 1
        # heartbeats still land, and a server whose heartbeat stream
        # ends is still unregistered
        c.volume_threads[1].stop()
        _wait(lambda: len(master.topo.nodes) == 1, msg="the lost server")
    finally:
        stalled.close()
        c.stop()
