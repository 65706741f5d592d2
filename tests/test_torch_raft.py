"""The port's raft (seaweedfs_tpu_torch/master/raft.py, on threads)
against the JAX package's (asyncio), tolerance 0.

* The seven cases of tests/test_raft.py on the port's RaftNode with its
  MemoryTransport: single-node election, a 3-node commit, failover that
  keeps committed state, a lagging follower catching up, restart from
  the state directory, log compaction with restart from the snapshot,
  and InstallSnapshot to a follower left behind.
* A state directory written by either package loads in the other: the
  same term, vote, peers, snapshot and log, and a restarted node of the
  other package comes back with the same max volume id.
* A mixed quorum over HTTP (each package's MasterServer with raft):
  two reference masters with one port master, and one reference master
  with two port masters, elect one leader that every master names and
  commit a max_volume_id that reaches all three.
* A leader cut off from the other two: they elect another, and the
  port's old leader steps down (check-quorum); the reference's stays
  leader of its old term, the gap logged in ROADMAP Queue 3.

Every wait polls for the state it asserts, up to a deadline.
"""
import asyncio
import json
import os
import time

import pytest

from seaweedfs_tpu.master import raft as ref_raft
from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu_torch.master.raft import (LEADER, MemoryTransport,
                                             RaftNode)
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server.cluster import free_ports
from seaweedfs_tpu_torch.server.master_server import MasterServer

TICK = 0.5  # raft timeouts scaled down for test speed


def make_cluster(n, tmp_path=None, tick=TICK):
    transport = MemoryTransport()
    names = [f"m{i}" for i in range(n)]
    nodes = []
    for name in names:
        node = RaftNode(name, names, transport,
                        state_dir=str(tmp_path) if tmp_path else None,
                        tick=tick)
        transport.register(node)
        nodes.append(node)
    return transport, nodes


def wait_for(pred, timeout=5.0, msg="condition"):
    end = time.monotonic() + timeout
    while True:
        out = pred()
        if out:
            return out
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.01)


def wait_for_leader(nodes, timeout=5.0):
    def stable():
        leaders = [n for n in nodes if n.state == LEADER]
        if len(leaders) == 1 and all(
                n.leader() == leaders[0].me for n in nodes
                if n is not leaders[0] and n.leader() is not None):
            return leaders[0]
        return None
    return wait_for(stable, timeout, "a stable leader")


def stop_all(nodes):
    for n in nodes:
        n.stop()


# ----------------------------------------------------------------------
# tests/test_raft.py's seven cases on the port
# ----------------------------------------------------------------------
def test_single_node_self_elects():
    _, nodes = make_cluster(1)
    nodes[0].start()
    try:
        leader = wait_for_leader(nodes)
        assert leader is nodes[0]
        assert leader.propose({"op": "max_volume_id", "value": 7})
        assert leader.fsm.max_volume_id == 7
    finally:
        stop_all(nodes)


def test_three_node_election_and_commit():
    _, nodes = make_cluster(3)
    for n in nodes:
        n.start()
    try:
        leader = wait_for_leader(nodes)
        assert leader.propose({"op": "max_volume_id", "value": 42})
        wait_for(lambda: all(n.fsm.max_volume_id == 42 for n in nodes),
                 3, "42 on every FSM")
    finally:
        stop_all(nodes)


def test_leader_failure_reelection_preserves_state():
    transport, nodes = make_cluster(3)
    for n in nodes:
        n.start()
    rest = nodes
    try:
        leader = wait_for_leader(nodes)
        assert leader.propose({"op": "max_volume_id", "value": 10})
        transport.partitioned.add(leader.me)
        leader.stop()
        rest = [n for n in nodes if n is not leader]
        new_leader = wait_for_leader(rest)
        assert new_leader is not leader
        # committed state survived (applied once the new leader's no-op
        # commits)
        wait_for(lambda: new_leader.fsm.max_volume_id == 10, 3,
                 "10 at the new leader")
        assert new_leader.propose({"op": "max_volume_id", "value": 11})
    finally:
        stop_all(rest)


def test_lagging_follower_catches_up():
    transport, nodes = make_cluster(3)
    for n in nodes:
        n.start()
    try:
        leader = wait_for_leader(nodes)
        lagger = [n for n in nodes if n is not leader][0]
        transport.partitioned.add(lagger.me)
        for v in (1, 2, 3):
            assert leader.propose({"op": "max_volume_id", "value": v})
        transport.partitioned.discard(lagger.me)
        wait_for(lambda: lagger.fsm.max_volume_id == 3, 3,
                 "the lagger at 3")
    finally:
        stop_all(nodes)


def test_persistence_across_restart(tmp_path):
    _, nodes = make_cluster(1, tmp_path=tmp_path)
    nodes[0].start()
    leader = wait_for_leader(nodes)
    assert leader.propose({"op": "max_volume_id", "value": 99})
    nodes[0].stop()

    transport2 = MemoryTransport()
    node2 = RaftNode("m0", ["m0"], transport2, state_dir=str(tmp_path),
                     tick=TICK)
    transport2.register(node2)
    assert {"op": "max_volume_id", "value": 99} in \
        [e.command for e in node2.log]
    node2.start()
    try:
        leader2 = wait_for_leader([node2])
        wait_for(lambda: leader2.fsm.max_volume_id == 99, 3, "99 again")
    finally:
        node2.stop()


def test_log_compaction_and_snapshot_restart(tmp_path):
    transport = MemoryTransport()
    node = RaftNode("m0", ["m0"], transport, state_dir=str(tmp_path),
                    tick=TICK, compact_threshold=8)
    transport.register(node)
    node.start()
    leader = wait_for_leader([node])
    for v in range(1, 41):
        assert leader.propose({"op": "max_volume_id", "value": v})
    assert leader.fsm.max_volume_id == 40
    assert len(leader.log) <= 8 + 1, \
        f"log not compacted: {len(leader.log)} entries"
    assert leader.snap_index > 0
    node.stop()

    snap_covered = leader.snap_index
    node2 = RaftNode("m0", ["m0"], transport, state_dir=str(tmp_path),
                     tick=TICK, compact_threshold=8)
    assert node2.snap_index == snap_covered
    assert node2.fsm.max_volume_id >= snap_covered - 1  # noop offset
    assert node2.last_applied == node2.snap_index
    assert len(node2.log) <= 8 + 1
    transport.register(node2)
    node2.start()
    try:
        leader2 = wait_for_leader([node2])
        assert leader2.barrier()
        assert leader2.fsm.max_volume_id == 40  # tail re-committed
        assert leader2.propose({"op": "max_volume_id", "value": 41})
        assert leader2.fsm.max_volume_id == 41
    finally:
        node2.stop()


def test_install_snapshot_to_lagging_follower():
    transport, nodes = make_cluster(3)
    for n in nodes:
        n.compact_threshold = 4
        n.start()
    try:
        leader = wait_for_leader(nodes)
        lagger = next(n for n in nodes if n is not leader)
        transport.partitioned.add(lagger.me)
        for v in range(1, 31):
            assert leader.propose({"op": "max_volume_id", "value": v})
        assert leader.snap_index > len(lagger.log), \
            "setup: leader must have compacted past the lagger"
        transport.partitioned.discard(lagger.me)
        wait_for(lambda: lagger.fsm.max_volume_id == 30, 5,
                 "the lagger restored by InstallSnapshot")
        assert lagger.snap_index >= leader.snap_index - 4
        assert leader.propose({"op": "max_volume_id", "value": 31})
        wait_for(lambda: lagger.fsm.max_volume_id == 31, 3,
                 "the healed follower at 31")
    finally:
        stop_all(nodes)


# ----------------------------------------------------------------------
# a leader cut off from the other masters
# ----------------------------------------------------------------------
def _cut_off_leader_port() -> bool:
    """Partition a 3-node port cluster's leader (it keeps running);
    whether it still leads once the others elected a new leader and a
    longest election window has passed since."""
    transport, nodes = make_cluster(3)
    for n in nodes:
        n.start()
    try:
        leader = wait_for_leader(nodes)
        transport.partitioned.add(leader.me)
        wait_for_leader([n for n in nodes if n is not leader])
        wait_for(lambda: leader.state != LEADER, 5,
                 "the cut-off leader's step-down")
        time.sleep(0.3 * TICK)
        return leader.state == LEADER
    finally:
        stop_all(nodes)


def _cut_off_leader_reference() -> bool:
    async def run():
        tr = ref_raft.MemoryTransport()
        names = [f"m{i}" for i in range(3)]
        nodes = [ref_raft.RaftNode(m, names, tr, tick=TICK) for m in names]
        for n in nodes:
            tr.register(n)
            n.start()

        async def leader_of(group):
            end = time.monotonic() + 5
            while True:
                leaders = [n for n in group if n.state == ref_raft.LEADER]
                if len(leaders) == 1:
                    return leaders[0]
                assert time.monotonic() < end, "no reference leader"
                await asyncio.sleep(0.01)
        try:
            leader = await leader_of(nodes)
            tr.partitioned.add(leader.me)
            await leader_of([n for n in nodes if n is not leader])
            await asyncio.sleep(0.3 * TICK)
            return leader.state == ref_raft.LEADER
        finally:
            for n in nodes:
                await n.stop()
    return asyncio.run(run())


@pytest.mark.parametrize("package", ["reference", "port"])
def test_cut_off_leader_steps_down(package):
    still_leads = (_cut_off_leader_reference() if package == "reference"
                   else _cut_off_leader_port())
    assert still_leads == (package == "reference")


# ----------------------------------------------------------------------
# a state directory written by one package loads in the other
# ----------------------------------------------------------------------
def _sidecar(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _write_with_port(tmp_path, values) -> None:
    node = RaftNode("127.0.0.1:7001", ["127.0.0.1:7001"],
                    MemoryTransport(), state_dir=str(tmp_path), tick=TICK,
                    compact_threshold=4)
    node.transport.register(node)
    node.start()
    try:
        wait_for_leader([node])
        for v in values:
            assert node.propose({"op": "max_volume_id", "value": v})
    finally:
        node.stop()


def _write_with_reference(tmp_path, values) -> None:
    async def run():
        tr = ref_raft.MemoryTransport()
        node = ref_raft.RaftNode("127.0.0.1:7001", ["127.0.0.1:7001"], tr,
                                 state_dir=str(tmp_path), tick=TICK,
                                 compact_threshold=4)
        tr.register(node)
        node.start()
        end = time.monotonic() + 5
        while node.state != ref_raft.LEADER:
            assert time.monotonic() < end, "reference node never led"
            await asyncio.sleep(0.01)
        for v in values:
            assert await node.propose({"op": "max_volume_id", "value": v})
        await node.stop()
    asyncio.run(run())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_dir_loads_across_packages(tmp_path, writer):
    values = [3, 9, 5, 12, 11, 20, 17]
    (_write_with_reference if writer == "reference"
     else _write_with_port)(tmp_path, values)
    [path] = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)
              if f.endswith(".json")]
    assert os.path.basename(path) == "raft_127.0.0.1_7001.json"
    disk = _sidecar(path)
    assert set(disk) == {"term", "voted_for", "peers", "snapshot", "log"}
    assert disk["snapshot"]["index"] > 0        # compacted at 4

    ref_node = ref_raft.RaftNode("127.0.0.1:7001", ["127.0.0.1:7001"],
                                 ref_raft.MemoryTransport(),
                                 state_dir=str(tmp_path), tick=TICK)
    port_node = RaftNode("127.0.0.1:7001", ["127.0.0.1:7001"],
                         MemoryTransport(), state_dir=str(tmp_path),
                         tick=TICK)
    for attr in ("current_term", "voted_for", "peers", "snap_index",
                 "snap_term", "snap_fsm", "commit_index", "last_applied"):
        assert getattr(port_node, attr) == getattr(ref_node, attr), attr
    assert [e.to_json() for e in port_node.log] == \
        [e.to_json() for e in ref_node.log]
    assert port_node.fsm.to_dict() == ref_node.fsm.to_dict()
    # the port, restarted on the directory, recommits the tail
    port_node.transport.register(port_node)
    port_node.start()
    try:
        wait_for_leader([port_node])
        assert port_node.barrier()
        assert port_node.fsm.max_volume_id == max(values)
    finally:
        port_node.stop()
    # and the file it leaves is one the reference reads back
    again = ref_raft.RaftNode("127.0.0.1:7001", ["127.0.0.1:7001"],
                              ref_raft.MemoryTransport(),
                              state_dir=str(tmp_path), tick=TICK)
    assert again.current_term == port_node.current_term
    assert [e.to_json() for e in again.log] == \
        [e.to_json() for e in port_node.log]


# ----------------------------------------------------------------------
# a mixed quorum over HTTP
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kinds", [("reference", "reference", "port"),
                                   ("reference", "port", "port")],
                         ids=["2ref+1port", "1ref+2port"])
def test_mixed_quorum_over_http(tmp_path, kinds):
    ports = free_ports(3)
    peers = [f"127.0.0.1:{p}" for p in ports]
    masters, threads = [], []
    try:
        for kind, me, port in zip(kinds, peers, ports):
            cls, thread = ((RefMaster, RefServerThread)
                           if kind == "reference"
                           else (MasterServer, ServerThread))
            m = cls(pulse_seconds=0.4, me=me, peers=peers,
                    raft_state_dir=str(tmp_path), raft_tick=2.0)
            masters.append(m)
            threads.append(thread(m.app, port=port).start())

        def status():
            out = []
            for p in peers:
                try:
                    out.append(session().get(f"http://{p}/raft/status",
                                             timeout=2).json())
                except OSError:
                    return None
            return out

        def stable():
            st = status()
            if st is None:
                return None
            leaders = [s["me"] for s in st if s["state"] == "leader"]
            named = {s["leader"] for s in st}
            if len(leaders) == 1 and named == {leaders[0]}:
                return leaders[0]
            return None

        leader = wait_for(stable, 20, "one leader every master names")
        i = peers.index(leader)
        node = masters[i].raft
        cmd = {"op": "max_volume_id", "value": 77}
        if kinds[i] == "reference":
            ok = asyncio.run_coroutine_threadsafe(
                node.propose(cmd), threads[i].loop).result(15)
        else:
            ok = node.propose(cmd)
        assert ok
        wait_for(lambda: (st := status()) is not None and
                 [s["max_volume_id"] for s in st] == [77, 77, 77],
                 10, "77 committed on all three")
        # and applied into every master's topology high-water mark
        wait_for(lambda: all(m.topo.max_volume_id == 77 for m in masters),
                 10, "77 in every topology")
        terms = {s["term"] for s in status()}
        assert len(terms) == 1
    finally:
        for t in threads:
            t.stop()
