"""The port's distributed lock manager, its filer routes and the
shell's admin lock through them, against the JAX package's.

* The cases of tests/test_cluster_dlm.py run unchanged on the port
  (tests/torch_port_cases.py rebinds their names): membership, the lock
  manager, and the HTTP cases on a port master with two port filers.
  Its empty-ring case imports the reference's exception in its body and
  has a port twin here.
* The consistent-hash ring names the same home as the reference's for
  the same filer set; /dlm/lock|find|unlock give the reference filer's
  statuses and JSON (tokens masked) for the same request sequence.
* Each package's DlmClient takes, renews and releases locks on the
  other's filers; a holder on one side refuses the other.
* The shell's `lock` goes through the filer's DLM: a second shell is
  refused until `unlock`; `DlmClient.close()` stops its renewer thread
  and frees the lock.
"""
import threading
import time

import pytest

from seaweedfs_tpu.cluster import lock_manager as ref_dlm
from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.server.master_server import MasterServer as RefMasterServer
from seaweedfs_tpu_torch.cluster import lock_manager as port_dlm
from seaweedfs_tpu_torch.cluster.membership import ClusterMembership
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.shell import repl
from seaweedfs_tpu_torch.shell.env import CommandEnv, ShellError

from tests import test_cluster_dlm as ref_cases
from tests.torch_port_cases import call_case, port_cases

CASES = port_cases(
    ref_cases, DistributedLockManager=port_dlm.DistributedLockManager,
    DlmClient=port_dlm.DlmClient, LockMoved=port_dlm.LockMoved,
    LockNotOwned=port_dlm.LockNotOwned, LockRing=port_dlm.LockRing,
    ClusterMembership=ClusterMembership,
    skip=("TestLockManagerUnit.test_empty_ring_refuses_grants",))


def _wait_rings(master_url: str, filers, n: int) -> None:
    deadline = time.time() + 20
    while time.time() < deadline:
        nodes = session().get(f"{master_url}/cluster/nodes",
                              params={"type": "filer"}, timeout=3).json()
        if len(nodes["nodes"]) == n and \
                all(len(f.dlm.ring.servers()) == n for f in filers):
            return
        time.sleep(0.05)
    raise TimeoutError("filers never formed their lock ring")


def _start(master_cls, filer_cls, thread_cls, n: int):
    master = master_cls(pulse_seconds=0.4)
    mt = thread_cls(master.app).start()
    filers, threads = [], [mt]
    for _ in range(n):
        f = filer_cls(mt.url, announce_pulse=0.3)
        t = thread_cls(f.app).start()
        f.address = t.address
        filers.append(f)
        threads.append(t)
    _wait_rings(mt.url, filers, n)
    return {"master": mt, "filers": filers,
            "filer_urls": [t.address for t in threads[1:]],
            "threads": threads}


def _stop(c) -> None:
    for t in reversed(c["threads"]):
        t.stop()


@pytest.fixture(scope="module")
def dlm_cluster():
    """A port master with two port filers announcing membership."""
    c = _start(MasterServer, FilerServer, ServerThread, 2)
    yield c
    _stop(c)


@pytest.fixture(scope="module")
def ref_dlm_cluster():
    c = _start(RefMasterServer, RefFilerServer, RefServerThread, 2)
    yield c
    _stop(c)


UNIT = [k for k in CASES if not k.startswith("TestDlmOverHttp.")]
HTTP = [k for k in CASES if k.startswith("TestDlmOverHttp.")]


@pytest.mark.parametrize("case", UNIT)
def test_dlm_unit_cases_on_the_port(case):
    call_case(CASES[case], {})


@pytest.mark.parametrize("case", HTTP)
def test_dlm_http_cases_on_the_port(case, dlm_cluster):
    """The reference's HTTP cases against the port's filers (its
    shell-env case drives the reference's CommandEnv against them)."""
    call_case(CASES[case], {"dlm_cluster": dlm_cluster})


def test_empty_ring_refuses_grants():
    dlm = port_dlm.DistributedLockManager("me")
    with pytest.raises(port_dlm.RingEmpty):
        dlm.lock("job1", owner="alice")
    with pytest.raises(port_dlm.RingEmpty):
        dlm.find_owner("job1")


@pytest.mark.parametrize("servers", [
    ["a:1"], ["127.0.0.1:8888", "127.0.0.1:8889"],
    ["f1:1", "f2:2", "f3:3", "f4:4", "f5:5"]])
def test_ring_homes_equal_to_the_reference(servers):
    pr, rr = port_dlm.LockRing(), ref_dlm.LockRing()
    pr.set_servers(servers)
    rr.set_servers(servers)
    names = ["admin"] + [f"lock-{i}" for i in range(300)]
    assert [pr.owner_of(n) for n in names] == [rr.owner_of(n) for n in names]
    assert pr.servers() == rr.servers()


def _wire(filer_url: str) -> list:
    """One request sequence against a single-filer ring; tokens masked
    by the order they were handed out."""
    seq = [("lock", {"name": "x", "owner": "alice", "ttl": 30}),
           ("lock", {"name": "x", "owner": "bob", "ttl": 30}),
           ("find", {"name": "x"}),
           ("lock", {"name": "x", "owner": "alice", "token": "$0"}),
           ("lock", {"name": "x", "owner": "alice", "token": "nope"}),
           ("unlock", {"name": "x", "token": "wrong"}),
           ("unlock", {"name": "x", "token": "$0"}),
           ("find", {"name": "x"}),
           ("unlock", {"name": "x", "token": "$0"}),
           ("lock", {"owner": "nobody"}),
           ("find", {"name": "never"})]
    tokens, out = [], []
    for verb, body in seq:
        body = {k: (tokens[int(v[1:])] if isinstance(v, str)
                    and v.startswith("$") else v) for k, v in body.items()}
        r = session().post(f"{filer_url}/dlm/{verb}", json=body, timeout=10)
        d = r.json()
        if "token" in d:
            if d["token"] not in tokens:
                tokens.append(d["token"])
            d["token"] = f"${tokens.index(d['token'])}"
        out.append((r.status_code, d))
    return out


def test_dlm_wire_equal_to_the_reference():
    port_c = _start(MasterServer, FilerServer, ServerThread, 1)
    ref_c = _start(RefMasterServer, RefFilerServer, RefServerThread, 1)
    try:
        got = _wire(f"http://{port_c['filer_urls'][0]}")
        want = _wire(f"http://{ref_c['filer_urls'][0]}")
        assert got == want
        assert [s for s, _ in got] == [200, 403, 200, 200, 403, 403, 200,
                                       200, 200, 400, 200]
    finally:
        _stop(port_c)
        _stop(ref_c)


@pytest.mark.parametrize("client,cluster", [
    ("port", "ref_dlm_cluster"), ("ref", "dlm_cluster")])
def test_each_client_against_the_other_filers(client, cluster, request):
    c = request.getfixturevalue(cluster)
    mod = port_dlm if client == "port" else ref_dlm
    other = ref_dlm if client == "port" else port_dlm
    a = mod.DlmClient(c["filer_urls"], owner="worker-a", ttl=0.6)
    b = other.DlmClient(c["filer_urls"], owner="worker-b")
    try:
        a.lock("cross-vol-3")
        assert a.is_held("cross-vol-3")
        with pytest.raises(RuntimeError, match="held by"):
            b.lock("cross-vol-3")
        assert b.find_owner("cross-vol-3") == "worker-a"
        time.sleep(1.0)         # past the TTL: the renewer kept it
        assert b.find_owner("cross-vol-3") == "worker-a"
        a.unlock("cross-vol-3")
        b.lock("cross-vol-3")
        assert a.find_owner("cross-vol-3") == "worker-b"
    finally:
        a.close()
        b.close()


def test_shell_lock_through_the_filer_refuses_a_second_shell(dlm_cluster):
    master = dlm_cluster["master"].url
    env = CommandEnv(master, filer_url=f"http://{dlm_cluster['filer_urls'][0]}")
    env2 = CommandEnv(master,
                      filer_url=f"http://{dlm_cluster['filer_urls'][1]}")
    try:
        assert repl.run_command(env, "lock") == "locked"
        env.confirm_locked()
        probe = port_dlm.DlmClient(dlm_cluster["filer_urls"])
        assert probe.find_owner(CommandEnv.ADMIN_LOCK) == "shell"
        with pytest.raises(ShellError, match="cannot acquire admin lock"):
            repl.run_command(env2, "lock")
        assert repl.run_command(env, "unlock") == "unlocked"
        assert probe.find_owner(CommandEnv.ADMIN_LOCK) is None
        assert repl.run_command(env2, "lock") == "locked"
    finally:
        env.close()
        env2.close()
    assert probe.find_owner(CommandEnv.ADMIN_LOCK) is None


def test_close_stops_the_renewer_and_frees_the_lock(dlm_cluster):
    c = port_dlm.DlmClient(dlm_cluster["filer_urls"], owner="closer",
                           ttl=0.3)
    c.lock("closing")
    renewer = c._renewer
    assert renewer is not None and renewer.is_alive()
    c.close()
    assert not renewer.is_alive()
    assert not any(t is renewer for t in threading.enumerate())
    assert port_dlm.DlmClient(dlm_cluster["filer_urls"]).find_owner(
        "closing") is None


def test_without_a_filer_the_lock_is_process_local():
    env = CommandEnv("http://127.0.0.1:1")
    env.acquire_lock()
    env.confirm_locked()
    assert env._dlm is None
    env.close()
    assert not env.locked
