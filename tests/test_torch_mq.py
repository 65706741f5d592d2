"""The port's mq broker and the shell's mq.topic.* against the JAX
package's, with tolerance 0 (each record's `ts` masked).

* The cases of tests/test_mq.py run `[reference]` on the JAX package's
  cluster and broker and `[port]` on the port's (topic lifecycle,
  partitioned publish, replay and follow, a flush, a restart, the
  shell's commands).
* Over each package's filer, a reference broker and a port broker given
  the same records: the same partition for the same key (md5, and the
  round-robin for empty keys), the same acks, segment files of the same
  names (`seg-%020d` under /topics/<ns>/<name>/p<k>/) holding the same
  record lines, the same topic.conf; a non-UTF-8 value sent as
  `value64` comes back as `v64`.
* Subscriptions replay across a flush into the live tail, resume from
  an offset, stop at `limit` and follow a publish made while they wait,
  alike in both brokers.
* Offsets carry over a broker's restart onto either package's broker
  over the same filer, and the replay after it is the same.
* `mq.topic.create / list / describe / delete` from either package's
  shell against either package's broker give the same answers.
* The reference's regression case of an empty batch runs on both
  brokers; a request reaching a starting broker waits for its topics.
* Both packages' brokers announce every 3 s while the membership drops
  a node after 3 master pulses: at the clusters' 0.4 s pulse a broker
  is listed for 1.2 s of every 3 (ROADMAP Queue 3 item 10, shared), so
  the shell commands here wait for a listing before each command.
"""
import base64
import functools
import hashlib
import json
import threading
import time

import numpy as np
import pytest
import requests

from seaweedfs_tpu.mq.broker import BrokerServer as RefBroker
from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.shell.env import ShellError as RefShellError
from seaweedfs_tpu.shell.repl import run_command as ref_run
from seaweedfs_tpu_torch.mq import broker as port_broker
from seaweedfs_tpu_torch.mq.broker import BrokerServer
from seaweedfs_tpu_torch.rpc import http as port_http
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell.env import CommandEnv, ShellError
from seaweedfs_tpu_torch.shell.repl import run_command

from tests import test_mq as ref_cases
from tests import test_review_regressions2 as ref_regressions
from tests.torch_port_cases import port_cases, run_case, swap_modules, within

SEED = 20261018
PortCluster = functools.partial(Cluster, ec_backend="native")
PKG = {"reference": dict(Cluster=RefCluster, Broker=RefBroker,
                         Thread=RefServerThread, Env=RefEnv, run=ref_run,
                         ShellError=RefShellError),
       "port": dict(Cluster=PortCluster, Broker=BrokerServer,
                    Thread=ServerThread, Env=CommandEnv, run=run_command,
                    ShellError=ShellError)}
SIDES = {"reference": port_cases(ref_cases),
         "port": port_cases(ref_cases, Cluster=PortCluster,
                            CommandEnv=CommandEnv, run_command=run_command)}
CASES = list(SIDES["port"])


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """A reference and a port cluster with a filer each."""
    out = {}
    try:
        for side, p in PKG.items():
            out[side] = within(60, p["Cluster"],
                               str(tmp_path_factory.mktemp(f"mq_{side}")),
                               n_volume_servers=1,
                               volume_size_limit=16 << 20, with_filer=True)
        yield out
    finally:
        for c in out.values():
            within(60, c.stop)


@pytest.fixture(scope="module")
def case_clusters(tmp_path_factory):
    """The reference case file's cluster, one per package, each with its
    broker."""
    out = {}
    try:
        for side, p in PKG.items():
            c = within(60, p["Cluster"],
                       str(tmp_path_factory.mktemp(f"mq_cases_{side}")),
                       n_volume_servers=1, volume_size_limit=16 << 20,
                       with_filer=True)
            out[side] = c
            c.start_broker()
        yield out
    finally:
        for c in out.values():
            within(60, c.stop)


def test_every_reference_case_is_mirrored():
    assert CASES == list(SIDES["reference"])
    assert len(CASES) == 9


def _fresh_listing(master: str, within_s: float = 0.3) -> None:
    """Wait for a broker listed by an announce at most `within_s` old:
    each announce lists it anew (its `createdAt`) for 3 master pulses
    (Queue 3 item 10)."""
    end = time.monotonic() + 15
    while time.monotonic() < end:
        nodes = requests.get(f"{master}/cluster/nodes", params={
            "type": "broker"}, timeout=10).json()["nodes"]
        if nodes and time.time() - nodes[0]["createdAt"] < within_s:
            return
        time.sleep(0.02)
    raise AssertionError("no broker announced itself in 15 s")


# side-major: each package's cases run in the reference file's order
@pytest.mark.parametrize("side,case", [(s, c) for s in PKG for c in CASES])
def test_reference_mq_cases(side, case, case_clusters):
    if case.startswith("TestShell."):
        # the shell finds the broker through the membership, which
        # lists it only part of the time at this pulse
        _fresh_listing(case_clusters[side].master_url)
    run_case(SIDES[side][case], {"cluster": case_clusters[side]})


class _Brokers:
    """A reference and a port broker over one filer (no master)."""

    def __init__(self, filer_url: str):
        self.filer_url = filer_url
        self.threads = {}
        self.brokers = {}
        for side in PKG:
            self.start(side, side)

    def start(self, name: str, side: str) -> str:
        b = PKG[side]["Broker"](self.filer_url)
        t = PKG[side]["Thread"](b.app).start()
        b.address = t.address
        self.brokers[name], self.threads[name] = b, t
        return t.url

    def stop(self, name: str) -> None:
        within(30, self.threads.pop(name).stop)
        self.brokers.pop(name)

    def url(self, name: str) -> str:
        return self.threads[name].url

    def close(self) -> None:
        for name in list(self.threads):
            self.stop(name)


@pytest.fixture()
def brokers(request, clusters):
    b = _Brokers(clusters[request.param].filer_url)
    yield b
    b.close()


def _records(n: int, salt: int) -> list[dict]:
    """Seeded records: keys from 64, an empty key every 7th (the
    round-robin), 16 B-8 KiB values, every 5th not UTF-8 (value64)."""
    rng = np.random.default_rng([SEED, salt])
    out = []
    for i in range(n):
        key = "" if i % 7 == 3 else f"key-{int(rng.integers(64))}"
        size = int(np.exp(rng.uniform(np.log(16), np.log(8192))))
        if i % 5 == 0:
            out.append({"key": key, "value64": base64.b64encode(
                b"\xff" + rng.bytes(size)).decode()})
        else:
            out.append({"key": key, "value": "v" * size})
    return out


def _publish(url: str, topic: str, records: list[dict]) -> list[dict]:
    r = requests.post(f"{url}/topics/default/{topic}/publish",
                      json={"records": records}, timeout=60)
    assert r.status_code == 200, r.text
    return r.json()["acks"]


def _flushed(broker, within_s: float = 20.0) -> None:
    end = time.monotonic() + within_s
    while any(p.tail for p in list(broker.parts.values())):
        assert time.monotonic() < end, "the broker never flushed"
        time.sleep(0.05)


def _segments(filer: str, topic: str, parts: int) -> dict:
    """{partition: [(segment name, [record lines, ts masked])]}"""
    out = {}
    for p in range(parts):
        d = f"/topics/default/{topic}/p{p}"
        r = requests.get(filer + d, headers={"Accept": "application/json"},
                         params={"limit": "10000"}, timeout=30)
        names = sorted(e["full_path"].rsplit("/", 1)[1]
                       for e in r.json().get("entries", []))
        out[p] = []
        for name in names:
            body = requests.get(f"{filer}{d}/{name}", timeout=30).content
            lines = []
            for line in body.splitlines():
                rec = json.loads(line)
                assert isinstance(rec.pop("ts"), int)
                lines.append(rec)
            assert body.endswith(b"\n")
            out[p].append((name, lines))
    return out


@pytest.mark.parametrize("brokers", list(PKG), indirect=True)
def test_same_records_same_acks_and_segments(brokers):
    topic = {side: f"seg-{side}" for side in PKG}
    for side in PKG:
        r = requests.post(f"{brokers.url(side)}/topics/default/"
                          f"{topic[side]}", json={"partitions": 4},
                          timeout=30)
        assert r.status_code == 201 and r.json() == {
            "namespace": "default", "name": topic[side], "partitions": 4}
    acks = {side: [] for side in PKG}
    # batches that flush on age and on the record count (> 256 in one
    # partition)
    hot = [{"key": "hot", "value": f"h{i}"} for i in range(300)]
    for batch in (_records(40, 1), _records(400, 2), hot,
                  [{"key": "", "value": "rr"}] * 9, _records(3, 3)):
        for side in PKG:
            acks[side] += _publish(brokers.url(side), topic[side], batch)
        for side in PKG:
            _flushed(brokers.brokers[side])
    assert acks["port"] == acks["reference"]
    assert len(acks["port"]) == 40 + 400 + 300 + 9 + 3
    segs = {side: _segments(brokers.filer_url, topic[side], 4)
            for side in PKG}
    assert segs["port"] == segs["reference"]
    assert sum(len(v) for v in segs["port"].values()) >= 12
    for p, files in segs["port"].items():
        offsets = [r["o"] for _, lines in files for r in lines]
        assert offsets == list(range(len(offsets)))
        for name, lines in files:
            assert name == f"seg-{lines[0]['o']:020d}"
    v64 = [r for files in segs["port"].values() for _, lines in files
           for r in lines if "v64" in r]
    assert len(v64) == 40 // 5 + 400 // 5 + 1
    for side in PKG:
        r = requests.post(f"{brokers.url(side)}/topics/default/"
                          f"{topic[side]}/publish", json={"records": [
                              {"key": "k", "value": "b" * 8192}] * 130},
                          timeout=30)
        assert r.status_code == 413
    confs = {side: requests.get(f"{brokers.filer_url}/topics/default/"
                                f"{topic[side]}/topic.conf",
                                timeout=30).content for side in PKG}
    assert confs["port"] == confs["reference"].replace(b"seg-reference",
                                                       b"seg-port")


def _subscribe(url: str, topic: str, partition: int, **params) -> list:
    r = requests.get(f"{url}/topics/default/{topic}/subscribe",
                     params={"partition": partition, "idle_timeout": 0.3,
                             **params}, timeout=60)
    assert r.status_code == 200, r.text
    assert r.headers["Content-Type"].startswith("application/x-ndjson")
    out = []
    for line in r.text.splitlines():
        rec = json.loads(line)
        rec.pop("ts")
        out.append(rec)
    return out


@pytest.mark.parametrize("brokers", list(PKG), indirect=True)
def test_subscriptions_replay_resume_limit_and_follow(brokers):
    got = {}
    for side in PKG:
        url, topic = brokers.url(side), f"sub-{side}"
        requests.post(f"{url}/topics/default/{topic}",
                      json={"partitions": 2}, timeout=30)
        _publish(url, topic, _records(300, 4))
        _flushed(brokers.brokers[side])
        _publish(url, topic, _records(50, 5))      # stays in the tail
        runs = [_subscribe(url, topic, p, **q) for p in range(2)
                for q in ({}, {"offset": 17}, {"offset": 3, "limit": 11},
                          {"offset": 10 ** 6})]
        # a subscriber waiting at the tail gets a record published later
        out = {}

        hot = int(hashlib.md5(b"key-0").hexdigest(), 16) % 2

        def follow():
            out["recs"] = _subscribe(url, topic, hot,
                                     offset=runs[4 * hot][-1]["o"] + 1,
                                     idle_timeout=5, limit=1)

        t = threading.Thread(target=follow)
        t.start()
        time.sleep(0.5)
        _publish(url, topic, [{"key": "key-0", "value": "late"}])
        t.join(30)
        runs.append(out.get("recs"))
        bad = requests.get(f"{url}/topics/default/{topic}/subscribe",
                           params={"partition": 7}, timeout=30)
        runs.append((bad.status_code, bad.json()))
        missing = requests.get(f"{url}/topics/default/nope/subscribe",
                               timeout=30)
        runs.append((missing.status_code, missing.json()))
        got[side] = runs
    assert got["port"] == got["reference"]
    runs = got["port"]
    assert sum(len(runs[i]) for i in (0, 4)) == 350
    assert len(runs[2]) == 11 and runs[3] == []
    assert runs[8] is not None and runs[8][0]["v"] == "late"
    assert runs[9][0] == 400 and runs[10][0] == 404


@pytest.mark.parametrize("first,second",
                         [(a, b) for a in PKG for b in PKG])
def test_offsets_survive_a_restart_onto_either_broker(first, second,
                                                      clusters):
    b = _Brokers.__new__(_Brokers)
    b.filer_url, b.threads, b.brokers = clusters["port"].filer_url, {}, {}
    topic = f"rs-{first[:3]}-{second[:3]}"
    try:
        url = b.start("a", first)
        requests.post(f"{url}/topics/default/{topic}",
                      json={"partitions": 3}, timeout=30)
        acks1 = _publish(url, topic, _records(400, 6))
        before = requests.get(f"{url}/topics/default/{topic}",
                              timeout=30).json()
        replay1 = [_subscribe(url, topic, p) for p in range(3)]
        b.stop("a")             # a clean stop flushes the tail
        url = b.start("b", second)
        after = requests.get(f"{url}/topics/default/{topic}",
                             timeout=30).json()
        assert after == before
        assert [s["next_offset"] for s in after["state"]] == [
            sum(1 for a in acks1 if a["partition"] == p) for p in range(3)]
        assert [_subscribe(url, topic, p) for p in range(3)] == replay1
        acks2 = _publish(url, topic, _records(60, 7))
        for p in range(3):
            new = [a["offset"] for a in acks2 if a["partition"] == p]
            assert new == list(range(after["state"][p]["next_offset"],
                                     after["state"][p]["next_offset"] +
                                     len(new)))
    finally:
        b.close()


def _listed(master: str) -> bool:
    return bool(requests.get(f"{master}/cluster/nodes",
                             params={"type": "broker"},
                             timeout=10).json()["nodes"])


def _shell(side: str, env, line: str):
    """A shell command, run again while the membership lists no broker
    (the broker drops out between its announces, Queue 3 item 10)."""
    end = time.monotonic() + 15
    while True:
        try:
            return PKG[side]["run"](env, line)
        except PKG[side]["ShellError"] as e:
            if "no mq broker registered" not in str(e) or \
                    time.monotonic() > end:
                raise
            time.sleep(0.05)


@pytest.mark.parametrize("broker_side", list(PKG))
def test_shell_commands_from_both_shells(broker_side, clusters):
    c = clusters["port"]
    p = PKG[broker_side]
    b = p["Broker"](c.filer_url, c.master_url)
    t = p["Thread"](b.app).start()
    b.address = t.address
    envs = {side: PKG[side]["Env"](c.master_url, filer_url=c.filer_url)
            for side in PKG}
    try:
        got = {}
        for side, env in envs.items():
            name = f"sh-{broker_side[:3]}-{side[:3]}"
            out = [_shell(side, env,
                          f"mq.topic.create -topic={name} -partitions=3"),
                   _shell(side, env, f"mq.topic.create ns2/{name}"),
                   _shell(side, env, f"mq.topic.describe -topic={name}"),
                   sorted((x["namespace"], x["name"]) for x in
                          _shell(side, env, "mq.topic.list")["topics"]
                          if x["name"] == name),
                   _shell(side, env, f"mq.topic.delete -topic={name}"),
                   _shell(side, env,
                          f"mq.topic.delete -namespace=ns2 -topic={name}")]
            for line in (f"mq.topic.describe -topic={name}",
                         f"mq.topic.create -topic={name} -partitions=0"):
                try:
                    _shell(side, env, line)
                    out.append("answered")
                except PKG[side]["ShellError"] as e:
                    out.append(type(e).__name__ + ": " + str(e).split(":")[0])
            got[side] = json.loads(json.dumps(out).replace(
                name, "NAME"))
        assert got["port"] == got["reference"]
        assert got["port"][2]["state"] == [
            {"partition": i, "next_offset": 0} for i in range(3)]
        assert got["port"][3] == [["default", "NAME"], ["ns2", "NAME"]]
    finally:
        for env in envs.values():
            env.close()
        within(30, t.stop)


@pytest.mark.parametrize("side", list(PKG))
def test_a_broker_drops_out_between_its_announces(side, clusters):
    """The membership's TTL is 3 master pulses (1.2 s here), the broker
    announces every 3 s: it is listed only part of the time."""
    c = clusters[side]
    p = PKG[side]
    b = p["Broker"](c.filer_url, c.master_url)
    t = p["Thread"](b.app).start()
    b.address = t.address
    try:
        seen = set()
        end = time.monotonic() + 4.0
        while time.monotonic() < end:
            seen.add(_listed(c.master_url))
            time.sleep(0.05)
        assert seen == {True, False}
    finally:
        within(30, t.stop)
    assert not _listed(c.master_url)    # a clean stop announces its leave


def test_requests_wait_for_the_topics_to_load(clusters, monkeypatch):
    """The port's server listens before the App's on_startup runs, where
    aiohttp listens only after it: a request that reaches a starting
    broker waits for its topics, never answering 404 for a topic the
    filer holds."""
    from seaweedfs_tpu_torch.server.cluster import reserve_ports

    filer = clusters["port"].filer_url
    first = BrokerServer(filer)
    t = ServerThread(first.app).start()
    try:
        assert requests.post(f"{t.url}/topics/default/early",
                             json={"partitions": 1},
                             timeout=30).status_code == 201
    finally:
        within(30, t.stop)
    b = BrokerServer(filer)
    real_load = b._load_topics

    def slow_load():
        time.sleep(1.0)
        real_load()

    monkeypatch.setattr(b, "_load_topics", slow_load)
    (sock,) = reserve_ports(1)
    t = ServerThread(b.app, sock=sock)
    starter = threading.Thread(target=t.start)
    starter.start()
    try:
        r = requests.get(f"http://127.0.0.1:{sock.getsockname()[1]}"
                         f"/topics/default/early", timeout=30)
        assert r.status_code == 200 and r.json()["partitions"] == 1
    finally:
        starter.join(30)
        within(30, t.stop)


EMPTY_CASE = port_cases(ref_regressions)["TestWave3.test_mq_empty_batch_is_noop"]


@pytest.mark.parametrize("side", list(PKG))
def test_an_empty_batch_publishes_nothing(side, clusters):
    """The reference's regression case: {"records": []} acks nothing and
    appends nothing."""
    mapping = {"seaweedfs_tpu.mq.broker": port_broker,
               "seaweedfs_tpu.rpc.http": port_http} if side == "port" \
        else {}
    with swap_modules(mapping, parents=True):
        run_case(EMPTY_CASE, {"cluster": clusters[side]})
