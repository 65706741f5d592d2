"""The port's filer metadata stream against the JAX package's.

* The same seeded mutations (creates, multi-chunk and inline files,
  overwrites, raw `?meta=1` entries, hard links, renames of a file and
  of a directory, deletes, a recursive delete, writes outside the
  prefix, writes tagged with a peer's signature) on both packages'
  filers give the same sequence of /ws/meta_subscribe events, apart
  from `ts_ns`, the filer's own signature, timestamps, fids and
  hard-link ids: the same `directory`, `old_entry`, `new_entry` and
  signatures, a rename as the same old / new pairs.
* Each package's `MetaSubscriber` reads the other package's filer: the
  events equal the filer's own log under the prefix.
* Resume by `since_ns` neither skips nor repeats an event, across a
  reconnect forced by the filer dropping the stream too.
* The filer's stop and `MetaSubscriber.stop()` each return within 5 s
  with a subscriber attached to an idle stream.
* `filer.meta.tail` through the CLI (`python -m seaweedfs_tpu_torch`),
  and the reference's own stream and tail cases, `[reference|port]`.
"""
import functools
import threading
import time

import numpy as np
import pytest
import requests

from seaweedfs_tpu.rpc.meta_subscriber import MetaSubscriber as RefSub
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.rpc.meta_subscriber import MetaSubscriber
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_filer_server as ref_filer_cases
from tests import test_mount_quota as ref_tail_cases
from tests import torch_port_procs
from tests.torch_port_cases import call_case, port_cases, within

SEED = 20261017
PortCluster = functools.partial(Cluster, ec_backend="native")
PKG = {"reference": dict(Cluster=RefCluster, Sub=RefSub),
       "port": dict(Cluster=PortCluster, Sub=MetaSubscriber)}
STREAM = "TestMetaSubscription.test_ws_stream_receives_events"
TAIL = "TestMetaTailCli.test_tail_prints_events"
SIDES = {
    "reference": {STREAM: port_cases(ref_filer_cases)[STREAM],
                  TAIL: port_cases(ref_tail_cases)[TAIL]},
    "port": {STREAM: port_cases(ref_filer_cases, Cluster=PortCluster)[STREAM],
             TAIL: port_cases(ref_tail_cases,
                              subprocess=torch_port_procs)[TAIL]},
}
PEER = 4242


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {}
    try:
        for side, pkg in PKG.items():
            out[side] = within(60, pkg["Cluster"], str(
                tmp_path_factory.mktemp(f"meta_{side}")),
                n_volume_servers=1, volume_size_limit=16 << 20,
                with_filer=True)
        yield out
    finally:
        for c in out.values():
            within(30, c.stop)


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", [STREAM, TAIL])
def test_reference_case(case, side, clusters):
    call_case(SIDES[side][case], {"cluster": clusters[side]})


# ----------------------------------------------------------------------
# the same mutations, the same events
# ----------------------------------------------------------------------
def _mutations(root: str) -> list[tuple]:
    rng = np.random.default_rng([SEED, 1])
    body = lambda n: rng.bytes(n)  # noqa: E731
    return [
        ("POST", f"{root}/a/", {"params": {"mkdir": "1"}}),
        ("POST", f"{root}/a/one.bin", {"data": body(3000)}),
        ("POST", f"{root}/a/big.bin", {"data": body((2 << 20) + 77),
                                       "params": {"maxMB": "1"}}),
        ("POST", f"{root}/a/inline.txt", {"data": b"tiny",
                                          "params": {"saveInside": "true"}}),
        ("POST", f"{root}/a/one.bin", {"data": body(1234)}),   # overwrite
        ("POST", f"{root}/peer.bin", {"data": body(99), "params": {
            "signatures": str(PEER)}}),
        ("POST", "/elsewhere/skip.bin", {"data": body(10)}),
        ("POST", f"{root}/raw.json", {"params": {"meta": "1"},
                                      "data": b'{"mime": "text/plain", '
                                              b'"extended": {"k": "v"}}'}),
        ("POST", f"{root}/a/link.bin", {"params": {
            "link.from": f"{root}/a/one.bin"}}),
        ("PUT", f"{root}/a/renamed.bin", {"params": {
            "mv.from": f"{root}/a/one.bin"}}),
        ("POST", f"{root}/d/x/y.bin", {"data": body(500)}),
        ("PUT", f"{root}/moved", {"params": {"mv.from": f"{root}/d"}}),
        ("DELETE", f"{root}/a/inline.txt", {}),
        ("DELETE", f"{root}/moved", {"params": {"recursive": "true"}}),
    ]


_MASK = ("mtime", "crtime", "mtime_ns", "fid", "hard_link_id")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("*" if k in _MASK else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _norm(ev: dict, own: int) -> dict:
    sigs = ev["signatures"]
    assert sigs[-1] == own
    return {"directory": ev["directory"],
            "old_entry": _mask(ev["old_entry"]),
            "new_entry": _mask(ev["new_entry"]),
            "signatures": sigs[:-1]}


def _signature(c) -> int:
    return requests.get(f"{c.filer_url}/status", timeout=10).json()[
        "signature"]


class _Collector:
    def __init__(self):
        self.events: list[dict] = []
        self.cond = threading.Condition()

    def __call__(self, ev: dict) -> None:
        with self.cond:
            self.events.append(ev)
            self.cond.notify_all()

    def wait(self, n: int, timeout: float = 15.0) -> list[dict]:
        deadline = time.monotonic() + timeout
        with self.cond:
            while len(self.events) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise AssertionError(
                        f"{len(self.events)} events, wanted {n}")
                self.cond.wait(left)
            return list(self.events)


def _apply(c, muts) -> None:
    for method, path, kw in muts:
        r = requests.request(method, f"{c.filer_url}{path}", timeout=30,
                             **kw)
        assert r.status_code < 300, (method, path, r.status_code, r.text)


def _log(c, prefix: str) -> list[dict]:
    """The filer's own event log under prefix, in order."""
    under = prefix.rstrip("/") + "/"
    return [ev for ev in c.filer.filer.meta_log.replay(0)
            if (ev["directory"] + "/").startswith(under)]


def test_same_mutations_same_events(clusters):
    got = {}
    for side, c in clusters.items():
        col = _Collector()
        sub = MetaSubscriber(c.filer_url, "/ev1", col)
        sub.start()
        try:
            _apply(c, _mutations("/ev1"))
            n = len(_log(c, "/ev1"))
            events = col.wait(n)
            assert [e["ts_ns"] for e in events] == \
                [e["ts_ns"] for e in _log(c, "/ev1")]
        finally:
            within(5, sub.stop)
        own = _signature(c)
        got[side] = [_norm(ev, own) for ev in events]
    assert got["port"] == got["reference"]
    kinds = [(e["old_entry"] is None, e["new_entry"] is None)
             for e in got["port"]]
    assert (False, False) in kinds and (False, True) in kinds
    assert any(e["signatures"] == [PEER] for e in got["port"])
    assert not any(e["directory"].startswith("/elsewhere")
                   for e in got["port"])


@pytest.mark.parametrize("client,server", [("reference", "port"),
                                           ("port", "reference")])
def test_subscriber_across_packages(client, server, clusters):
    c = clusters[server]
    col = _Collector()
    sub = PKG[client]["Sub"](c.filer_url, "/ev2", col)
    sub.start()
    try:
        _apply(c, _mutations("/ev2"))
        want = _log(c, "/ev2")
        assert col.wait(len(want)) == want
    finally:
        within(5, sub.stop)


@pytest.mark.parametrize("side", list(PKG))
def test_resume_by_since_neither_skips_nor_repeats(side, clusters):
    c = clusters[side]
    _apply(c, [("POST", f"/ev3/f{i}.bin", {"data": bytes([i]) * (i + 1)})
               for i in range(10)])
    log = _log(c, "/ev3")
    mid = log[4]["ts_ns"]
    seen: list[dict] = []
    offset = {"ts": mid}

    def handle(ev):
        seen.append(ev)
        offset["ts"] = ev["ts_ns"]

    sub = MetaSubscriber(c.filer_url, "/ev3", handle,
                         since_fn=lambda: offset["ts"],
                         reconnect_delay=0.05)
    sub.start()
    try:
        deadline = time.monotonic() + 15
        while len(seen) < 5 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert seen == log[5:]
        if side == "port":
            # the filer drops the stream: the subscriber reconnects
            # from its offset
            with c.filer._subs_lock:
                socks = list(c.filer._subscribers)
            assert socks
            for ws in socks:
                ws.abort()
        else:
            sub._ws_lock.acquire()
            ws = sub._ws
            sub._ws_lock.release()
            ws.abort()
        _apply(c, [("POST", f"/ev3/g{i}.bin", {"data": b"g" * (i + 1)})
                   for i in range(5)])
        log = _log(c, "/ev3")
        deadline = time.monotonic() + 15
        while len(seen) < len(log) - 5 and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.3)
        assert seen == log[5:]
    finally:
        within(5, sub.stop)


def test_subscriber_stop_returns_on_an_idle_stream(clusters):
    for c in clusters.values():
        sub = MetaSubscriber(c.filer_url, "/idle", lambda ev: None)
        sub.start()
        deadline = time.monotonic() + 10
        while sub._ws is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert sub._ws is not None
        time.sleep(0.3)
        t0 = time.monotonic()
        within(5, sub.stop)
        assert time.monotonic() - t0 < 5
        assert not any(t.is_alive() for t in sub._threads)


@pytest.mark.parametrize("client", list(PKG))
def test_filer_stop_ends_its_subscriptions(client, tmp_path):
    """A port filer with a subscriber attached (either package's) stops
    within 5 s, and the subscription's handler thread ends."""
    c = within(60, PortCluster, str(tmp_path / "c"), n_volume_servers=1,
               with_filer=True)
    sub = None
    before = set(threading.enumerate())
    try:
        sub = PKG[client]["Sub"](c.filer_url, "/", lambda ev: None,
                                 reconnect_delay=0.2)
        sub.start()
        deadline = time.monotonic() + 10
        while not c.filer._subscribers and time.monotonic() < deadline:
            time.sleep(0.02)
        assert c.filer._subscribers
        t0 = time.monotonic()
        within(5, c.filer_thread.stop)
        assert time.monotonic() - t0 < 5
        deadline = time.monotonic() + 5
        while c.filer._subscribers and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not c.filer._subscribers

        def readers():      # this filer's stream readers still alive
            return [t for t in threading.enumerate() if t not in before
                    and t.name == "meta-subscribe-read"]

        deadline = time.monotonic() + 5
        while readers() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not readers()
    finally:
        if sub is not None:
            within(5, sub.stop)
        within(30, c.stop)
