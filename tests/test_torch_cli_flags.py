"""The port's CLI against the reference's, flag by flag, and the volume
server's in-flight limits the flags drive (tolerance 0).

* Every option string of the reference's parser, on the global parser
  and on each subcommand, exists in the port's with the same `dest`,
  `default`, `choices`, action and `type` behaviour. The port may add
  options; the ones it adds are listed in PORT_ONLY, so that a flag
  dropped or added by mistake fails here.
* `-vmodule`, `-hedge.delay` and `-telemetry.*` reach glog, the hedged
  reads and the workload sketches, as the reference's do.
* InFlightLimiter waits, admits and refuses the same way in both
  packages; a volume server under a small `-concurrentDownloadLimitMB`
  holds a second GET while a slow reader holds the tally, then answers
  it, or answers 429 at a short timeout, in both packages.
"""
import argparse
import copy
import os
import socket
import threading
import time

import numpy as np
import pytest
import requests

from seaweedfs_tpu import cli as ref_cli
from seaweedfs_tpu.operation import verbs as ref_verbs
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu.server import volume_server as ref_vs
from seaweedfs_tpu_torch import cli as port_cli
from seaweedfs_tpu_torch.filer import stream as port_stream
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.server import volume_server as port_vs
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.utils import glog, retry, sketch
from tests.torch_port_cases import within

# options the port has and the reference's parser lacks, each on
# purpose: -pulseSeconds sets the master's pulse, which each heartbeat
# reply carries (the reference has no pulse flag: its master keeps
# the 5 s default, and its volume servers their own pulse); the
# combined server takes the master's -repair.* and -admin.* flags,
# which the reference's server command never wired; the filer's -maxMB
# is the chunk size the reference's filer hard-codes
PORT_ONLY = {
    "filer": {"-maxMB"},
    "master": {"-pulseSeconds"},
    "server": {"-admin.scriptInterval", "-admin.scripts",
               "-repair.concurrency", "-repair.enabled", "-repair.grace",
               "-repair.interval", "-repair.maxAttempts",
               "-repair.maxBytesPerSec", "-repair.partialEc"},
}
_SAMPLES = ("0", "1", "2", "0.5", "-3", "false", "true", "no", "x")


class _Parsed(Exception):
    pass


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """The reference builds its parser inside main(): stop main at its
    parse_args and take the parser."""
    got = {}

    def grab(self, *args, **kwargs):
        got["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        ref_cli.main([])
    monkeypatch.undo()
    return got["parser"]


def _options(parser: argparse.ArgumentParser, name: str = "") -> dict:
    """{subcommand ("" = global): {option string: action}}."""
    out = {name: {}}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for sub, sp in action.choices.items():
                out.update(_options(sp, sub))
        for opt in action.option_strings:
            if opt not in ("-h", "--help"):
                out[name][opt] = action
    return out


def _type_behaviour(conv):
    if conv is None:
        return None
    out = []
    for s in _SAMPLES:
        try:
            out.append(conv(s))
        except (ValueError, TypeError) as e:
            out.append(type(e).__name__)
    return out


def _differences(ref: dict, port: dict) -> list[str]:
    diffs = []
    for sub, opts in sorted(ref.items()):
        if sub not in port:
            diffs.append(f"subcommand {sub!r} missing")
            continue
        for opt, a in sorted(opts.items()):
            b = port[sub].get(opt)
            where = f"{sub or '<global>'} {opt}"
            if b is None:
                diffs.append(f"{where} missing")
                continue
            for attr in ("dest", "default", "choices", "nargs",
                         "required", "const"):
                if getattr(a, attr) != getattr(b, attr):
                    diffs.append(f"{where} {attr}: {getattr(a, attr)!r} "
                                 f"!= {getattr(b, attr)!r}")
            if type(a) is not type(b):
                diffs.append(f"{where} action: {type(a).__name__} != "
                             f"{type(b).__name__}")
            if _type_behaviour(a.type) != _type_behaviour(b.type):
                diffs.append(f"{where} type: {a.type} != {b.type}")
    return diffs


@pytest.fixture
def parsers(monkeypatch):
    return (_options(_reference_parser(monkeypatch)),
            _options(port_cli.build_parser()))


def test_every_reference_option_is_in_the_port(parsers):
    ref, port = parsers
    assert sum(len(v) for v in ref.values()) > 200
    assert _differences(ref, port) == []


def test_the_port_adds_only_the_listed_options(parsers):
    ref, port = parsers
    extra = {sub: set(opts) - set(ref.get(sub, {}))
             for sub, opts in port.items()}
    assert {k: v for k, v in extra.items() if v} == PORT_ONLY


def test_the_comparison_sees_a_dropped_or_changed_flag(parsers):
    ref, port = parsers
    dropped = {k: dict(v) for k, v in port.items()}
    del dropped[""]["-hedge.delay"]
    del dropped["volume"]["-concurrentUploadLimitMB"]
    assert _differences(ref, dropped) == [
        "<global> -hedge.delay missing",
        "volume -concurrentUploadLimitMB missing"]
    changed = {k: dict(v) for k, v in port.items()}
    act = copy.copy(changed[""]["-telemetry.enabled"])
    act.type = lambda s: s == "true"  # "no" would read as true
    changed[""]["-telemetry.enabled"] = act
    (diff,) = _differences(ref, changed)
    assert diff.startswith("<global> -telemetry.enabled type: ")


@pytest.mark.parametrize("argv", [
    ["-vmodule", "store=2,volume_server=3", "-hedge.delay", "0.05",
     "-telemetry.enabled", "false", "-telemetry.alpha", "0.02",
     "-telemetry.window", "60", "version"],
    ["version"],
])
def test_global_flags_reach_glog_retry_and_sketch(argv, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(retry, "HEDGE_DELAY", retry.HEDGE_DELAY)
    for name in ("_enabled", "_alpha", "_window"):
        monkeypatch.setattr(sketch, name, getattr(sketch, name))
    monkeypatch.setattr(glog, "_vmodule", {})
    assert port_cli.main(argv) == 0
    capsys.readouterr()
    if len(argv) > 1:
        assert glog._vmodule == {"store": 2, "volume_server": 3}
        assert retry.HEDGE_DELAY == 0.05
        assert (sketch.enabled(), sketch.alpha(), sketch.window()) == \
            (False, 0.02, 60.0)
    else:
        assert glog._vmodule == {}
        assert retry.HEDGE_DELAY == 0.35
        assert sketch.enabled() is True


def test_hedged_reads_take_the_configured_delay(monkeypatch):
    seen = []
    monkeypatch.setattr(retry, "HEDGE_DELAY", 0.125)
    monkeypatch.setattr(port_stream, "_replica_urls",
                        lambda lookup, fid: ["a", "b"])
    monkeypatch.setattr(
        port_stream, "_hedged_fetch",
        lambda fetch, urls, delay: seen.append(delay) or b"x")
    assert port_stream.read_fid(lambda fid: "http://a/" + fid,
                                "1,01", 0, 1) == b"x"
    assert seen == [0.125]


# -- the in-flight limiter ------------------------------------------------

@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_limiter_waits_admits_and_refuses(pkg):
    """A request waits while the tally is over the limit, is admitted as
    soon as a release brings it to the limit, and is refused once
    `timeout` passes; limit 0 only counts."""
    import asyncio

    if pkg == "reference":
        lim = ref_vs.InFlightLimiter(100, timeout=0.3)

        async def scenario():
            lim.add(150)
            t0 = time.monotonic()
            refused = not await lim.wait_admit()
            waited = time.monotonic() - t0
            waiter = asyncio.ensure_future(lim.wait_admit())
            await asyncio.sleep(0.05)
            early = waiter.done()
            await lim.release(50)
            admitted = await waiter
            return refused, waited, early, admitted, lim.value

        result = asyncio.run(scenario())
        free = ref_vs.InFlightLimiter(0)
        free.add(1 << 40)
        assert asyncio.run(free.wait_admit())
    else:
        lim = port_vs.InFlightLimiter(100, timeout=0.3)
        lim.add(150)
        t0 = time.monotonic()
        refused = not lim.wait_admit()
        waited = time.monotonic() - t0
        out = {}
        waiter = threading.Thread(
            target=lambda: out.setdefault("ok", lim.wait_admit()))
        waiter.start()
        time.sleep(0.05)
        early = "ok" in out
        lim.release(50)
        waiter.join(5)
        result = refused, waited, early, out.get("ok"), lim.value
        free = port_vs.InFlightLimiter(0)
        free.add(1 << 40)
        assert free.wait_admit()
    refused, waited, early, admitted, value = result
    assert refused and waited >= 0.29
    assert not early and admitted is True and value == 100


def _slow_reader(url: str, fid: str) -> socket.socket:
    """A GET whose client reads its status line and then stops reading,
    so the server's writes block and the needle stays in flight."""
    host, port = url.split(":")
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    s.settimeout(10)
    s.connect((host, int(port)))
    s.sendall(f"GET /{fid} HTTP/1.1\r\nHost: {url}\r\n\r\n".encode())
    assert s.recv(12).startswith(b"HTTP/1.1 200")
    return s


def _wait_for(pred, seconds: float = 10.0):
    deadline = time.monotonic() + seconds
    while not pred():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.02)


def _one_server(pkg: str, tmp_path):
    """A master and one volume server of `pkg`, on its CPU codec. ->
    (the cluster, its verbs module)."""
    if pkg == "reference":
        return within(60, ref_cluster_mod.Cluster, str(tmp_path),
                      n_volume_servers=1, volume_size_limit=64 << 20,
                      ec_backend="numpy"), ref_verbs
    return within(60, Cluster, str(tmp_path), n_volume_servers=1,
                  volume_size_limit=64 << 20,
                  ec_backend=CudaCodec(device="cpu")), verbs


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_volume_server_holds_then_refuses_downloads(pkg, tmp_path):
    c, v = _one_server(pkg, tmp_path)
    try:
        big = np.random.default_rng(1).integers(
            0, 256, 24 << 20, dtype=np.uint8).tobytes()
        a_big = v.assign(c.master_url)
        v.upload(a_big, big, mime="application/octet-stream")
        a_small = v.assign(c.master_url)
        v.upload(a_small, b"small needle", mime="text/plain")
        small_url = f"http://{a_small.url}/{a_small.fid}"
        vs = c.volume_servers[0]
        flight = vs._download_flight
        flight.limit = 1 << 20
        flight.timeout = 0.5
        reader = _slow_reader(a_big.url, a_big.fid)
        try:
            _wait_for(lambda: flight.value >= len(big))
            t0 = time.monotonic()
            r = requests.get(small_url, timeout=30)
            assert (r.status_code, r.text) == \
                (429, "too many in-flight downloads")
            assert time.monotonic() - t0 >= 0.45
            flight.timeout = 30.0
            out = {}
            waiter = threading.Thread(target=lambda: out.setdefault(
                "r", requests.get(small_url, timeout=60)))
            waiter.start()
            time.sleep(0.4)
            assert "r" not in out  # held while the tally is over
        finally:
            reader.close()
        waiter.join(30)
        assert (out["r"].status_code, out["r"].content) == \
            (200, b"small needle")
        _wait_for(lambda: flight.value == 0)
        text = requests.get(f"http://{a_small.url}/metrics",
                            timeout=30).text
        assert "volume_server_in_flight_download_bytes 0" in text
        assert "volume_server_in_flight_upload_bytes 0" in text
    finally:
        within(60, c.stop)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_volume_server_counts_uploads(pkg, tmp_path):
    """A POST's Content-Length is its estimate: over a 0-byte upload
    limit held by another upload, a write waits and then answers 429."""
    c, v = _one_server(pkg, tmp_path)
    try:
        vs = c.volume_servers[0]
        flight = vs._upload_flight
        a = v.assign(c.master_url)
        flight.limit = 10
        flight.timeout = 0.3
        flight.value = 11  # another upload's bytes
        r = requests.post(f"http://{a.url}/{a.fid}", data=b"x" * 5,
                          timeout=30)
        assert (r.status_code, r.text) == (429, "too many in-flight uploads")
        flight.value = 0
        r = requests.post(f"http://{a.url}/{a.fid}", data=b"x" * 5,
                          timeout=30)
        assert r.status_code == 201 and flight.value == 0
    finally:
        within(60, c.stop)


def test_cli_volume_takes_the_limits(monkeypatch):
    seen = {}

    def fake_start(args, dirs, port, master, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(port_cli, "_start_volume", fake_start)
    with pytest.raises(SystemExit):
        port_cli.main(["volume", "-concurrentUploadLimitMB", "3",
                       "-concurrentDownloadLimitMB", "0", "-dir",
                       os.devnull])
    assert seen["concurrent_upload_limit"] == 3 << 20
    assert seen["concurrent_download_limit"] == 0
