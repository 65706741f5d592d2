"""The port's native C++ data plane (seaweedfs_tpu_torch/native/
dataplane.cc + dataplane.py) against the JAX package's, with tolerance 0.

* Every case of the reference's tests/test_native_dataplane.py runs
  twice, `[reference]` on the JAX package's plane, Volume and needle
  codec, and `[port]` on the port's (tests/torch_port_cases.py rebinds
  the case's names; an import inside a case gets the port's module):
  GET/POST, HEAD, keep-alive pipelining, readonly, detach and vacuum,
  the refused compact, routing and relay, delete, ranges, JWT, native
  fan-out, stale peers, the forwarded JWT, pairs, export.
* Parity: one seeded sequence of requests goes to a reference and a
  port volume attached to their own planes (the two libraries sit side
  by side in this process, each loaded RTLD_LOCAL with its own
  globals). Statuses, bodies and every header but Date are equal —
  Last-Modified is a needle timestamp, taken when each front appends,
  so it is held to one second — and so are export()'s (key, offset,
  size) arrays and the .dat sizes after the sequence.
"""
from __future__ import annotations

import http.client
import json
import os
import random

import numpy as np
import pytest

import seaweedfs_tpu_torch.utils.security as port_security
from seaweedfs_tpu.native import dataplane as ref_dpmod
from seaweedfs_tpu.storage import needle as ref_ndl
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.native import dataplane as dpmod
from seaweedfs_tpu_torch.native import build
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils.security import sign_jwt

from tests import test_native_dataplane as ref_native
from tests.torch_port_cases import call_case, port_cases, swap_modules

SIDES = {
    "reference": (port_cases(ref_native), ref_dpmod, {}),
    "port": (port_cases(ref_native, dpmod=dpmod, ndl=ndl, Volume=Volume),
             dpmod,
             {"seaweedfs_tpu.utils.security": port_security}),
}
CASES = list(SIDES["port"][0])


def test_every_reference_case_is_mirrored():
    assert CASES == [n for n in vars(ref_native) if n.startswith("test_")]
    assert len(CASES) == 15


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, side, tmp_path):
    cases, mod, swaps = SIDES[side]
    fixtures = {"tmp_path": tmp_path}
    d = None
    if "dp" in cases[case].__code__.co_varnames[
            :cases[case].__code__.co_argcount]:
        # backend port 1 is unroutable on purpose, as the reference's
        # fixture: relay-path cases that need a backend start their own
        d = mod.DataPlane()
        d.start(0, 1)
        fixtures["dp"] = d
    try:
        with swap_modules(swaps):
            call_case(cases[case], fixtures)
    finally:
        if d is not None:
            d.stop()


def test_library_builds_from_the_port_tree():
    path = build.dp_lib_path()
    assert os.path.dirname(path) == build.BUILD_DIR
    assert dpmod._load()._name == path
    assert build.DP_SRC == os.path.join(os.path.dirname(dpmod.__file__),
                                        "dataplane.cc")
    assert ref_dpmod._load()._name != path


# -- parity: one seeded request sequence through both planes ----------

def _request(port: int, method: str, path: str, body: bytes | None = None,
             headers: dict | None = None) -> tuple[int, dict, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _sequence(seed: int, vid: int, secret: str) -> list[tuple]:
    """A seeded mix of the front's verbs over one volume: POSTs of
    seeded sizes, GETs, HEADs, ranges, cookie mismatches, misses,
    deletes, batch slots, unsigned writes."""
    rng = random.Random(seed)
    ops, live = [], []
    for i in range(160):
        roll = rng.random()
        if roll < 0.35 or not live:
            key = rng.randrange(1, 1 << 40)
            cookie = rng.randrange(1 << 32)
            fid = f"{vid},{key:x}{cookie:08x}"
            body = rng.randbytes(rng.choice([0, 1, 7, 100, 4096, 70000]))
            tok = sign_jwt(secret, fid) if rng.random() < 0.9 else ""
            if rng.random() < 0.1:
                fid += f"_{rng.randrange(1, 4)}"  # an assign?count slot
            hdrs = {"Content-Type": "application/octet-stream"}
            if tok:
                hdrs["Authorization"] = f"Bearer {tok}"
            ops.append(("POST", "/" + fid, body, hdrs))
            live.append(fid.split("_")[0])
        elif roll < 0.55:
            ops.append(("GET", "/" + rng.choice(live), None, {}))
        elif roll < 0.65:
            ops.append(("HEAD", "/" + rng.choice(live), None, {}))
        elif roll < 0.75:
            a = rng.randrange(0, 200)
            spec = rng.choice([f"bytes={a}-{a + rng.randrange(50)}",
                               f"bytes={a}-", f"bytes=-{a + 1}",
                               "bytes=999999-"])
            ops.append(("GET", "/" + rng.choice(live), None,
                        {"Range": spec}))
        elif roll < 0.82:
            fid = rng.choice(live)
            ops.append(("GET", "/" + fid[:-8] + "00000000", None, {}))
        elif roll < 0.86:
            ops.append(("GET", f"/{vid},{rng.randrange(1 << 40):x}"
                        "0000beef", None, {}))
        else:
            fid = rng.choice(live)
            ops.append(("DELETE", "/" + fid, None,
                        {"Authorization":
                         f"Bearer {sign_jwt(secret, fid)}"}))
    return ops


def _normalized(resp):
    status, headers, body = resp
    h = {k.lower(): v for k, v in headers.items() if k.lower() != "date"}
    lm = h.pop("last-modified", None)
    return status, h, body, lm


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_parity(tmp_path, seed):
    import email.utils

    secret = f"parity-{seed}"
    planes = {}
    vols = {}
    try:
        for name, mod, vcls in (("reference", ref_dpmod, RefVolume),
                                ("port", dpmod, Volume)):
            d = mod.DataPlane()
            d.start(0, 1)
            d.config(True, secret)
            planes[name] = d
            vdir = tmp_path / name
            vdir.mkdir()
            vols[name] = vcls(str(vdir), "", 21, create=True)
            assert vols[name].attach_native(d)
        for method, path, body, hdrs in _sequence(seed, 21, secret):
            got = {name: _normalized(_request(planes[name].port, method,
                                              path, body, hdrs))
                   for name in planes}
            ref, port = got["reference"], got["port"]
            assert port[:3] == ref[:3], (method, path, hdrs)
            if ref[3] is not None or port[3] is not None:
                stamps = [email.utils.parsedate_to_datetime(v[3])
                          for v in (ref, port)]
                assert abs((stamps[0] - stamps[1]).total_seconds()) <= 1
        ref_exp = planes["reference"].export(21)
        exp = planes["port"].export(21)
        order_r, order_p = np.argsort(ref_exp[0]), np.argsort(exp[0])
        for a, b in zip(ref_exp, exp):
            assert np.array_equal(a[order_r], b[order_p])
        assert planes["port"].stats(21) == {
            **planes["reference"].stats(21),
            "last_append_ns": planes["port"].stats(21)["last_append_ns"]}
        for name in planes:
            vols[name].detach_native()
        sizes = {name: os.path.getsize(vols[name].file_name() + ".dat")
                 for name in vols}
        assert sizes["port"] == sizes["reference"]
        # each package reads the other's files after the sequence
        for name, vcls in (("reference", Volume), ("port", RefVolume)):
            other = vcls(str(tmp_path / name), "", 21)
            try:
                assert other.nm.file_count == vols[name].nm.file_count
            finally:
                other.close()
    finally:
        for v in vols.values():
            v.close()
        for d in planes.values():
            d.config(False, "")
            d.stop()


def test_python_appends_parity(tmp_path):
    """The delegation contract with the same seeded needles appended
    through each package's Volume while attached: the maps, counters
    and .dat sizes agree, and each front serves the other's bytes."""
    rng = random.Random(7)
    needles = [(rng.randrange(1, 1 << 30), rng.randrange(1 << 32),
                rng.randbytes(rng.randrange(0, 3000))) for _ in range(64)]
    planes, vols = {}, {}
    try:
        for name, mod, vcls, nmod in (
                ("reference", ref_dpmod, RefVolume, ref_ndl),
                ("port", dpmod, Volume, ndl)):
            d = mod.DataPlane()
            d.start(0, 1)
            planes[name] = d
            vdir = tmp_path / name
            vdir.mkdir()
            v = vols[name] = vcls(str(vdir), "", 22, create=True)
            v.attach_native(d)
            for i, (key, cookie, data) in enumerate(needles):
                v.append_needle(nmod.Needle(id=key, cookie=cookie,
                                            data=data,
                                            append_at_ns=1000 + i))
            for key, _c, _d in needles[::5]:
                v.delete_needle(key)
        for name in planes:
            for key, cookie, data in needles:
                st, _h, body = _request(planes[name].port, "GET",
                                        f"/22,{key:x}{cookie:08x}")
                deleted = any(k == key for k, _c, _d in needles[::5])
                assert (st, body if st == 200 else None) == \
                    ((404, None) if deleted else (200, data))
        ref_exp, exp = (planes[n].export(22) for n in ("reference", "port"))
        for a, b in zip(ref_exp, exp):
            assert np.array_equal(np.sort(a), np.sort(b))
        for k in ("file_count", "file_bytes", "deleted_count",
                  "deleted_bytes", "max_key"):
            assert getattr(vols["port"].nm, k) == \
                getattr(vols["reference"].nm, k), k
        for name in vols:
            vols[name].detach_native()
        assert os.path.getsize(vols["port"].file_name() + ".dat") == \
            os.path.getsize(vols["reference"].file_name() + ".dat")
        assert json.dumps(sorted(vols["port"].nm.live_items())) == \
            json.dumps(sorted(vols["reference"].nm.live_items()))
    finally:
        for v in vols.values():
            v.close()
        for d in planes.values():
            d.stop()


# -- the CLI's flags, against the reference's parser --------------------

@pytest.mark.parametrize("argv", [
    ["volume"], ["volume", "-dataplane", "python"],
    ["volume", "-dataplane", "native"],
    ["server"], ["server", "-dataplane", "python", "-s3.native", "python"],
    ["server", "-filer.native", "native", "-filer.native.workers", "4"],
    ["filer"], ["filer", "-filer.native", "auto"],
])
def test_cli_native_flags_match_the_reference(argv, monkeypatch):
    from seaweedfs_tpu import cli as ref_cli
    from seaweedfs_tpu_torch import cli

    got = vars(cli.build_parser().parse_args(argv))
    # the reference builds its parser inside main(): catch what it parsed
    parsed = []
    monkeypatch.setattr(ref_cli, "_dispatch",
                        lambda args: parsed.append(args) or 0)
    assert ref_cli.main(argv) == 0
    want = vars(parsed[0])
    keys = {"dataplane", "s3_native", "filer_native",
            "filer_native_workers"} & set(want)
    assert keys and {k: got[k] for k in keys} == {k: want[k] for k in keys}


def test_cli_standalone_filer_refuses_native():
    from seaweedfs_tpu_torch import cli

    args = cli.build_parser().parse_args(["filer", "-filer.native",
                                          "native"])
    with pytest.raises(SystemExit, match="in-process volume store"):
        cli._run_filer(args)


def test_cli_server_puts_every_front_in_place(tmp_path):
    """`server -filer -s3 -dataplane native -s3.native native
    -filer.native native`: the volume, filer and S3 ports are the C++
    fronts, each answering its hot verbs, the Python apps behind them."""
    import socket
    import subprocess
    import sys
    import time

    import requests

    def free():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    mport, vport, fport, sport = free(), free(), free(), free()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server", "-dir",
         str(tmp_path), "-master.port", str(mport), "-volume.port",
         str(vport), "-filer", "-filer.port", str(fport), "-s3",
         "-s3.port", str(sport), "-ec.backend", "native", "-dataplane",
         "native", "-s3.native", "native", "-filer.native", "native"],
        env=dict(os.environ, PYTHONPATH=repo), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                st = requests.get(f"http://127.0.0.1:{vport}/status",
                                  timeout=2).json()
                requests.get(f"http://127.0.0.1:{fport}/", timeout=2)
                requests.get(f"http://127.0.0.1:{sport}/status", timeout=2)
                if st.get("native_dataplane") is not None:
                    break
            except requests.RequestException:
                pass
            assert time.time() < deadline, "server never came up"
            time.sleep(0.2)
        body = b"through the native filer front"
        deadline = time.time() + 30
        while True:  # until the front's fid pool fills, PUTs relay
            r = requests.put(f"http://127.0.0.1:{fport}/cli/a.bin",
                             data=body, timeout=10)
            assert r.status_code == 201, r.text
            m = requests.get(f"http://127.0.0.1:{vport}/metrics",
                             timeout=10).text
            if 'native_fronts_requests_total{front="filer",code="2xx"} 0' \
                    not in m or time.time() > deadline:
                break
            time.sleep(0.2)
        assert requests.get(f"http://127.0.0.1:{fport}/cli/a.bin",
                            timeout=10).content == body
        assert 'native_fronts_requests_total{front="filer",code="2xx"} 0' \
            not in requests.get(f"http://127.0.0.1:{vport}/metrics",
                                timeout=10).text
        assert requests.put(f"http://127.0.0.1:{sport}/clib",
                            timeout=10).status_code == 200
        assert requests.put(f"http://127.0.0.1:{sport}/clib/o.bin",
                            data=b"s3", timeout=10).status_code == 200
        assert requests.get(f"http://127.0.0.1:{sport}/clib/o.bin",
                            timeout=10).content == b"s3"
        out = requests.get(f"http://127.0.0.1:{sport}/status", timeout=10)
        assert "native_s3_front" in out.json()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
