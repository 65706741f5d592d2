"""The port CLI's gateway subcommands (`ftp`, `mq.broker`, `webdav`,
`iam`) against the JAX package's.

* Each subcommand's help is the reference's (program name masked), and
  the same argv parses to the same flags and defaults in both CLIs:
  ports 8021, 17777, 7333 and 8111; `-filer`, `-filer.path`, `-user`,
  `-master`, `-ip`.
* Each subcommand starts as a process of the port's CLI over an
  in-process port cluster and serves once its port takes a TCP connect:
  an FTP login and transfer, a WebDAV PUT / GET / PROPFIND, an IAM
  CreateUser landing in the filer KV, and a broker that announces
  itself to the master, takes a publish, flushes its tail when SIGINT
  stops it (exit 0, a `leave` announce) and, started again, continues
  the offsets.
"""
import ftplib
import functools
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import requests

from seaweedfs_tpu import cli as ref_cli
from seaweedfs_tpu_torch import cli
from seaweedfs_tpu_torch.server.cluster import Cluster, free_ports

from tests.torch_port_cases import within

COMMANDS = ["ftp", "mq.broker", "webdav", "iam"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PortCluster = functools.partial(Cluster, ec_backend="native")


def _normalized(text: str, prog: str) -> str:
    return " ".join(text.replace(prog, "PROG").split())


@pytest.mark.parametrize("name", COMMANDS)
def test_help_is_the_references(name, capsys):
    out = {}
    for side, main, prog in (("reference", ref_cli.main, "seaweedfs-tpu"),
                             ("port", cli.main, "seaweedfs-tpu-torch")):
        with pytest.raises(SystemExit) as ei:
            main([name, "-h"])
        assert ei.value.code == 0
        out[side] = _normalized(capsys.readouterr().out, prog)
    assert out["port"] == out["reference"]
    assert out["port"].startswith(f"usage: PROG {name} [-h]")


_ARGV = [
    ["ftp"], ["ftp", "-port", "2121", "-ip", "0.0.0.0", "-filer",
              "http://f:1", "-filer.path", "/pub", "-user", "u:p:w"],
    ["mq.broker"], ["mq.broker", "-port", "1", "-filer", "http://f:2",
                    "-master", "http://m:3", "-ip", "10.0.0.1"],
    ["webdav"], ["webdav", "-filer", "f:4", "-filer.path", "/dav",
                 "-port", "8080"],
    ["iam"], ["iam", "-port", "9", "-filer", "http://f:5"],
]
_FLAGS = ("cmd", "port", "ip", "filer", "filer_path", "user", "master")


@pytest.mark.parametrize("argv", _ARGV, ids=[" ".join(a) for a in _ARGV])
def test_flags_and_defaults_are_the_references(argv, monkeypatch):
    got = {}

    def grab(side):
        def fn(args):
            got[side] = {k: getattr(args, k) for k in _FLAGS
                         if hasattr(args, k)}
            return 0
        return fn

    monkeypatch.setattr(ref_cli, "_dispatch", grab("reference"))
    monkeypatch.setattr(cli, "_run_gateway", grab("port"))
    assert ref_cli.main(list(argv)) == 0
    assert cli.main(list(argv)) == 0
    assert got["port"] == got["reference"]
    defaults = {"ftp": 8021, "mq.broker": 17777, "webdav": 7333,
                "iam": 8111}
    if len(argv) == 1:
        assert got["port"]["port"] == defaults[argv[0]]
        assert got["port"]["filer"] == "http://127.0.0.1:8888"


def _spawn(args: list[str], log) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch",
                             *args], cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT)


def _serving(proc, port: int, log_path: str, deadline: float = 30.0):
    """Wait for a TCP connect to the process's port."""
    end = time.monotonic() + deadline
    while True:
        if proc.poll() is not None:
            with open(log_path) as f:
                raise AssertionError(f"exited {proc.returncode}: {f.read()}")
        try:
            socket.create_connection(("127.0.0.1", port), 1).close()
            return
        except OSError:
            assert time.monotonic() < end, f"port {port} never listened"
            time.sleep(0.05)


def _stop(proc, sig=signal.SIGTERM) -> int:
    if proc.poll() is None:
        proc.send_signal(sig)
    try:
        return proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=10)


def _broker_listed(master: str, address: str) -> bool:
    nodes = requests.get(f"{master}/cluster/nodes", params={
        "type": "broker"}, timeout=10).json()["nodes"]
    return any(n["address"] == address for n in nodes)


def test_each_gateway_serves_as_a_process(tmp_path):
    # pulse 2 s: the master keeps a broker 6 s, longer than its 3 s
    # announce, so the listing below is not a race (Queue 3 item 10)
    c = within(60, PortCluster, str(tmp_path / "c"), n_volume_servers=1,
               volume_size_limit=16 << 20, with_filer=True,
               pulse_seconds=2.0)
    procs: dict[str, subprocess.Popen] = {}
    logs = {}
    try:
        ports = dict(zip(COMMANDS + ["mq.broker again"], free_ports(5)))
        argv = {
            "ftp": ["ftp", "-user", "admin:pw", "-filer.path", "/ftp"],
            "mq.broker": ["mq.broker", "-master", c.master_url],
            "webdav": ["webdav", "-filer.path", "/dav"],
            "iam": ["iam"]}
        for name in COMMANDS:
            logs[name] = str(tmp_path / f"{name}.log")
            with open(logs[name], "wb") as log:
                procs[name] = _spawn(argv[name] + [
                    "-port", str(ports[name]), "-filer", c.filer_url], log)
        for name in COMMANDS:
            _serving(procs[name], ports[name], logs[name])
        # ftp: a login, a transfer, the file in the filer under -filer.path
        requests.put(c.filer_url + "/ftp", params={"mkdir": "1"}, timeout=30)
        f = ftplib.FTP()
        f.connect("127.0.0.1", ports["ftp"], timeout=30)
        with pytest.raises(ftplib.error_perm):
            f.login("admin", "wrong")
        f.login("admin", "pw")
        f.storbinary("STOR hello.txt", io.BytesIO(b"over ftp"))
        assert f.nlst() == ["hello.txt"]
        f.quit()
        assert requests.get(c.filer_url + "/ftp/hello.txt",
                            timeout=30).content == b"over ftp"
        # webdav
        dav = f"http://127.0.0.1:{ports['webdav']}"
        assert requests.request("MKCOL", dav + "/d", timeout=30).status_code \
            == 201
        assert requests.put(dav + "/d/x.bin", data=b"over dav",
                            timeout=30).status_code == 201
        assert requests.get(c.filer_url + "/dav/d/x.bin",
                            timeout=30).content == b"over dav"
        r = requests.request("PROPFIND", dav + "/d", headers={"Depth": "1"},
                             timeout=30)
        assert r.status_code == 207 and b"<D:href>/d/x.bin</D:href>" in \
            r.content
        # iam
        r = requests.post(f"http://127.0.0.1:{ports['iam']}/",
                          data={"Action": "CreateUser", "UserName": "dan"},
                          timeout=30)
        assert r.status_code == 200
        doc = requests.get(c.filer_url + "/kv/s3/identities", timeout=30)
        assert json.loads(doc.content)["identities"][0]["name"] == "dan"
        # mq.broker: registered, a publish, SIGINT flushes and leaves
        broker = f"http://127.0.0.1:{ports['mq.broker']}"
        address = f"127.0.0.1:{ports['mq.broker']}"
        end = time.monotonic() + 15
        while not _broker_listed(c.master_url, address):
            assert time.monotonic() < end, "the broker never announced"
            time.sleep(0.1)
        assert requests.post(broker + "/topics/default/cli",
                             json={"partitions": 2},
                             timeout=30).status_code == 201
        acks = requests.post(broker + "/topics/default/cli/publish", json={
            "records": [{"key": f"k{i}", "value": f"v{i}"}
                        for i in range(20)]}, timeout=30).json()["acks"]
        assert _stop(procs.pop("mq.broker"), signal.SIGINT) == 0
        assert not _broker_listed(c.master_url, address)
        stored = 0
        for p in range(2):
            listing = requests.get(
                f"{c.filer_url}/topics/default/cli/p{p}",
                headers={"Accept": "application/json"}, timeout=30).json()
            for e in listing.get("entries", []):
                stored += len(requests.get(
                    c.filer_url + e["full_path"],
                    timeout=30).content.splitlines())
        assert stored == 20
        # started again: the offsets continue
        logs["again"] = str(tmp_path / "again.log")
        with open(logs["again"], "wb") as log:
            procs["again"] = _spawn(
                ["mq.broker", "-master", c.master_url, "-port",
                 str(ports["mq.broker again"]), "-filer", c.filer_url], log)
        _serving(procs["again"], ports["mq.broker again"], logs["again"])
        again = f"http://127.0.0.1:{ports['mq.broker again']}"
        state = requests.get(again + "/topics/default/cli",
                             timeout=30).json()["state"]
        assert [s["next_offset"] for s in state] == [
            sum(1 for a in acks if a["partition"] == p) for p in range(2)]
        for name, proc in procs.items():
            assert proc.poll() is None, name
    finally:
        for proc in procs.values():
            _stop(proc)
        within(60, c.stop)
