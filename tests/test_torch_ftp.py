"""The port's FTP gateway against the JAX package's, through the
standard library's `ftplib`, with tolerance 0.

* The cases of tests/test_ftp.py run `[reference]` on the JAX package's
  gateway over its filer and `[port]` on the port's over the port's
  filer (tests/torch_port_cases.py rebinds the case's imports).
* Over each package's filer, the reference's gateway and the port's
  give the same replies to the same session, word for word: LIST and
  NLST of the same entries, PWD / CWD / CDUP, SIZE, MDTM, FEAT, SYST,
  TYPE, PASV and EPSV's shapes, REST and a resumed RETR, APPE, RNFR /
  RNTO, DELE, MKD and a recursive RMD, and each refusal (530, 550,
  501, 502, 503).
* Through each gateway over each filer: a file past the spool's memory
  size stored and read back whole and from a REST offset, and files
  stored in one gateway read through the other.
"""
import ftplib
import functools
import io
import re

import numpy as np
import pytest
import requests

from seaweedfs_tpu import ftpd as ref_ftpd
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch import ftpd as port_ftpd
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_ftp as ref_cases
from tests.torch_port_cases import port_cases, run_case, swap_modules, within

SEED = 20261018
PortCluster = functools.partial(Cluster, ec_backend="native")
PKG = {"reference": (RefCluster, ref_ftpd), "port": (PortCluster, port_ftpd)}
CASES = {k: v for k, v in port_cases(ref_cases).items()}
USERS = {"admin": "secret"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A reference and a port cluster with a filer each, and over each
    filer a reference and a port FTP gateway (user admin)."""
    out = {"clusters": {}, "ftp": {}}
    try:
        for side, (Cl, _) in PKG.items():
            out["clusters"][side] = within(
                60, Cl, str(tmp_path_factory.mktemp(f"ftp_{side}")),
                n_volume_servers=1, volume_size_limit=64 << 20,
                with_filer=True)
        for filer, c in out["clusters"].items():
            for gw, (_, mod) in PKG.items():
                out["ftp"][(gw, filer)] = mod.FtpServer(
                    c.filer_url, port=0, users=USERS,
                    anonymous=False).start()
        yield out
    finally:
        for s in out["ftp"].values():
            s.stop()
        for c in out["clusters"].values():
            within(60, c.stop)


def _login(srv) -> ftplib.FTP:
    c = ftplib.FTP()
    c.connect("127.0.0.1", srv.port, timeout=30)
    c.login("admin", "secret")
    return c


def test_every_reference_case_is_mirrored():
    assert len(CASES) == 11


@pytest.mark.parametrize("side", list(PKG))
@pytest.mark.parametrize("case", list(CASES))
def test_reference_ftp_cases(case, side, world, monkeypatch):
    srv = world["ftp"][(side, side)]
    client = _login(srv)
    fixtures = {"ftp": client, "ftp_srv": srv, "monkeypatch": monkeypatch,
                "cluster": world["clusters"][side]}
    mapping = {"seaweedfs_tpu.ftpd": port_ftpd} if side == "port" else {}
    try:
        with swap_modules(mapping, parents=True):
            run_case(CASES[case], fixtures)
    finally:
        try:
            client.quit()
        except ftplib.all_errors:
            client.close()


def _session(srv, root: str) -> list[tuple[str, str]]:
    """One scripted session under `root`: each command and its reply
    (or its refusal), data-channel output included."""
    out: list[tuple[str, str]] = []
    c = ftplib.FTP()
    c.connect("127.0.0.1", srv.port, timeout=30)
    out.append(("welcome", c.getwelcome()))

    def cmd(line: str) -> str:
        try:
            r = c.sendcmd(line)
        except ftplib.all_errors as e:
            r = f"refused {e}"
        out.append((line, r))
        return r

    def data(label: str, fn):
        try:
            r = fn()
        except ftplib.all_errors as e:
            r = f"refused {e}"
        out.append((label, r))

    cmd("PWD")                      # before login: 530
    cmd("USER admin")
    cmd("PASS wrong")
    cmd("USER admin")
    cmd("PASS secret")
    for line in ("SYST", "FEAT", "NOOP", "TYPE A", "TYPE I", "PWD",
                 "XYZZY", "RNTO nowhere", "REST notanumber"):
        cmd(line)
    cmd(f"MKD {root}")
    cmd(f"CWD {root}")
    cmd("PWD")
    cmd("MKD sub")
    cmd("CWD sub")
    cmd("CDUP")
    cmd("CWD nosuchdir")
    rng = np.random.default_rng([SEED, 1])
    files = {"a.txt": b"alpha\n", "b.bin": rng.bytes(70000),
             "sub/c.bin": rng.bytes(1000), "sp ace.txt": b"spaced"}
    for name, payload in files.items():
        data(f"STOR {name}", lambda n=name, p=payload: c.storbinary(
            f"STOR {n}", io.BytesIO(p)))
    data("APPE a.txt", lambda: c.storbinary("APPE a.txt",
                                            io.BytesIO(b"more\n")))
    data("APPE new.txt", lambda: c.storbinary("APPE new.txt",
                                              io.BytesIO(b"fresh")))
    for name in ("a.txt", "b.bin", "sub/c.bin", "sub", "missing"):
        cmd(f"SIZE {name}")
    got = []
    data("RETR b.bin REST 12345", lambda: (c.retrbinary(
        "RETR b.bin", got.append, rest=12345), b"".join(got) ==
        files["b.bin"][12345:])[1])
    data("RETR a.txt", lambda: (lambda buf: (c.retrbinary(
        "RETR a.txt", buf.write), buf.getvalue())[1])(io.BytesIO()))
    data("RETR missing", lambda: c.retrbinary("RETR missing",
                                              lambda b: None))
    # the listings: modes, sizes, dates and names, as sent
    for arg in ("", "sub", "-la"):
        lines: list[str] = []
        data(f"LIST {arg}", lambda a=arg: (c.retrlines(
            f"LIST {a}".strip(), lines.append), list(lines))[1])
    data("NLST", lambda: c.nlst())
    data("NLST sub", lambda: c.nlst("sub"))
    cmd("RNFR missing")
    cmd("RNFR a.txt")
    cmd("RNTO renamed.txt")
    data("NLST after rename", lambda: c.nlst())
    cmd("DELE new.txt")
    cmd("DELE new.txt")
    cmd("RMD nosuchdir")
    cmd("RMD sub")
    data("NLST after rmd", lambda: c.nlst())
    # the passive replies' shapes (their ports are ephemeral)
    out.append(("PASV", re.sub(r"\d+,\d+\)$", "P1,P2)", c.sendcmd("PASV"))))
    out.append(("EPSV", re.sub(r"\|\d+\|", "|P|", c.sendcmd("EPSV"))))
    cmd("CWD /")
    cmd("QUIT")
    return out


def _masked(v, root: str):
    """A reply with its root directory named ROOT."""
    if isinstance(v, str):
        return v.replace(root, "ROOT")
    if isinstance(v, list):
        return [_masked(x, root) for x in v]
    return v


@pytest.mark.parametrize("filer", list(PKG))
def test_a_session_gets_the_references_replies(filer, world):
    roots = {gw: f"s-{gw[:3]}-{filer}" for gw in PKG}
    got = {gw: [(_masked(k, roots[gw]), _masked(v, roots[gw])) for k, v in
                _session(world["ftp"][(gw, filer)], "/" + roots[gw])]
           for gw in PKG}
    for ref, port in zip(got["reference"], got["port"]):
        assert port == ref
    assert len(got["port"]) == len(got["reference"]) == 54
    replies = dict(got["port"])
    assert sorted(replies["NLST"]) == ["a.txt", "b.bin", "new.txt",
                                       "sp ace.txt", "sub"]
    assert replies["RETR b.bin REST 12345"] is True
    assert replies["RETR a.txt"] == b"alpha\nmore\n"


@pytest.mark.parametrize("gw,filer", [(g, f) for g in PKG for f in PKG])
def test_a_large_file_through_each_gateway(gw, filer, world):
    srv = world["ftp"][(gw, filer)]
    other = world["ftp"][("port" if gw == "reference" else "reference",
                          filer)]
    # past the spool's memory size: the upload spills to disk
    data = np.random.default_rng([SEED, 2]).bytes(
        port_ftpd.FtpSession.SPOOL_MAX + 4321)
    c = _login(srv)
    try:
        name = f"/big-{gw}-{filer}.bin"
        c.storbinary(f"STOR {name}", io.BytesIO(data), blocksize=1 << 20)
        assert c.size(name) == len(data)
        for client, rest in ((c, None), (c, len(data) - 777777)):
            buf = io.BytesIO()
            client.retrbinary(f"RETR {name}", buf.write, rest=rest)
            assert buf.getvalue() == data[rest or 0:]
    finally:
        c.quit()
    r = requests.get(world["clusters"][filer].filer_url + name, timeout=60)
    assert r.content == data
    c = _login(other)
    try:
        buf = io.BytesIO()
        c.retrbinary(f"RETR {name}", buf.write)
        assert buf.getvalue() == data
        c.delete(name)
    finally:
        c.quit()
