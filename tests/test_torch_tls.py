"""TLS on the port's HTTP plane (seaweedfs_tpu_torch/utils/tls.py,
rpc/http.py's TLS listeners, rpc/httpclient.py's https, rpc/websocket.py's
wss, `-security`) against the JAX package's.

* Each package's client against the other's TLS server: the port's
  client verifies the reference's aiohttp HTTPS listener, `requests`
  verifies the port's; without the CA both refuse (the port's client
  raises its SSLError, never retrying over plain HTTP); plain HTTP to
  either TLS port fails; mutual TLS refuses a client without a
  certificate and admits one with.
* Certificates cross over: the port's generator (the openssl binary,
  the reference's fall-back path, P-256) serves the reference's
  listener and the reference's (`cryptography`, P-256) serves the
  port's.
* The reference's tests/test_tls.py runs on the port (its fixtures
  rebuilt on the port's ServerThread), and `python -m
  seaweedfs_tpu_torch -security ... master` serves HTTPS.
* The port's listener handshakes on each connection's own thread: a
  client that connects and stalls mid-handshake holds up no other.
* A pooled plain connection is never reused for an https url.
* KeepConnected over wss: a MasterClient following a TLS master gets
  its volume updates, and a master.follower reached over HTTPS answers
  lookups from them.
* Which listeners can carry TLS in a working cluster with a filer and
  the S3 gateway, in both packages (a JWT secret and batch durability
  on): the gateway, in both, with equal statuses; the master or the
  filer break the reference, whose filer and gateway reach them
  through rpc/fastclient.py in plain HTTP, where the port's go through
  rpc/httpclient.py (ROADMAP Queue 3).
"""
import json
import os
import signal
import socket
import ssl
import subprocess
import sys
import time

import pytest
import requests

from seaweedfs_tpu.rpc import http as ref_http
from seaweedfs_tpu.utils import tls as ref_tls
from seaweedfs_tpu_torch.rpc import http as rhttp
from seaweedfs_tpu_torch.rpc import httpclient
from seaweedfs_tpu_torch.rpc.httpclient import RequestException, SSLError
from seaweedfs_tpu_torch.server.cluster import Cluster, free_ports
from seaweedfs_tpu_torch.server.master_follower import MasterFollower
from seaweedfs_tpu_torch.utils import tls
from seaweedfs_tpu_torch.wdclient.client import MasterClient

from tests import test_tls as ref_cases
from tests.torch_port_cases import port_cases, run_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECRET = "tls-parity-secret"
CASES = port_cases(ref_cases, tls=tls, skip=(
    # it spawns `python -m seaweedfs_tpu`: test_cli_master_serves_https
    # below is its port twin
    "test_cli_master_with_security",))


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return tls.generate_self_signed(str(tmp_path_factory.mktemp("certs")))


@pytest.fixture(scope="module")
def ref_certs(tmp_path_factory):
    return ref_tls.generate_self_signed(
        str(tmp_path_factory.mktemp("ref_certs")))


@pytest.fixture
def trust(certs, monkeypatch):
    """The port's client trusts the port's CA (REQUESTS_CA_BUNDLE)."""
    monkeypatch.setenv("REQUESTS_CA_BUNDLE", certs["ca_cert"])
    return certs


def _port_server(certs, **kw):
    app = rhttp.App()
    app.get("/status", lambda req: rhttp.json_ok({"ok": True,
                                                   "mtls": True}))
    return rhttp.ServerThread(app, ssl_context=tls.server_ssl_context(
        certs["cert"], certs["key"], **kw)).start()


def _ref_server(certs, **kw):
    from aiohttp import web

    async def hello(req):
        return ref_http.json_ok({"ok": True})

    app = web.Application()
    app.add_routes([web.get("/status", hello)])
    return ref_http.ServerThread(app, ssl_context=ref_tls.server_ssl_context(
        certs["cert"], certs["key"], **kw)).start()


@pytest.fixture(scope="module")
def https_server(certs):
    t = _port_server(certs)
    yield t
    t.stop()


@pytest.fixture(scope="module")
def mtls_server(certs):
    t = _port_server(certs, ca=certs["ca_cert"], client_auth=True)
    yield t
    t.stop()


@pytest.mark.parametrize("case", list(CASES))
def test_reference_tls_cases_on_the_port(case, certs, https_server,
                                         mtls_server, tmp_path):
    run_case(CASES[case], {"certs": certs, "https_server": https_server,
                           "mtls_server": mtls_server,
                           "tmp_path": tmp_path})


@pytest.mark.parametrize("gen", ["port", "reference"])
def test_port_client_against_the_reference_server(gen, certs, ref_certs,
                                                  monkeypatch):
    c = certs if gen == "port" else ref_certs
    srv = _ref_server(c)
    try:
        assert srv.url.startswith("https://")
        monkeypatch.setenv("REQUESTS_CA_BUNDLE", c["ca_cert"])
        s = httpclient.Session()
        assert s.get(f"{srv.url}/status").json() == {"ok": True}
        monkeypatch.delenv("REQUESTS_CA_BUNDLE")
        with pytest.raises(SSLError):
            httpclient.Session().get(f"{srv.url}/status")
        with pytest.raises(RequestException):
            httpclient.Session().get(f"http://127.0.0.1:{srv.port}/status",
                                     timeout=3)
    finally:
        srv.stop()


@pytest.mark.parametrize("gen", ["port", "reference"])
def test_requests_against_the_port_server(gen, certs, ref_certs):
    c = certs if gen == "port" else ref_certs
    srv = _port_server(c)
    try:
        assert srv.url.startswith("https://")
        r = requests.get(f"{srv.url}/status", verify=c["ca_cert"],
                         timeout=10)
        assert r.status_code == 200 and r.json()["ok"] is True
        with pytest.raises(requests.exceptions.SSLError):
            requests.get(f"{srv.url}/status", verify=True, timeout=10)
        with pytest.raises(requests.RequestException):
            requests.get(f"http://127.0.0.1:{srv.port}/status", timeout=3)
    finally:
        srv.stop()


def test_mutual_tls_across_packages(certs, trust):
    """The reference's mTLS listener refuses the port's client (which
    holds no client certificate); the port's refuses requests without
    one and admits it with one."""
    ref = _ref_server(certs, ca=certs["ca_cert"], client_auth=True)
    port = _port_server(certs, ca=certs["ca_cert"], client_auth=True)
    try:
        with pytest.raises(RequestException):
            httpclient.Session().get(f"{ref.url}/status", timeout=5)
        with pytest.raises(requests.RequestException):
            requests.get(f"{port.url}/status", verify=certs["ca_cert"],
                         timeout=5)
        r = requests.get(f"{port.url}/status", verify=certs["ca_cert"],
                         cert=(certs["client_cert"], certs["client_key"]),
                         timeout=5)
        assert r.json()["mtls"] is True
    finally:
        ref.stop()
        port.stop()


def test_generated_certificates_chain_to_their_ca(certs):
    ctx = ssl.create_default_context(cafile=certs["ca_cert"])
    ctx.load_cert_chain(certs["client_cert"], certs["client_key"])
    srv = _port_server(certs, ca=certs["ca_cert"], client_auth=True)
    try:
        for host in ("localhost", "127.0.0.1"):
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=5) as raw, \
                    ctx.wrap_socket(raw, server_hostname=host) as s:
                peer = s.getpeercert()
                assert dict(x[0] for x in peer["subject"])[
                    "commonName"] == "localhost"
                alt = {v for _, v in peer["subjectAltName"]}
                assert {"localhost", "127.0.0.1"} <= alt
    finally:
        srv.stop()


def test_a_stalled_handshake_holds_up_no_other_client(certs, trust):
    """A client that connects and never speaks TLS occupies its own
    connection's thread only: others are served at once."""
    srv = _port_server(certs)
    stalled = [socket.create_connection(("127.0.0.1", srv.port))
               for _ in range(4)]
    try:
        plain = socket.create_connection(("127.0.0.1", srv.port))
        plain.sendall(b"GET /status HTTP/1.1\r\nHost: x\r\n\r\n")
        t0 = time.monotonic()
        for _ in range(5):
            r = httpclient.Session().get(f"{srv.url}/status", timeout=5)
            assert r.json()["ok"] is True
        assert time.monotonic() - t0 < 3.0
        plain.settimeout(5)
        try:
            got = plain.recv(1 << 16)
        except ConnectionResetError:
            got = b""
        assert not got.startswith(b"HTTP/")     # never answered in plain
        plain.close()
    finally:
        for s in stalled:
            s.close()
        srv.stop()


def test_pools_never_reuse_a_plain_connection_for_https(certs, trust):
    app = rhttp.App()
    app.get("/status", lambda req: rhttp.json_ok({"plain": True}))
    srv = rhttp.ServerThread(app).start()
    try:
        s = httpclient.Session()
        assert s.get(f"http://127.0.0.1:{srv.port}/status").json() == \
            {"plain": True}
        with pytest.raises(RequestException):
            s.get(f"https://127.0.0.1:{srv.port}/status", timeout=3)
        assert s.get(f"http://127.0.0.1:{srv.port}/status").json() == \
            {"plain": True}
    finally:
        srv.stop()


def test_cli_master_serves_https(certs, tmp_path):
    """`python -m seaweedfs_tpu_torch -security sec.json master` serves
    HTTPS (the reference's test_cli_master_with_security)."""
    sec = tmp_path / "security.json"
    sec.write_text(json.dumps(
        {"https": {"cert": certs["cert"], "key": certs["key"]}}))
    (port,) = free_ports(1)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "-security",
         str(sec), "master", "-port", str(port), "-jwt.secret", SECRET],
        env=dict(os.environ, PYTHONPATH=REPO,
                 REQUESTS_CA_BUNDLE=certs["ca_cert"]),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        last = None
        while time.time() < deadline:
            try:
                r = requests.get(f"https://127.0.0.1:{port}/cluster/status",
                                 verify=certs["ca_cert"], timeout=2)
                assert r.status_code == 200
                break
            except requests.RequestException as e:
                last = e
                if proc.poll() is not None:
                    raise RuntimeError(proc.stdout.read())
                time.sleep(0.3)
        else:
            raise TimeoutError(str(last))
        with pytest.raises(requests.RequestException):
            requests.get(f"http://127.0.0.1:{port}/cluster/status",
                         timeout=3)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_keepconnected_over_wss(certs, trust, tmp_path):
    """A TLS master's KeepConnected stream reaches a subscribed client
    over wss://, and a follower on its own TLS listener answers lookups
    from it."""
    ctx = tls.server_ssl_context(certs["cert"], certs["key"])
    c = Cluster(str(tmp_path), n_volume_servers=1, pulse_seconds=0.2,
                tls={"master": ctx})
    follower = mc = None
    try:
        assert c.master_url.startswith("https://")
        mc = MasterClient(c.master_url, subscribe=True)
        mf = MasterFollower(c.master_url)
        follower = rhttp.ServerThread(mf.app, ssl_context=ctx).start()
        grown = httpclient.session().get(
            f"{c.master_url}/vol/grow", params={"count": 1},
            timeout=30).json()
        vid = int(grown["volumes"][0]) if "volumes" in grown else None
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not mc.cached_volumes():
            time.sleep(0.05)
        assert mc.cached_volumes() >= 1
        vid = vid or next(iter(mc._vid_cache))
        while time.monotonic() < deadline:
            r = httpclient.session().get(f"{follower.url}/dir/lookup",
                                         params={"volumeId": vid},
                                         timeout=10)
            if r.status_code == 200:
                break
            time.sleep(0.05)
        assert r.status_code == 200
        assert r.json()["locations"][0]["url"] == \
            c.volume_threads[0].address
    finally:
        if mc is not None:
            mc.stop()
        if follower is not None:
            follower.stop()
        c.stop()


# -- which listeners can carry TLS in a working cluster ------------------

class RefTlsCluster:
    """A reference cluster put together by hand, since its harness
    takes no TLS: a master, `n` volume servers (plain, as the
    reference's blob HTTP always is), a memory filer and the S3 gateway,
    each role in `roles` on HTTPS; a JWT secret and batch durability."""

    def __init__(self, base: str, ctx, roles: set[str], n: int = 3,
                 circuit_breaker: dict | None = None):
        from seaweedfs_tpu.rpc.http import ServerThread
        from seaweedfs_tpu.s3.server import S3ApiServer
        from seaweedfs_tpu.server.filer_server import FilerServer
        from seaweedfs_tpu.server.master_server import MasterServer
        from seaweedfs_tpu.server.volume_server import VolumeServer
        from seaweedfs_tpu.storage.store import Store

        def on(role):
            return ctx if role in roles else None

        self.threads = []
        self.master = MasterServer(volume_size_limit=8 << 20,
                                   pulse_seconds=0.4, jwt_secret=SECRET)
        mt = ServerThread(self.master.app, ssl_context=on("master")).start()
        self.threads.append(mt)
        self.master.admin_scripts_url = self.master_url = mt.url
        try:
            for i in range(n):
                d = os.path.join(base, f"vol{i}")
                os.makedirs(d)
                store = Store([d], ip="127.0.0.1", port=0,
                              ec_backend="numpy")
                vs = VolumeServer(store, mt.url, pulse_seconds=0.4,
                                  jwt_secret=SECRET,
                                  commit_durability="batch")
                t = ServerThread(vs.app).start()
                store.port, store.public_url = t.port, t.address
                self.threads.append(t)
            self.filer = FilerServer(mt.url, store="memory",
                                     store_path=":memory:")
            ft = ServerThread(self.filer.app,
                              ssl_context=on("filer")).start()
            self.filer.address = ft.address
            self.filer_url = ft.url
            self.threads.append(ft)
            self.s3 = S3ApiServer(ft.url,
                                  circuit_breaker_config=circuit_breaker)
            st = ServerThread(self.s3.app, ssl_context=on("s3")).start()
            self.s3_url = st.url
            self.threads.append(st)
            deadline = time.monotonic() + 15
            while len(self.master.topo.nodes) < n:
                assert time.monotonic() < deadline, "servers missing"
                time.sleep(0.05)
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        for t in reversed(self.threads):
            t.stop()


def trust_in_aiohttp(ca: str) -> None:
    """aiohttp builds its verifying context when it is imported, from
    SSL_CERT_FILE as it was then: add the test CA to it, as a process
    started with SSL_CERT_FILE set would have it."""
    import aiohttp.connector

    aiohttp.connector._SSL_CONTEXT_VERIFIED.load_verify_locations(ca)


def port_tls_cluster(base: str, ctx, roles: set[str], n: int = 3,
                     **kw) -> Cluster:
    return Cluster(base, n_volume_servers=n, volume_size_limit=8 << 20,
                   pulse_seconds=0.4, jwt_secret=SECRET,
                   commit_durability="batch", with_s3=True,
                   tls={r: ctx for r in roles}, **kw)


def _reach(c, ca: str) -> list[tuple]:
    """Assign at the master, then a bucket, a PUT and a GET through the
    gateway: (step, status)."""
    out = []
    r = requests.get(f"{c.master_url}/dir/assign", verify=ca, timeout=30)
    out.append(("assign", r.status_code, bool(r.json().get("auth"))))
    for step, method, path, body in (("bucket", "PUT", "/reach", None),
                                      ("put", "PUT", "/reach/o",
                                       b"r" * 5000),
                                      ("get", "GET", "/reach/o", None)):
        r = requests.request(method, f"{c.s3_url}{path}", data=body,
                             verify=ca, timeout=30)
        out.append((step, r.status_code))
    return out


@pytest.mark.parametrize("roles", [("s3",), ("master",), ("filer",)])
def test_which_listeners_carry_tls(roles, certs, trust, tmp_path,
                                   monkeypatch):
    monkeypatch.setenv("SSL_CERT_FILE", certs["ca_cert"])
    trust_in_aiohttp(certs["ca_cert"])
    ctx = tls.server_ssl_context(certs["cert"], certs["key"])
    ca = certs["ca_cert"]
    ref = RefTlsCluster(str(tmp_path / "ref"), ctx, set(roles))
    try:
        want = _reach(ref, ca)
    finally:
        ref.stop()
    port = port_tls_cluster(str(tmp_path / "port"), ctx, set(roles))
    try:
        got = _reach(port, ca)
    finally:
        port.stop()
    ok = [("assign", 200, True), ("bucket", 200), ("put", 200),
          ("get", 200)]
    assert got == ok
    if roles == ("s3",):
        assert want == got
    else:
        # the reference's filer (an https master) or gateway (an https
        # filer) speaks plain HTTP through rpc/fastclient.py: its
        # writes fail there (ROADMAP Queue 3)
        assert want[0] == ok[0] and want != ok, want


def test_the_admin_lock_never_reaches_a_tls_filer(certs, trust, tmp_path,
                                                  monkeypatch):
    """Shared with the reference (ROADMAP Queue 3): the watchdog's and
    the tiering controller's admin lock reach the filer the master
    lists at http:// (the reference's master/watchdog.py:345,
    master/tiering.py:477), so a filer on TLS refuses both packages'
    repairs and transitions the lock."""
    from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
    from seaweedfs_tpu.shell.env import ShellError as RefShellError
    from seaweedfs_tpu_torch.shell.env import CommandEnv, ShellError

    monkeypatch.setenv("SSL_CERT_FILE", certs["ca_cert"])
    trust_in_aiohttp(certs["ca_cert"])
    ctx = tls.server_ssl_context(certs["cert"], certs["key"])
    port = Cluster(str(tmp_path / "port"), n_volume_servers=1,
                   with_filer=True, tls={"filer": ctx})
    try:
        url = port.master.live_filer_url()
        assert url == f"http://{port.filer_thread.address}"
        with pytest.raises(ShellError, match="cannot acquire admin lock"):
            CommandEnv(port.master_url, filer_url=url).acquire_lock()
    finally:
        port.stop()
    ref = RefTlsCluster(str(tmp_path / "ref"), ctx, {"filer"}, n=1)
    try:
        deadline = time.monotonic() + 15
        while not ref.master.membership.list_nodes("filer"):
            assert time.monotonic() < deadline, "the filer never announced"
            time.sleep(0.05)
        addr = ref.master.membership.list_nodes("filer")[0].address
        with pytest.raises(RefShellError,
                           match="cannot acquire admin lock"):
            RefEnv(ref.master_url, filer_url=f"http://{addr}").acquire_lock()
    finally:
        ref.stop()
