"""The port's gcs and azure REST clients and its RS256 signer against
the JAX package's, over the doubles of tests/minicloud.py.

* The reference's tests/test_cloud_remotes.py cases of the clients, the
  RS256 signer, the Azure SharedKey vector and the fake-GCS bucket
  mounted end to end, the gcs / azure / b2 replication sinks and B2's
  bad credentials and 503 retry run twice, `[reference]` and `[port]`
  (tests/torch_port_cases.py rebinds the case's names; an import inside
  a case gets the port's module).
* Each package's client reads what the other's wrote, and both send
  the same signed Azure requests (the double checks each signature).
* A service-account grant: both packages' token sources post the same
  form fields to a token endpoint and verify with the same RS256
  signature (rsa key made with openssl), and the static-token and
  metadata-url modes give the same headers.
"""
import base64
import functools
import json
import shutil
import subprocess
import threading
import types
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import requests

import seaweedfs_tpu_torch.remote_storage.azure_client as port_azure
import seaweedfs_tpu_torch.server.cluster as port_cluster_mod
import seaweedfs_tpu_torch.shell.env as port_env
import seaweedfs_tpu_torch.shell.repl as port_repl
import seaweedfs_tpu_torch.utils.rs256 as port_rs256
from seaweedfs_tpu.remote_storage import make_client as ref_make_client
from seaweedfs_tpu.utils import gcp_auth as ref_gcp_auth
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.remote_storage import make_client
from seaweedfs_tpu_torch.replication.sink import make_sink
from seaweedfs_tpu_torch.rpc import httpclient
from seaweedfs_tpu_torch.utils import gcp_auth as port_gcp_auth

from tests import test_cloud_remotes as ref_cases
from tests.torch_port_cases import port_cases, run_case, swap_modules, within

PortCluster = functools.partial(port_cluster_mod.Cluster,
                                ec_backend="native")
# the port's HTTP errors, under the name the cases catch them by
port_requests = types.SimpleNamespace(**{
    **vars(requests), "HTTPError": httpclient.HTTPError})
SIDES = {
    "reference": (port_cases(ref_cases), {}),
    "port": (port_cases(ref_cases, make_client=make_client,
                        make_sink=make_sink, Entry=Entry,
                        requests=port_requests),
             {"seaweedfs_tpu.utils.rs256": port_rs256,
              "seaweedfs_tpu.server.cluster": types.SimpleNamespace(
                  Cluster=PortCluster),
              "seaweedfs_tpu.shell.env": port_env,
              "seaweedfs_tpu.shell.repl": port_repl}),
}
VECTOR = "test_azure_shared_key_string_to_sign_vector"
# the kinds the reference parametrizes its client and sink cases over
KINDS = {"test_client_roundtrip": ("gcs", "azure"),
         "test_sink_create_update_delete": ("gcs", "azure", "b2")}
CASES = list(SIDES["port"][0])


def test_every_reference_case_is_mirrored():
    assert CASES == list(port_cases(ref_cases))
    assert len(CASES) == 8


@pytest.fixture(scope="module")
def clouds():
    from tests.minicloud import MiniAzure, MiniB2, MiniGcs

    out = {"gcs": MiniGcs(), "azure": MiniAzure(), "b2": MiniB2()}
    for s in out.values():
        s.store.buckets["pics"] = {}
    yield out
    for s in out.values():
        s.close()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    from seaweedfs_tpu.server.cluster import Cluster as RefCluster

    out = {}
    try:
        for side, cls in (("reference", RefCluster), ("port", PortCluster)):
            out[side] = within(60, cls, str(tmp_path_factory.mktemp(
                f"gcs_mount_{side}")), n_volume_servers=1,
                volume_size_limit=8 << 20, with_filer=True)
        yield out
    finally:
        for c in out.values():
            within(30, c.stop)


class _Request:
    """request.getfixturevalue for the parametrized client and sink
    cases."""

    def __init__(self, clouds):
        self.clouds = clouds

    def getfixturevalue(self, name):
        return self.clouds[name]


def _run(side, case, fixtures):
    cases, swaps = SIDES[side]
    mods = dict(swaps)
    if case == VECTOR and side == "port":
        mods["seaweedfs_tpu.remote_storage.azure_client"] = port_azure
    with swap_modules(mods, parents=True):
        run_case(cases[case], fixtures)


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case,kind", [
    (c, k) for c in CASES for k in KINDS.get(c, ("",))])
def test_reference_case(case, kind, side, clouds, clusters, tmp_path,
                        monkeypatch):
    fixtures = {"gcs": clouds["gcs"], "azure": clouds["azure"],
                "b2": clouds["b2"], "request": _Request(clouds),
                "tmp_path": tmp_path, "cluster": clusters[side],
                "monkeypatch": monkeypatch}
    if kind:
        fixtures["kind"] = kind
    _run(side, case, fixtures)


# ----------------------------------------------------------------------
# across packages
# ----------------------------------------------------------------------
def _conf(kind, s):
    return ref_cases.CLIENT_CONFS[kind](s)


@pytest.mark.parametrize("kind", ["gcs", "azure"])
def test_each_reads_what_the_other_wrote(kind, clouds):
    s = clouds[kind]
    s.store.buckets["pics"].clear()
    port, ref = make_client(_conf(kind, s)), ref_make_client(_conf(kind, s))
    port.write_file("p/one.bin", b"from the port" * 100)
    ref.write_file("r/two.bin", b"from the reference" * 50)
    for c in (port, ref):
        assert c.read_file("p/one.bin", 5, 100) == \
            (b"from the port" * 100)[5:105]
        assert c.read_file("r/two.bin") == b"from the reference" * 50
    listed = {c: [(e.key, e.size, e.etag) for e in c.traverse()]
              for c in (port, ref)}
    assert listed[port] == listed[ref]
    assert port.head("r/two.bin").size == ref.head("p/one.bin").size - 400
    port.delete_file("r/two.bin")
    assert ref.head("r/two.bin") is None


# ----------------------------------------------------------------------
# the GCP token source
# ----------------------------------------------------------------------
class _TokenHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _reply(self, obj):
        body = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self.server.seen.append(("GET", self.path,
                                 self.headers.get("Metadata-Flavor"), b""))
        self._reply({"access_token": "meta-token", "expires_in": 3600})

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.server.seen.append(("POST", self.path,
                                 self.headers.get("Content-Type"), body))
        self._reply({"access_token": "sa-token", "expires_in": 3600})


@pytest.fixture()
def token_server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _TokenHandler)
    srv.seen = []
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def test_token_sources_agree(token_server, tmp_path, monkeypatch):
    openssl = shutil.which("openssl")
    if not openssl:
        pytest.fail("the openssl binary is needed to make the RSA key")
    srv, url = token_server
    key = tmp_path / "k.pem"
    subprocess.run([openssl, "genrsa", "-out", str(key), "2048"],
                   check=True, capture_output=True)
    sa = tmp_path / "sa.json"
    sa.write_text(json.dumps({"client_email": "svc@example.iam",
                              "private_key": key.read_text(),
                              "token_uri": f"{url}/token"}))
    # both grants at the same second: the same claims, the same bytes
    for mod in (ref_gcp_auth, port_gcp_auth):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: 1_790_000_000.0))
    out = {}
    for name, mod, sess in (("reference", ref_gcp_auth, requests.Session()),
                            ("port", port_gcp_auth, None)):
        src = mod.GcpTokenSource(sess, credentials_file=str(sa))
        out[name] = [src.headers(), src.headers()]   # the second cached
        out[name].append(mod.GcpTokenSource(sess, token="static").headers())
        out[name].append(mod.GcpTokenSource(
            sess, token_url=f"{url}/meta").headers())
        out[name].append(mod.GcpTokenSource(sess).headers())
    assert out["port"] == out["reference"]
    assert out["port"][0] == {"Authorization": "Bearer sa-token"}
    posts = [s for s in srv.seen if s[0] == "POST"]
    gets = [s for s in srv.seen if s[0] == "GET"]
    assert len(posts) == 2 and posts[0] == posts[1]
    assert posts[0][2] == "application/x-www-form-urlencoded"
    form = dict(urllib.parse.parse_qsl(posts[0][3].decode()))
    assert form["grant_type"] == \
        "urn:ietf:params:oauth:grant-type:jwt-bearer"
    head, claims, sig = form["assertion"].split(".")
    pad = lambda s: s + "=" * (-len(s) % 4)  # noqa: E731
    assert json.loads(base64.urlsafe_b64decode(pad(claims)))["iss"] == \
        "svc@example.iam"
    assert base64.urlsafe_b64decode(pad(sig)) == port_rs256.sign(
        key.read_text(), f"{head}.{claims}".encode())
    assert gets[0] == gets[1] == ("GET", "/meta", "Google", b"")
