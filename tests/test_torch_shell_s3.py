"""The port's s3.* shell commands against the JAX package's.

* Every case of tests/test_shell_s3.py and of
  tests/test_shell_ext.py::TestS3QuotaAndUploads runs twice,
  `[reference]` on the JAX package's cluster and `[port]` on the port's
  (tests/torch_port_cases.py rebinds the case's names): s3.configure
  (dry run, apply, merge, delete) with the gateway reloading and
  enforcing the identities, s3.bucket.create / list / delete (a
  non-empty bucket only with -includeObjects), s3.circuit.breaker with
  the gateway refusing an over-limit PUT, s3.bucket.quota and
  quota.enforce (the read-only latch released when the quota goes),
  s3.clean.uploads.
* The KV documents each package's commands write (s3/identities,
  s3/circuit_breaker) are byte-equal, and each package's gateway
  obeys the document the other package's shell wrote.
"""
import functools
import time

import pytest
import requests

from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.shell.repl import run_command as ref_run
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell import commands_fs, commands_s3
from seaweedfs_tpu_torch.shell import env as port_env
from seaweedfs_tpu_torch.shell.env import CommandEnv, ShellError
from seaweedfs_tpu_torch.shell.repl import run_command

from tests import test_shell_ext as ref_ext
from tests import test_shell_s3 as ref_cases
from tests.torch_port_cases import port_cases, run_case, swap_modules, within

PortCluster = functools.partial(Cluster, ec_backend="native")
PORT_NAMES = dict(Cluster=PortCluster, CommandEnv=CommandEnv,
                  run_command=run_command, commands_s3=commands_s3,
                  ShellError=ShellError)
SIDES = {
    "reference": ({**port_cases(ref_cases),
                   **{k: v for k, v in port_cases(ref_ext).items()
                      if k.startswith("TestS3QuotaAndUploads.")}}, {}),
    "port": ({**port_cases(ref_cases, **PORT_NAMES),
              **{k: v for k, v in port_cases(ref_ext, **PORT_NAMES).items()
                 if k.startswith("TestS3QuotaAndUploads.")}},
             {"seaweedfs_tpu.shell.env": port_env,
              "seaweedfs_tpu.shell.commands_fs": commands_fs}),
}
CASES = list(SIDES["port"][0])
PKG = {"reference": dict(Cluster=RefCluster, Env=RefEnv, run=ref_run),
       "port": dict(Cluster=PortCluster, Env=CommandEnv, run=run_command)}


def test_every_reference_case_is_mirrored():
    assert CASES == list(SIDES["reference"][0])
    assert len(CASES) == 8


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {}
    try:
        for side, pkg in PKG.items():
            c = out[side] = within(60, pkg["Cluster"], str(
                tmp_path_factory.mktemp(f"shells3_{side}")),
                n_volume_servers=2, volume_size_limit=4 << 20,
                max_volumes=40, with_filer=True, with_s3=True)
            # the gateways re-read the filer's KV documents this often
            c.s3.identity_refresh_seconds = 0.5
        yield out
    finally:
        for c in out.values():
            within(30, c.stop)


@pytest.fixture(scope="module")
def envs(clusters):
    out = {}
    for side, c in clusters.items():
        out[side] = PKG[side]["Env"](c.master_url, filer_url=c.filer_url)
        out[side].acquire_lock()
    yield out
    for e in out.values():
        e.close()


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, side, clusters, envs):
    cases, swaps = SIDES[side]
    with swap_modules(swaps, parents=True):
        run_case(cases[case], {"cluster": clusters[side],
                               "env": envs[side]})


_EDITS = ["s3.configure -user=kv1 -access_key=K1 -secret_key=S1 "
          "-actions=Read,List -apply",
          "s3.configure -user=kv2 -access_key=K2 -secret_key=S2 -apply",
          "s3.configure -user=kv1 -actions=Read -apply",
          "s3.circuit.breaker -global='{\"writeCount\":8}' -apply",
          "s3.circuit.breaker -bucket=bk -bucketConf='{\"readBytes\":9}' "
          "-apply",
          "s3.circuit.breaker -bucket=bk -delete -apply"]


def test_kv_documents_are_byte_equal(clusters, envs):
    docs = {}
    for side, c in clusters.items():
        for line in _EDITS:
            PKG[side]["run"](envs[side], line)
        docs[side] = [requests.get(f"{c.filer_url}/kv/{k}", timeout=30)
                      .content for k in ("s3/identities",
                                         "s3/circuit_breaker")]
        PKG[side]["run"](envs[side], "s3.configure -user=kv1 -delete -apply")
        PKG[side]["run"](envs[side], "s3.configure -user=kv2 -delete -apply")
        PKG[side]["run"](envs[side], "s3.circuit.breaker -delete -apply")
    assert docs["port"] == docs["reference"]
    assert b'"writeCount": 8' in docs["port"][1]


@pytest.mark.parametrize("shell,gateway", [("reference", "port"),
                                           ("port", "reference")])
def test_gateway_obeys_the_other_shell(shell, gateway, clusters):
    c = clusters[gateway]
    env = PKG[shell]["Env"](c.master_url, filer_url=c.filer_url)
    run = PKG[shell]["run"]
    try:
        run(env, "s3.circuit.breaker -global='{\"writeBytes\":64}' -apply")
        _wait(lambda: c.s3.circuit_breaker.enabled, "the limit loaded")
        # the users the previous test deleted are gone from the gateway
        # only at its next reload; until then an anonymous PUT gets 403
        _wait(lambda: c.s3.iam.is_open, "anonymous access")
        requests.put(f"{c.s3_url}/xlim", timeout=30)
        assert requests.put(f"{c.s3_url}/xlim/big", data=b"x" * 256,
                            timeout=30).status_code == 503
        run(env, "s3.circuit.breaker -delete -apply")
        _wait(lambda: not c.s3.circuit_breaker.enabled, "the limit gone")
        assert requests.put(f"{c.s3_url}/xlim/big", data=b"x" * 256,
                            timeout=30).status_code == 200
        run(env, "s3.bucket.delete -name=xlim -includeObjects")
        assert "xlim" not in [b["name"] for b in
                              run(env, "s3.bucket.list")]
    finally:
        env.close()


def _wait(pred, what: str, timeout: float = 15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"{what}: never")
