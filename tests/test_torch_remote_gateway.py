"""The port's filer.remote.gateway against the JAX package's.

* Every case of the reference's tests/test_remote_gateway.py runs
  twice, `[reference]` on the JAX package's cluster and gateway and
  `[port]` on the port's (tests/torch_port_cases.py rebinds the case's
  names): the primary storage found alone, a bucket mkdir creating the
  remote bucket and its mount, object writes and deletes mirrored, the
  include / exclude globs, the bucket path parsing.
  `test_bucket_delete_removes_remote_and_mount` races in the reference
  (the gateway removes the remote bucket before it saves the mapping
  without it): both sides run a version that waits for both.
* Each package's RemoteGateway mirrors a bucket's life on the other
  package's filer, the random suffix included, and resumes from its
  offset in the filer KV after a restart without mirroring an event
  twice.
"""
import functools
import os
import time

import pytest
import requests

from seaweedfs_tpu.remote_storage import mount as ref_mount
from seaweedfs_tpu.remote_storage.gateway import RemoteGateway as RefGateway
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.remote_storage import mount as port_mount
from seaweedfs_tpu_torch.remote_storage.gateway import RemoteGateway
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_remote_gateway as ref_cases
from tests.torch_port_cases import call_case, port_cases, within

PortCluster = functools.partial(Cluster, ec_backend="native")
RACY = "test_bucket_delete_removes_remote_and_mount"
SIDES = {
    "reference": port_cases(ref_cases, skip=(RACY,)),
    "port": port_cases(ref_cases, skip=(RACY,), Cluster=PortCluster,
                       RemoteGateway=RemoteGateway,
                       RemoteConf=port_mount.RemoteConf,
                       load_conf=port_mount.load_conf,
                       save_conf=port_mount.save_conf),
}
CASES = list(SIDES["port"])
PKG = {"reference": dict(Cluster=RefCluster, Gateway=RefGateway,
                         mount=ref_mount),
       "port": dict(Cluster=PortCluster, Gateway=RemoteGateway,
                    mount=port_mount)}


def test_every_reference_case_is_mirrored():
    assert CASES == [k for k in port_cases(ref_cases) if k != RACY]
    assert CASES == list(SIDES["reference"]) and len(CASES) == 6


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {}
    try:
        for side, pkg in PKG.items():
            out[side] = within(60, pkg["Cluster"], str(
                tmp_path_factory.mktemp(f"gw_{side}")),
                n_volume_servers=1, volume_size_limit=8 << 20,
                with_filer=True)
        yield out
    finally:
        for c in out.values():
            within(30, c.stop)


@pytest.fixture(scope="module")
def gateways(clusters, tmp_path_factory):
    """The reference fixture's gateway over a local storage, per side."""
    out = {}
    try:
        for side, pkg in PKG.items():
            cloud = tmp_path_factory.mktemp(f"gw_cloud_{side}")
            pkg["mount"].save_conf(clusters[side].filer_url,
                                   pkg["mount"].RemoteConf(storages={
                                       "cloud1": {"type": "local",
                                                  "root": str(cloud)}}))
            g = pkg["Gateway"](clusters[side].filer_url)
            g.start()
            out[side] = (g, str(cloud))
        yield out
    finally:
        for g, _ in out.values():
            within(5, g.stop)


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, side, clusters, gateways):
    call_case(SIDES[side][case], {"cluster": clusters[side],
                                  "gateway": gateways[side]})


def _wait(pred, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} never became true")


@pytest.mark.parametrize("side", list(PKG))
def test_bucket_delete_removes_remote_and_mount(side, clusters, gateways):
    """The reference case, waiting for the mapping's removal too."""
    c, (g, cloud) = clusters[side], gateways[side]
    load = PKG[side]["mount"].load_conf
    requests.post(f"{c.filer_url}/buckets/scratch/",
                  params={"mkdir": "1"}, timeout=30).raise_for_status()
    _wait(lambda: os.path.isdir(os.path.join(cloud, "scratch")),
          what="remote bucket dir")
    _wait(lambda: "/buckets/scratch" in load(c.filer_url).mounts,
          what="the mount mapping")
    requests.delete(f"{c.filer_url}/buckets/scratch/",
                    params={"recursive": "true"},
                    timeout=30).raise_for_status()
    _wait(lambda: not os.path.isdir(os.path.join(cloud, "scratch")),
          what="remote bucket removal")
    _wait(lambda: "/buckets/scratch" not in load(c.filer_url).mounts,
          what="the mapping's removal")


@pytest.mark.parametrize("gateway,filer", [("reference", "port"),
                                           ("port", "reference")])
def test_gateway_across_packages(gateway, filer, clusters, tmp_path):
    c = clusters[filer]
    mount = PKG[filer]["mount"]
    cloud = tmp_path / "xcloud"
    cloud.mkdir()
    conf = mount.load_conf(c.filer_url)
    conf.storages["xs"] = {"type": "local", "root": str(cloud)}
    mount.save_conf(c.filer_url, conf)
    g = PKG[gateway]["Gateway"](c.filer_url, create_bucket_at="xs",
                                bucket_suffix=True, include="x*",
                                buckets_dir="/xb")
    g.start()
    try:
        for b in ("xone", "skipme"):
            requests.post(f"{c.filer_url}/xb/{b}/", params={"mkdir": "1"},
                          timeout=30).raise_for_status()
        _wait(lambda: "/xb/xone" in mount.load_conf(c.filer_url).mounts,
              what="the bucket's mapping")
        remote = mount.load_conf(c.filer_url).mounts["/xb/xone"].remote_path
        assert remote.startswith("xone-") and len(remote) == 13
        assert (cloud / remote).is_dir()
        requests.post(f"{c.filer_url}/xb/xone/o.bin", data=b"o" * 777,
                      timeout=30).raise_for_status()
        _wait(lambda: (cloud / remote / "o.bin").exists(),
              what="the mirrored object")
        assert (cloud / remote / "o.bin").read_bytes() == b"o" * 777
        assert "/xb/skipme" not in mount.load_conf(c.filer_url).mounts
        g.stop()
        # a restart resumes from the saved offset: nothing twice
        created = g.buckets_created
        g2 = PKG[gateway]["Gateway"](c.filer_url, create_bucket_at="xs",
                                     bucket_suffix=True, include="x*",
                                     buckets_dir="/xb")
        g2.start()
        try:
            requests.delete(f"{c.filer_url}/xb/xone/", params={
                "recursive": "true"}, timeout=30).raise_for_status()
            _wait(lambda: not (cloud / remote).exists(),
                  what="the remote bucket's removal")
            _wait(lambda: "/xb/xone" not in
                  mount.load_conf(c.filer_url).mounts,
                  what="the mapping's removal")
            assert (created, g2.buckets_created, g2.buckets_deleted) == \
                (1, 0, 1)
        finally:
            within(5, g2.stop)
    finally:
        within(5, g.stop)
