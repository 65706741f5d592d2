"""The reference's two race scenarios for the native fronts, on the port
and on the JAX package (tests/test_native_front_races.py, each case
`[reference|port]`):

1. the S3 front's cache under concurrent mixed-path mutations — native
   PUTs racing Python-path overwrites and deletes of the same keys never
   serve a stale or torn read, and the final native GETs agree with the
   filer byte for byte (the port's `Cluster(with_s3=True,
   s3_native=True)`);
2. the replica channel's recovery — a peer volume server SIGKILLed and
   restarted mid-load: writes fail loudly while it is down, then the
   native fan-out takes over again (processes; tests/torch_port_procs.py
   runs the argv on `seaweedfs_tpu_torch`).
"""
import functools

import pytest

from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_native_front_races as ref_cases
from tests import torch_port_procs
from tests.torch_port_cases import call_case, port_cases

SIDES = {
    "reference": port_cases(ref_cases),
    "port": port_cases(ref_cases,
                       Cluster=functools.partial(Cluster,
                                                 ec_backend="native"),
                       subprocess=torch_port_procs),
}


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", list(SIDES["port"]))
def test_reference_case(case, side, tmp_path):
    call_case(SIDES[side][case], {"tmp_path": tmp_path})
