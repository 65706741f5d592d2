"""JWT and replication=001 served by the port's native data plane,
against the JAX package's, as processes.

Every case of the reference's tests/test_native_replication_e2e.py runs
twice, `[reference]` on `python -m seaweedfs_tpu` processes and `[port]`
on `python -m seaweedfs_tpu_torch` (tests/torch_port_procs.py rewrites
the argv; the volume servers run `-dataplane native -ec.backend
native`): a jwt-guarded master and two volume servers behind their C++
fronts. A guarded replicated write must fan out from C++ (the primary's
`repl_post` counter moves), land on both servers and be refused
unsigned; a guarded replicated delete tombstones every copy; with the
peer SIGKILLed, writes fail loudly instead of acking one copy.
"""
import contextlib
import types

import pytest

from tests import test_native_replication_e2e as ref_cases
from tests import torch_port_procs
from tests.torch_port_cases import call_case, port_cases, swap_modules

SIDES = {
    "reference": (port_cases(ref_cases), vars(ref_cases)),
    "port": (port_cases(ref_cases, subprocess=torch_port_procs),
             {**vars(ref_cases), "subprocess": torch_port_procs}),
}


@pytest.fixture(scope="module", params=list(SIDES))
def side(request, tmp_path_factory):
    """(side, its cases, the reference's cluster fixture run with the
    side's globals)."""
    cases, g = SIDES[request.param]
    fn = ref_cases.cluster._get_wrapped_function()
    gen = types.FunctionType(fn.__code__, g, fn.__name__)(tmp_path_factory)
    yield request.param, cases, next(gen)
    with contextlib.suppress(StopIteration):
        next(gen)


# definition order: test_z_dead_peer_fails_writes_loudly kills a server
# the others need, and runs last on each side
@pytest.mark.parametrize("case", list(SIDES["port"][0]))
def test_reference_case(case, side):
    name, cases, cluster = side
    # a case that imports subprocess in its body gets the shim too
    with swap_modules({"subprocess": torch_port_procs}
                      if name == "port" else {}):
        call_case(cases[case], {"cluster": cluster})
