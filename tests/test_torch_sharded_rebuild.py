"""The port's sharded rebuild (seaweedfs_tpu_torch/models/ec_pipeline.py
`sharded_rebuild` over `rebuild_mesh`) against the reference's, which
spreads the surviving shards' bit rows over JAX's 8 forced CPU devices
and folds the partial parities with a reduce-scatter
(tests/test_sharded_rebuild.py). The port runs on a CPU mesh, where
the collective is its plain version. Tolerance 0."""
import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.models import ec_pipeline as ref_ep
from seaweedfs_tpu_torch.models import ec_pipeline as ep
from seaweedfs_tpu_torch.ops import codec_numpy
from seaweedfs_tpu_torch.parallel import mesh as pmesh

MISSING = [0, 3, 11, 13]
PRESENT = [i for i in range(14) if i not in MISSING]


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_rebuild_matches_reference(d):
    assert len(jax.devices()) >= d, "conftest provides 8 cpu devices"
    rebuild, a_bits, coef = ep.sharded_rebuild(
        ep.rebuild_mesh(d, device="cpu"), present=PRESENT, missing=MISSING)
    ref_rebuild, ref_a, ref_coef = ref_ep.sharded_rebuild(
        ref_ep.rebuild_mesh(d), present=PRESENT, missing=MISSING)
    assert np.array_equal(coef, ref_coef)
    assert np.array_equal(a_bits, np.asarray(ref_a, dtype=np.float32))
    rng = np.random.default_rng(d)
    shards = rng.integers(0, 256, (10, 8 * 8 * 131), dtype=np.uint8)
    got = rebuild(a_bits, shards).gather().numpy()
    assert np.array_equal(got, np.asarray(ref_rebuild(ref_a, shards)))
    assert np.array_equal(got, codec_numpy.coded_matmul(coef, shards))


@pytest.mark.parametrize("d", [2, 8])
def test_output_is_column_sharded(d):
    mesh = ep.rebuild_mesh(d, device="cpu")
    rebuild, a_bits, _ = ep.sharded_rebuild(mesh)
    shards = np.random.default_rng(1).integers(0, 256, (10, 4096),
                                               dtype=np.uint8)
    out = rebuild(a_bits, shards)
    # each device holds its column slice of the rebuilt shards
    assert len(out.pieces) == d and out.shape == (4, 4096)
    for i, (t, idx) in enumerate(out.pieces):
        assert t.shape == (4, 4096 // d)
        assert idx[1] == slice(i * 4096 // d, (i + 1) * 4096 // d)


def test_partials_stay_int32_until_the_and(monkeypatch):
    """The per-device products are int32 counts (above 1: the sum is
    not yet mod 2), the reduce-scatter moves int32, and only its result
    is folded with & 1."""
    mesh = ep.rebuild_mesh(4, device="cpu")
    rebuild, a_bits, coef = ep.sharded_rebuild(mesh, present=PRESENT,
                                               missing=MISSING)
    shards = np.random.default_rng(2).integers(0, 256, (10, 2048),
                                               dtype=np.uint8)
    partials = rebuild.partials(a_bits, shards)
    assert [p.dtype for p in partials] == [torch.int32] * 4
    assert [tuple(p.shape) for p in partials] == [(32, 2048)] * 4
    assert max(int(p.max()) for p in partials) > 1
    seen = []
    real = pmesh.reduce_scatter_sum

    def spy(inputs, outputs, streams=None):
        seen.append(({t.dtype for t in inputs}, {t.dtype for t in outputs}))
        real(inputs, outputs, streams)
        seen.append(max(int(t.max()) for t in outputs))

    monkeypatch.setattr(pmesh, "reduce_scatter_sum", spy)
    got = rebuild.reduce(partials).gather().numpy()
    assert seen[0] == ({torch.int32}, {torch.int32}) and seen[1] > 1
    assert np.array_equal(got, codec_numpy.coded_matmul(coef, shards))


def test_asserts_of_the_reference():
    # 8k bit rows must divide over the devices, n over 8 x the devices
    with pytest.raises(AssertionError):
        ep.sharded_rebuild(ep.rebuild_mesh(3, device="cpu"))
    with pytest.raises(AssertionError):
        ref_ep.sharded_rebuild(ref_ep.rebuild_mesh(3))
    rebuild, a_bits, _ = ep.sharded_rebuild(ep.rebuild_mesh(4,
                                                            device="cpu"))
    with pytest.raises(AssertionError):
        rebuild(a_bits, np.zeros((10, 8 * 4 + 4), dtype=np.uint8))


def test_collectives_plain_versions():
    rng = np.random.default_rng(3)
    vals = [torch.from_numpy(rng.integers(-50, 50, (3, 8), dtype=np.int32))
            for _ in range(4)]
    total = sum(v.numpy().astype(np.int64) for v in vals)
    red = [v.clone() for v in vals]
    pmesh.all_reduce_sum(red)
    assert all(np.array_equal(r.numpy(), total) for r in red)
    outs = [torch.empty(6, dtype=torch.int32) for _ in range(4)]
    pmesh.reduce_scatter_sum(vals, outs)
    assert np.array_equal(torch.cat(outs).numpy(), total.reshape(-1))
    assert {o.dtype for o in outs} == {torch.int32}
