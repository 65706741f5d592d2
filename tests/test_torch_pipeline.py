"""The batched encode + scrub step of the port (seaweedfs_tpu_torch/
models/ec_pipeline.py) against the reference's jitted step under JAX on
the CPU, on the same seeded numpy stripes. Tolerance 0 (integer GF(256)
arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.models import ec_pipeline as ref_pipeline
from seaweedfs_tpu_torch.models import ec_pipeline as port_pipeline
from seaweedfs_tpu_torch.ops import codec_numpy, rs_matrix


@pytest.mark.parametrize("k,m", [(10, 4), (28, 4)])
def test_parity_bit_matrix(k, m):
    assert np.array_equal(port_pipeline.parity_bit_matrix(k, m),
                          ref_pipeline.parity_bit_matrix(k, m))


@pytest.mark.parametrize("k,m,batch,n", [(10, 4, 3, 777), (28, 4, 2, 64),
                                         (10, 4, 1, 1)])
def test_encode_batch_matches_reference(k, m, batch, n):
    rng = np.random.default_rng(batch * n)
    stripes = rng.integers(0, 256, (batch, k, n), dtype=np.uint8)
    a_bits = port_pipeline.parity_bit_matrix(k, m)
    want = np.asarray(ref_pipeline.encode_batch(
        jnp.asarray(a_bits, dtype=jnp.bfloat16), jnp.asarray(stripes)))
    got = port_pipeline.encode_batch(a_bits, stripes, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (batch, m, n)
    assert np.array_equal(got.numpy(), want)


def test_encode_batch_chunks_the_expansion(monkeypatch):
    monkeypatch.setattr(port_pipeline, "_EXPANSION_BYTES", 1)
    rng = np.random.default_rng(2)
    stripes = rng.integers(0, 256, (5, 10, 300), dtype=np.uint8)
    got = port_pipeline.encode_batch(port_pipeline.parity_bit_matrix(),
                                     torch.from_numpy(stripes),
                                     device="cpu")
    coef = rs_matrix.parity_rows(10, 4)
    for b in range(5):
        assert np.array_equal(got[b].numpy(),
                              codec_numpy.coded_matmul(coef, stripes[b]))


def test_scrub_counts_mismatches():
    rng = np.random.default_rng(9)
    stripes = rng.integers(0, 256, (4, 10, 500), dtype=np.uint8)
    a_bits = port_pipeline.parity_bit_matrix()
    coef = rs_matrix.parity_rows(10, 4)
    expected = np.stack([codec_numpy.coded_matmul(coef, s) for s in stripes])
    parity, mism = port_pipeline.encode_scrub_step(a_bits, stripes,
                                                   expected, device="cpu")
    _, ref_mism = ref_pipeline.encode_scrub_step(
        jnp.asarray(a_bits, dtype=jnp.bfloat16), jnp.asarray(stripes),
        jnp.asarray(expected))
    assert int(mism) == int(ref_mism) == 0
    assert np.array_equal(parity.numpy(), expected)
    expected[2, 1, 123] ^= 0x01
    _, mism = port_pipeline.encode_scrub_step(a_bits, stripes, expected,
                                              device="cpu")
    _, ref_mism = ref_pipeline.encode_scrub_step(
        jnp.asarray(a_bits, dtype=jnp.bfloat16), jnp.asarray(stripes),
        jnp.asarray(expected))
    assert int(mism) == int(ref_mism) == 1


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stripes = np.zeros((1, 10, 8), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_pipeline.encode_batch(port_pipeline.parity_bit_matrix(),
                                   stripes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_pipeline.encode_scrub_step(port_pipeline.parity_bit_matrix(),
                                        stripes, stripes[:, :4])
