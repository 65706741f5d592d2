"""Torch bit-plane ops (seaweedfs_tpu_torch/ops/bits.py) against
seaweedfs_tpu.ops.bits under JAX on the CPU, on the same seeded numpy
inputs. Tolerance 0: the planes are 0/1 and every product sum is an
integer held exactly in float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import bits as ref_bits
from seaweedfs_tpu.ops import gf256, rs_matrix
from seaweedfs_tpu_torch.ops import bits as port_bits


def _coef(name):
    if name == "rs10.4":
        return rs_matrix.parity_rows(10, 4)
    if name == "rs28.4":
        return rs_matrix.parity_rows(28, 4)
    present = [i for i in range(14) if i not in (1, 4, 11, 13)]
    return rs_matrix.recovery_rows(10, 4, present, [1, 4, 11, 13])[0]


@pytest.mark.parametrize("shape", [(10, 1), (10, 777), (2, 3, 64)])
def test_unpack_bits_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(ref_bits.unpack_bits_bf16(jnp.asarray(x)),
                      dtype=np.float32)
    got = port_bits.unpack_bits(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(32, 5), (80, 999), (3, 16, 40)])
def test_pack_bits_matches_reference(shape):
    rng = np.random.default_rng(shape[-1])
    b = rng.integers(0, 2, shape, dtype=np.int32)
    want = np.asarray(ref_bits.pack_bits_uint8(jnp.asarray(b)))
    got = port_bits.pack_bits_uint8(torch.from_numpy(b))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("code", ["rs10.4", "rs28.4", "recover4"])
@pytest.mark.parametrize("n", [1, 4095, 4097])
def test_coded_matmul_bits_matches_reference(code, n):
    coef = _coef(code)
    rng = np.random.default_rng(n)
    x = rng.integers(0, 256, (coef.shape[1], n), dtype=np.uint8)
    a_bits = gf256.expand_to_bits(coef)
    want = np.asarray(ref_bits.coded_matmul_bits(
        jnp.asarray(a_bits, dtype=jnp.bfloat16), jnp.asarray(x)))
    got = port_bits.coded_matmul_bits(
        torch.from_numpy(a_bits.astype(np.float32)), torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)


def test_roundtrip_and_cpu_exactness_check():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (7, 100), dtype=np.uint8))
    assert torch.equal(port_bits.pack_bits_uint8(
        port_bits.unpack_bits(x, torch.int32)), x)
    port_bits.check_exact_matmul(x)  # CPU tensors never run in TF32
