"""The CUDA kernel's plain version and wrapper (seaweedfs_tpu_torch/ops/
codec_cuda.py) against the Pallas kernel it replaces, run in interpret
mode on the CPU as tests/test_codec_pallas.py runs it, on the same
seeded numpy inputs. Tolerance 0 (integer GF(256) arithmetic). The
kernel itself runs only on a GPU; chip_smoke.py holds it against this
plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import codec_numpy, codec_pallas, gf256, rs_matrix
from seaweedfs_tpu_torch.ops import _build, codec_cuda


def _coef(name):
    if name == "rs10.4":
        return rs_matrix.parity_rows(10, 4)
    if name == "rs28.4":
        return rs_matrix.parity_rows(28, 4)
    if name == "recover1":
        return rs_matrix.recovery_rows(
            10, 4, [i for i in range(14) if i != 3], [3])[0]
    present = [i for i in range(14) if i not in (1, 4, 11, 13)]
    return rs_matrix.recovery_rows(10, 4, present, [1, 4, 11, 13])[0]


def _pallas_operands(coef):
    bits = gf256.expand_to_bits(coef)
    return (codec_pallas.plane_major_bit_matrix(bits),
            codec_pallas.packing_matrix(coef.shape[0]))


@pytest.mark.parametrize("code", ["rs10.4", "rs28.4", "recover1",
                                  "recover4"])
def test_plain_matches_pallas_interpret(code):
    coef = _coef(code)
    rng = np.random.default_rng(len(code))
    x = rng.integers(0, 256, (coef.shape[1], codec_pallas.COL_TILE),
                     dtype=np.uint8)
    a_pm, pack = _pallas_operands(coef)
    want = np.asarray(codec_pallas.coded_matmul_pallas_pm(
        a_pm, pack, jnp.asarray(x), interpret=True))
    tables = torch.from_numpy(codec_cuda.product_tables(coef))
    got = codec_cuda.coded_matmul_plain(tables, torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("code", ["rs10.4", "rs28.4", "recover4"])
def test_carry_across_pallas_operands(code):
    coef = _coef(code)
    a_pm, pack = _pallas_operands(coef)
    tables = codec_cuda.operands_from_pallas(
        np.asarray(a_pm, dtype=np.float32), np.asarray(pack, np.float32))
    assert tables.shape == coef.shape + (256,) and tables.dtype == np.uint8
    assert np.array_equal(tables, codec_cuda.product_tables(coef))
    assert np.array_equal(tables[..., 1], coef)


def test_carry_across_rejects_foreign_matrices():
    a_pm, pack = _pallas_operands(_coef("rs10.4"))
    a = np.asarray(a_pm, dtype=np.float32)
    p = np.asarray(pack, dtype=np.float32)
    with pytest.raises(ValueError):
        codec_cuda.operands_from_pallas(a, p[:, ::-1])
    broken = a.copy()
    broken[0, 5 * 10 + 3] = 1 - broken[0, 5 * 10 + 3]  # a bit-5 column
    with pytest.raises(ValueError):
        codec_cuda.operands_from_pallas(broken, p)
    with pytest.raises(ValueError):
        codec_cuda.operands_from_pallas(a[:5], p)


def test_product_tables():
    coef = _coef("recover4")
    t = codec_cuda.product_tables(coef)
    assert t.flags.c_contiguous
    for i, j, v in [(0, 0, 7), (3, 9, 255), (2, 4, 0)]:
        assert t[i, j, v] == gf256.gf_mul(int(coef[i, j]), v)


@pytest.mark.parametrize("n", [1, 4095, 4097, 10000])
def test_wrapper_on_cpu_runs_plain_and_counts_nothing(n):
    coef = _coef("rs10.4")
    rng = np.random.default_rng(n)
    x = rng.integers(0, 256, (10, n), dtype=np.uint8)
    tables = torch.from_numpy(codec_cuda.product_tables(coef))
    before = codec_cuda.coded_matmul.launches
    got = codec_cuda.coded_matmul(tables, torch.from_numpy(x))
    assert codec_cuda.coded_matmul.launches == before
    assert np.array_equal(got.numpy(), codec_numpy.coded_matmul(coef, x))


def test_wrapper_strided_column_views():
    coef = _coef("recover4")
    rng = np.random.default_rng(9)
    wide = rng.integers(0, 256, (10, 5000), dtype=np.uint8)
    tables = torch.from_numpy(codec_cuda.product_tables(coef))
    view = torch.from_numpy(wide)[:, 13:13 + 3001]
    assert not view.is_contiguous()
    got = codec_cuda.coded_matmul(tables, view)
    assert np.array_equal(got.numpy(), codec_numpy.coded_matmul(
        coef, wide[:, 13:13 + 3001]))
    empty = codec_cuda.coded_matmul(tables, torch.from_numpy(wide)[:, :0])
    assert tuple(empty.shape) == (4, 0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tables = torch.from_numpy(codec_cuda.product_tables(_coef("rs10.4")))
    x = torch.zeros((10, 64), dtype=torch.uint8)
    with pytest.raises(TypeError):
        codec_cuda.coded_matmul(tables, x.to(torch.int16))
    with pytest.raises(TypeError):
        codec_cuda.coded_matmul(tables.to(torch.int32), x)
    with pytest.raises(ValueError):
        codec_cuda.coded_matmul(tables, x[:9])
    with pytest.raises(ValueError):
        codec_cuda.coded_matmul(tables[..., :128], x)
    with pytest.raises(ValueError):
        codec_cuda.coded_matmul(tables, x.reshape(10, 8, 8))
    with pytest.raises(ValueError):
        codec_cuda.coded_matmul(tables.to("meta"), x)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    assert _build.sources() == ["coded_matmul"]
    path = _build.library_path("coded_matmul")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert path == _build.library_path("coded_matmul")  # stable hash
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
