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
    if name.startswith("random"):   # "random<m>x<k>", seeded
        m, k = (int(v) for v in name[len("random"):].split("x"))
        return np.random.default_rng(m * 100 + k).integers(
            0, 256, (m, k), dtype=np.uint8)
    present = [i for i in range(14) if i not in (1, 4, 11, 13)]
    return rs_matrix.recovery_rows(10, 4, present, [1, 4, 11, 13])[0]


def _pallas_operands(coef):
    bits = gf256.expand_to_bits(coef)
    return (codec_pallas.plane_major_bit_matrix(bits),
            codec_pallas.packing_matrix(coef.shape[0]))


def _pallas(coef, x):
    """The Pallas kernel in interpret mode, with the columns zero-padded
    to a multiple of COL_TILE as PallasCodec._pad_width pads them, and
    the padding sliced off."""
    n = x.shape[1]
    padded = np.zeros((x.shape[0], n + (-n) % codec_pallas.COL_TILE),
                      dtype=np.uint8)
    padded[:, :n] = x
    a_pm, pack = _pallas_operands(coef)
    return np.asarray(codec_pallas.coded_matmul_pallas_pm(
        a_pm, pack, jnp.asarray(padded), interpret=True))[:, :n]


def _plain(coef, x):
    tables = torch.from_numpy(codec_cuda.packed_tables(coef))
    return codec_cuda.coded_matmul_plain(
        tables, torch.from_numpy(x), coef.shape[0]).numpy()


@pytest.mark.parametrize("code", ["rs10.4", "rs28.4", "recover1",
                                  "recover4"])
def test_plain_matches_pallas_interpret(code):
    coef = _coef(code)
    rng = np.random.default_rng(len(code))
    x = rng.integers(0, 256, (coef.shape[1], codec_pallas.COL_TILE),
                     dtype=np.uint8)
    assert np.array_equal(_plain(coef, x), _pallas(coef, x))


@pytest.mark.parametrize("n", [1, 15, 16, 4095, 4097])
@pytest.mark.parametrize("code", ["rs10.4", "recover1", "random3x10",
                                  "random5x7"])
def test_plain_matches_pallas_at_ragged_widths(code, n):
    coef = _coef(code)
    rng = np.random.default_rng(n)
    x = rng.integers(0, 256, (coef.shape[1], n), dtype=np.uint8)
    got = _plain(coef, x)
    assert got.shape == (coef.shape[0], n) and got.dtype == np.uint8
    assert np.array_equal(got, _pallas(coef, x))
    assert np.array_equal(got, codec_numpy.coded_matmul(coef, x))


@pytest.mark.parametrize("code", ["rs10.4", "rs28.4", "recover4",
                                  "recover1", "random5x10"])
def test_carry_across_pallas_operands(code):
    coef = _coef(code)
    a_pm, pack = _pallas_operands(coef)
    tables = codec_cuda.operands_from_pallas(
        np.asarray(a_pm, dtype=np.float32), np.asarray(pack, np.float32))
    m, k = coef.shape
    assert tables.shape == (-(-m // 4), k, 256) and tables.dtype == np.int32
    assert np.array_equal(tables, codec_cuda.packed_tables(coef))
    # the word at byte value 1 packs the coefficients themselves
    ones = np.ascontiguousarray(tables[..., 1]).view(np.uint8)
    ones = ones.reshape(-1, k, 4)
    assert np.array_equal(ones.transpose(0, 2, 1).reshape(-1, k)[:m], coef)


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
    t = codec_cuda.packed_tables(coef)
    assert t.flags.c_contiguous and t.shape == (1, 10, 256)
    for i, j, v in [(0, 0, 7), (3, 9, 255), (2, 4, 0)]:
        word = int(t[0, j, v]) & 0xffffffff
        assert (word >> (8 * i)) & 0xff == gf256.gf_mul(int(coef[i, j]), v)


@pytest.mark.parametrize("k", [1, 10, 28, 40])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8])
def test_packed_tables_match_mul_table(m, k):
    coef = np.random.default_rng(1000 * m + k).integers(
        0, 256, (m, k), dtype=np.uint8)
    t = codec_cuda.packed_tables(coef)
    groups = -(-m // 4)
    assert t.shape == (groups, k, 256) and t.dtype == np.int32
    # little-endian bytes of each word: (groups, k, 256, 4) -> rows 4g + o
    b = t.view(np.uint8).reshape(groups, k, 256, 4)
    rows = b.transpose(0, 3, 1, 2).reshape(4 * groups, k, 256)
    assert np.array_equal(rows[:m], gf256.MUL_TABLE[coef])
    assert not rows[m:].any()


def test_plain_beyond_one_launch_of_rows():
    # k above MAX_K_PER_LAUNCH: the wrapper splits it into launches on
    # the card; the plain version takes it whole
    k = codec_cuda.MAX_K_PER_LAUNCH + 6
    coef = _coef(f"random3x{k}")
    x = np.random.default_rng(k).integers(0, 256, (k, 5000), dtype=np.uint8)
    assert np.array_equal(_plain(coef, x), codec_numpy.coded_matmul(coef, x))


@pytest.mark.parametrize("n", [1, 4095, 4097, 10000])
def test_wrapper_on_cpu_runs_plain_and_counts_nothing(n):
    coef = _coef("rs10.4")
    rng = np.random.default_rng(n)
    x = rng.integers(0, 256, (10, n), dtype=np.uint8)
    tables = torch.from_numpy(codec_cuda.packed_tables(coef))
    before = codec_cuda.coded_matmul.launches
    got = codec_cuda.coded_matmul(tables, torch.from_numpy(x), 4)
    assert codec_cuda.coded_matmul.launches == before
    assert np.array_equal(got.numpy(), codec_numpy.coded_matmul(coef, x))


def test_wrapper_strided_column_views():
    coef = _coef("recover4")
    rng = np.random.default_rng(9)
    wide = rng.integers(0, 256, (10, 5000), dtype=np.uint8)
    tables = torch.from_numpy(codec_cuda.packed_tables(coef))
    view = torch.from_numpy(wide)[:, 13:13 + 3001]
    assert not view.is_contiguous()
    got = codec_cuda.coded_matmul(tables, view, 4)
    assert np.array_equal(got.numpy(), codec_numpy.coded_matmul(
        coef, wide[:, 13:13 + 3001]))
    empty = codec_cuda.coded_matmul(tables, torch.from_numpy(wide)[:, :0], 4)
    assert tuple(empty.shape) == (4, 0)


def test_wrapper_writes_into_a_given_out():
    """`out=` (what the feed allocates ahead of its events): a column
    view of a wider tensor, row stride above its width, is written in
    place; anything not (m, n) uint8 with contiguous rows raises."""
    coef = _coef("rs10.4")
    rng = np.random.default_rng(12)
    x = rng.integers(0, 256, (10, 3001), dtype=np.uint8)
    tables = torch.from_numpy(codec_cuda.packed_tables(coef))
    wide = torch.zeros((4, 5000), dtype=torch.uint8)
    view = wide[:, 7:7 + 3001]
    got = codec_cuda.coded_matmul(tables, torch.from_numpy(x), 4, out=view)
    assert got.data_ptr() == view.data_ptr()
    assert np.array_equal(wide[:, 7:7 + 3001].numpy(),
                          codec_numpy.coded_matmul(coef, x))
    assert not wide[:, :7].any() and not wide[:, 7 + 3001:].any()
    for bad in (torch.empty((4, 3000), dtype=torch.uint8),
                torch.empty((3, 3001), dtype=torch.uint8),
                torch.empty((4, 3001), dtype=torch.int16),
                torch.empty((3001, 4), dtype=torch.uint8).t()):
        with pytest.raises(ValueError):
            codec_cuda.coded_matmul(tables, torch.from_numpy(x), 4, out=bad)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tables = torch.from_numpy(codec_cuda.packed_tables(_coef("rs10.4")))
    x = torch.zeros((10, 64), dtype=torch.uint8)
    with pytest.raises(TypeError):
        codec_cuda.coded_matmul(tables, x.to(torch.int16), 4)
    with pytest.raises(TypeError):
        codec_cuda.coded_matmul(tables.to(torch.uint8), x, 4)
    with pytest.raises(ValueError):
        codec_cuda.coded_matmul(tables, x[:9], 4)
    with pytest.raises(ValueError):
        codec_cuda.coded_matmul(tables[..., :128], x, 4)
    with pytest.raises(ValueError):
        codec_cuda.coded_matmul(tables, x.reshape(10, 8, 8), 4)
    with pytest.raises(ValueError):
        codec_cuda.coded_matmul(tables.to("meta"), x, 4)
    with pytest.raises(ValueError):   # one packed group holds m <= 4
        codec_cuda.coded_matmul(tables, x, 5)
    with pytest.raises(ValueError):
        codec_cuda.coded_matmul(tables, x, 0)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    assert _build.sources() == ["coded_matmul"]
    path = _build.library_path("coded_matmul")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert path == _build.library_path("coded_matmul")  # stable hash
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
