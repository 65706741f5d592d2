"""The plain reference against the field's definition and against the
port's seal and scrub at a size a test run holds (CPU codec)."""
import itertools

import numpy as np
import pytest
import torch

from bench_port.reference import codes, encode, gf256

RS = {"code_kind": "rs", "data_shards": 10, "parity_shards": 4}
LRC = {"code_kind": "lrc", "data_shards": 12, "local_parities": 2,
       "global_parities": 2}
LARGE, SMALL, CHUNK = 65536, 16384, 65536


def test_field_tables_and_inverse():
    t = gf256.mul_table()
    for a, b in ((7, 9), (0x53, 0xca), (255, 255), (0, 17)):
        assert t[a, b] == gf256.mul(a, b) == gf256.mul(b, a)
    assert gf256.mul(2, 0x80) == 0x1d        # x^8 = x^4 + x^3 + x^2 + 1
    for a in range(1, 256):
        assert gf256.mul(a, gf256.inv(a)) == 1
    m = [[1, 2, 3], [4, 5, 6], [7, 8, 10]]
    assert gf256.mat_mul(m, gf256.mat_inv(m)) == [[1, 0, 0], [0, 1, 0],
                                                  [0, 0, 1]]


def test_rs_rows_are_klauspost_systematic_vandermonde():
    rows = codes.parity_rows(RS)
    assert rows.shape == (4, 10)
    assert rows[0].tolist() == [129, 150, 175, 184, 210, 196, 254, 232, 3, 2]
    full = np.vstack([np.eye(10, dtype=np.uint8), rows]).tolist()
    # maximum distance separable: any 10 of the 14 rows are invertible
    for drop in itertools.islice(itertools.combinations(range(14), 4), 0,
                                 1001, 50):
        gf256.mat_inv([full[i] for i in range(14) if i not in drop])


def test_lrc_rows_are_group_xor_then_global_rs_rows():
    rows = codes.parity_rows(LRC)
    assert rows.shape == (4, 12)
    assert rows[0].tolist() == [1] * 6 + [0] * 6
    assert rows[1].tolist() == [0] * 6 + [1] * 6
    assert rows[2:].tolist() == codes.rs_parity_rows(12, 4)[2:]
    assert codes.shard_counts(LRC) == (12, 4)


@pytest.mark.parametrize("size", [0, 1, 10 * SMALL, 10 * SMALL + 1,
                                  3 * 10 * LARGE + 5 * SMALL + 11,
                                  2 * 10 * LARGE])
def test_row_layout_is_seaweedfs(size):
    k, remaining, n_large, n_small = 10, size, 0, 0
    while remaining > LARGE * k:
        n_large, remaining = n_large + 1, remaining - LARGE * k
    while remaining > 0:
        n_small, remaining = n_small + 1, remaining - SMALL * k
    assert encode.row_layout(size, LARGE, SMALL, k) == (n_large, n_small)


def _seal(tmp_path, config, spec, dat):
    from seaweedfs_tpu_torch.ec import encoder
    from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec

    base = str(tmp_path / "1")
    dat.tofile(base + ".dat")
    encoder.write_ec_files(base, backend=CudaCodec(device="cpu"),
                           large_block=LARGE, small_block=SMALL, chunk=CHUNK,
                           codec=spec)
    return base


@pytest.mark.parametrize("config, spec", [(RS, ""), (LRC, "lrc-12.2.2")])
def test_reference_equals_a_tiny_seal_of_the_port(tmp_path, config, spec):
    k, m = codes.shard_counts(config)
    dat = np.random.default_rng(1).integers(
        0, 256, 3 * k * LARGE + 5 * SMALL + 11, dtype=np.uint8)
    base = _seal(tmp_path, config, spec, dat)
    data = encode.data_shards(torch.from_numpy(dat), k, LARGE, SMALL)
    want = torch.cat([data, encode.coded_matmul(codes.parity_rows(config),
                                                data)]).numpy()
    assert want.shape[1] == encode.shard_bytes(dat.size, LARGE, SMALL, k)
    for i in range(k + m):
        got = np.fromfile(f"{base}.ec{i:02d}", dtype=np.uint8)
        assert np.array_equal(got, want[i]), f"shard {i}"


def test_reference_verdicts_equal_a_tiny_scrub_of_the_port(tmp_path):
    from seaweedfs_tpu_torch.ec.backend import ReedSolomon
    from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec

    dat = np.random.default_rng(2).integers(0, 256, 2 * 12 * LARGE + 999,
                                            dtype=np.uint8)
    base = _seal(tmp_path, LRC, "lrc-12.2.2", dat)
    shards = np.stack([np.fromfile(f"{base}.ec{i:02d}", dtype=np.uint8)
                       for i in range(16)])

    def ref_ok(s):
        par = encode.coded_matmul(codes.parity_rows(LRC),
                                  torch.from_numpy(s[:12]))
        return bool(np.array_equal(par.numpy(), s[12:]))

    def port_ok():
        # as `ec.verify -sampleMB 0` verifies the shards it fetched
        stack = np.stack([np.fromfile(f"{base}.ec{i:02d}", dtype=np.uint8)
                          for i in range(16)])
        rs = ReedSolomon(12, 4, backend=CudaCodec(device="cpu"),
                         code="lrc-12.2.2")
        return rs.verify(stack)

    assert ref_ok(shards) and port_ok()
    for shard, off in ((3, 5), (13, shards.shape[1] - 1)):
        flipped = shards.copy()
        flipped[shard, off] ^= 0x40
        flipped[shard].tofile(f"{base}.ec{shard:02d}")
        assert ref_ok(flipped) == port_ok() is False
        shards[shard].tofile(f"{base}.ec{shard:02d}")
    assert port_ok()
