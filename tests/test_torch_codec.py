"""TorchCodec and CudaCodec (on the CPU, where CudaCodec's wrapper runs
the kernel's plain version) against JaxCodec / PallasCodec on the same
seeded numpy inputs: coded_matmul, the staged stream at depths 1-3 with
a small slab, empty blocks, RS(28,4) and lrc-10.2.2; ReedSolomon of the
port against the reference's; the backend registry; and the rule that
a codec built without `device=` raises when there is no GPU.
Tolerance 0: all of it is integer GF(256) arithmetic."""
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import geometry as ref_geo
from seaweedfs_tpu.ec.backend import ReedSolomon as RefReedSolomon
from seaweedfs_tpu.ops import codec_jax, codec_numpy, codec_pallas, rs_matrix
from seaweedfs_tpu_torch.ec import backend as port_backend
from seaweedfs_tpu_torch.ec.backend import ReedSolomon
from seaweedfs_tpu_torch.ops import codec_cuda, codec_torch
from seaweedfs_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _dense_reference(monkeypatch):
    # the reference's measured XOR-schedule chooser gives the same bytes;
    # pin it off so JaxCodec runs its dense kernel without background timing
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SCHEDULE", "off")
    real = codec_pallas.coded_matmul_pallas_pm

    def interp(a_pm, pack, shards, interpret=False):
        return real(a_pm, pack, shards, interpret=True)

    monkeypatch.setattr(codec_pallas, "coded_matmul_pallas_pm", interp)


def _coef(spec, missing=None):
    code = ref_geo.parse_code(spec)
    if missing is None:
        return rs_matrix.parity_rows_for(code)
    present = [i for i in range(code.total) if i not in missing]
    return rs_matrix.recovery_rows_for(code, present, missing)[0]


def _port_codec(kind, slab):
    cls = codec_torch.TorchCodec if kind == "torch" else codec_cuda.CudaCodec
    return cls(slab=slab, device="cpu")


def _ref_codec(kind, slab):
    if kind == "torch":
        return codec_jax.JaxCodec(slab=slab)
    return codec_pallas.PallasCodec(slab=slab)


@pytest.mark.parametrize("kind", ["torch", "cuda"])
@pytest.mark.parametrize("spec,missing", [("10.4", None),
                                          ("10.4", [1, 4, 11, 13]),
                                          ("28.4", None),
                                          ("lrc-10.2.2", None),
                                          ("lrc-10.2.2", [3])])
def test_coded_matmul_matches_reference(kind, spec, missing):
    coef = _coef(spec, missing)
    rng = np.random.default_rng(coef.shape[0] * 31 + coef.shape[1])
    x = rng.integers(0, 256, (coef.shape[1], 3001), dtype=np.uint8)
    want = _ref_codec(kind, 1024).coded_matmul(coef, x)
    got = _port_codec(kind, 1024).coded_matmul(coef, x)
    assert np.array_equal(got, want)
    assert np.array_equal(got, codec_numpy.coded_matmul(coef, x))


@pytest.mark.parametrize("kind", ["torch", "cuda"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_matches_reference(kind, depth):
    coef = _coef("10.4")
    rng = np.random.default_rng(depth)
    widths = [700, 0, 1500, 1, 0, 2049]
    blocks = [rng.integers(0, 256, (10, w), dtype=np.uint8) for w in widths]
    # JaxCodec feeds the dense reference; the stream contract is
    # per-block coded_matmul, in order, empty blocks included
    ref = codec_jax.JaxCodec(slab=512)
    want = list(ref.coded_matmul_stream(coef, iter(blocks), depth=depth))
    got = list(_port_codec(kind, 512).coded_matmul_stream(
        coef, iter(blocks), depth=depth))
    assert [g.shape for g in got] == [(4, w) for w in widths]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("spec", ["28.4", "lrc-10.2.2"])
def test_stream_wide_and_lrc_codes(spec):
    coef = _coef(spec)
    k = coef.shape[1]
    rng = np.random.default_rng(k)
    blocks = [rng.integers(0, 256, (k, w), dtype=np.uint8)
              for w in (300, 1000, 7)]
    for kind in ("torch", "cuda"):
        got = list(_port_codec(kind, 256).coded_matmul_stream(
            coef, iter(blocks), depth=2))
        for g, b in zip(got, blocks):
            assert np.array_equal(g, codec_numpy.coded_matmul(coef, b))


def test_stream_against_pallas_codec():
    coef = _coef("10.4", [2])
    rng = np.random.default_rng(77)
    blocks = [rng.integers(0, 256, (10, w), dtype=np.uint8)
              for w in (1000, 0, 4100)]
    want = list(codec_pallas.PallasCodec().coded_matmul_stream(
        coef, iter(blocks), depth=2))
    got = list(codec_cuda.CudaCodec(device="cpu").coded_matmul_stream(
        coef, iter(blocks), depth=2))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_stream_records_every_stage():
    codec = codec_cuda.CudaCodec(slab=256, device="cpu")
    coef = _coef("10.4")
    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 256, (10, 600), dtype=np.uint8)
              for _ in range(3)]

    def count(stage):
        return metrics.counter_value("ec_codec_stage_seconds_count",
                                     {"stage": stage, "backend": "cuda"})

    before = {s: count(s) for s in ("pread", "h2d", "kernel", "d2h")}
    list(codec.coded_matmul_stream(coef, iter(blocks), depth=2))
    for stage, n in before.items():
        assert count(stage) >= n + 3, stage


def test_stream_host_stage_order(monkeypatch):
    """Per block at depth 1 the feed's steps run in order: the caller
    reads the block (pread), the upload thread stages it and runs the
    product (3 slabs here), then records h2d; the drain thread records
    kernel and d2h; the consumer records relay. The kernel stage holds
    the product's time and the h2d stage does not."""
    events = []
    real_observe = codec_torch.observe_stage

    def observe(backend, stage, seconds):
        events.append((stage, seconds))
        real_observe(backend, stage, seconds)

    monkeypatch.setattr(codec_torch, "observe_stage", observe)
    codec = codec_cuda.CudaCodec(slab=256, device="cpu")
    real_kernel = codec._kernel

    def slow_kernel(mats, x, out=None):
        events.append(("run", None))
        time.sleep(0.02)
        return real_kernel(mats, x, out)

    codec._kernel = slow_kernel
    coef = _coef("10.4")
    rng = np.random.default_rng(4)
    blocks = [rng.integers(0, 256, (10, 600), dtype=np.uint8)
              for _ in range(3)]
    got = list(codec.coded_matmul_stream(coef, iter(blocks), depth=1))
    for g, b in zip(got, blocks):
        assert np.array_equal(g, codec_numpy.coded_matmul(coef, b))
    order = ["pread", "run", "run", "run", "h2d", "kernel", "d2h", "relay"]
    assert [e for e, _ in events] == order * 3
    for i in range(3):
        stages = dict(events[8 * i:8 * i + 8])
        assert stages["kernel"] >= 0.06 > stages["h2d"]


def test_stream_reads_memmap_blocks(tmp_path):
    path = tmp_path / "blk"
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (10, 999), dtype=np.uint8)
    data.tofile(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r").reshape(10, 999)
    coef = _coef("10.4")
    out = list(codec_torch.TorchCodec(device="cpu").coded_matmul_stream(
        coef, [mm[:, :500], mm[:, 500:]]))
    assert np.array_equal(np.concatenate(out, axis=1),
                          codec_numpy.coded_matmul(coef, data))


def test_operand_cache_is_bounded():
    codec = codec_cuda.CudaCodec(device="cpu")
    codec.BITMAT_CACHE_MAX = 4
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (3, 50), dtype=np.uint8)
    for i in range(10):
        coef = rng.integers(0, 256, (2, 3), dtype=np.uint8)
        assert np.array_equal(codec.coded_matmul(coef, x),
                              codec_numpy.coded_matmul(coef, x))
    assert len(codec._mats) == 4


@pytest.mark.parametrize("kind", ["torch", "cuda"])
@pytest.mark.parametrize("spec", ["10.4", "28.4", "lrc-10.2.2"])
def test_reed_solomon_matches_reference(kind, spec):
    code = ref_geo.parse_code(spec)
    rs = ReedSolomon(0, 0, backend=_port_codec(kind, 1 << 21), code=spec)
    ref = RefReedSolomon(0, 0, backend="numpy", code=spec)
    rng = np.random.default_rng(code.total)
    data = rng.integers(0, 256, (code.k, 1234), dtype=np.uint8)
    parity = rs.encode(data)
    assert np.array_equal(parity, ref.encode(data))
    full = np.concatenate([data, parity])
    assert rs.verify(full)
    lost = [1, code.k + 1]
    shards = {i: full[i] for i in range(code.total) if i not in lost}
    got, want = rs.reconstruct(shards), ref.reconstruct(shards)
    assert sorted(got) == sorted(want) == lost
    for i in lost:
        assert np.array_equal(got[i], want[i])
        assert np.array_equal(got[i], full[i])
    data_only = rs.reconstruct_data(shards)
    assert sorted(data_only) == [1]
    assert np.array_equal(data_only[1], full[1])
    tampered = full.copy()
    tampered[code.k, 17] ^= 0x40
    assert not rs.verify(tampered)
    streamed = list(rs.encode_stream(iter([data[:, :600], data[:, 600:]])))
    assert np.array_equal(np.concatenate(streamed, axis=1), parity)


def test_registry():
    assert port_backend.backend_names() == ["auto", "cuda", "mesh",
                                            "native", "numpy", "torch"]
    assert port_backend.get_backend("numpy").name == "numpy"
    with pytest.raises(KeyError):
        port_backend.get_backend("pallas")
    rs = ReedSolomon(0, 0, backend="numpy", code="lrc-10.2.2")
    assert (rs.k, rs.m, rs.code.spec) == (10, 4, "lrc-10.2.2")
    assert ReedSolomon(28, 4, backend="numpy").code.spec == "28.4"


def test_no_gpu_means_raise_not_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (codec_torch.TorchCodec, codec_cuda.CudaCodec,
                 lambda: codec_cuda.CudaCodec(device="cuda"),
                 lambda: ReedSolomon(10, 4),
                 lambda: ReedSolomon(10, 4, backend="torch")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert "cuda" not in port_backend._instances
    assert codec_cuda.CudaCodec(device="cpu").device.type == "cpu"
