"""File-level erasure coding of the port (seaweedfs_tpu_torch/ec/
encoder.py) against the reference's, on a real Volume fixture built as
tests/test_ec_files.py builds it: shard files and .vif byte-identical for
RS(10,4), RS(28,4) and lrc-10.2.2 under every port backend, rebuilt
shards byte-identical, and verify rejecting a tampered parity byte.
Small blocks (4096/512) keep the large/small region transition in a
few hundred KB."""
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.storage import needle as ndl
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch.ec import encoder as port_encoder
from seaweedfs_tpu_torch.ec import geometry as geo
from seaweedfs_tpu_torch.ops import codec_cuda, codec_torch

LB = 4096   # test large block
SB = 512    # test small block
CHUNK = 2048

CODES = ["", "28.4", "lrc-10.2.2"]
BACKENDS = ["numpy", "torch", "cuda"]


def _backend(name):
    if name == "torch":
        return codec_torch.TorchCodec(slab=1000, device="cpu")
    if name == "cuda":
        return codec_cuda.CudaCodec(slab=1000, device="cpu")
    return name


@pytest.fixture()
def fixture_volume(tmp_path):
    """A real volume with a few hundred needles, as the golden input."""
    v = Volume(str(tmp_path), "", 7, create=True)
    rng = np.random.default_rng(1234)
    for i in range(300):
        size = int(rng.integers(1, 400))
        v.append_needle(ndl.Needle(id=i + 1,
                                   cookie=int(rng.integers(0, 2**32)),
                                   data=rng.bytes(size)))
    v.close()
    return str(tmp_path / "7")


def _twin(base: str, tag: str) -> str:
    """Copy `base`.dat next to it under another volume id."""
    other = os.path.join(os.path.dirname(base), tag)
    shutil.copyfile(base + ".dat", other + ".dat")
    return other


def _files(base: str, total: int) -> list[bytes]:
    out = []
    for i in range(total):
        with open(base + geo.shard_ext(i), "rb") as f:
            out.append(f.read())
    return out


def _vif(base: str) -> bytes | None:
    if not os.path.exists(base + ".vif"):
        return None
    with open(base + ".vif", "rb") as f:
        return f.read()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("codec", CODES)
def test_shards_identical_to_reference(fixture_volume, codec, backend):
    total = geo.parse_code(codec).total
    ref_base = _twin(fixture_volume, "ref")
    ref_encoder.write_ec_files(ref_base, backend="numpy", large_block=LB,
                               small_block=SB, chunk=CHUNK, codec=codec)
    port_encoder.write_ec_files(fixture_volume, backend=_backend(backend),
                                large_block=LB, small_block=SB,
                                chunk=CHUNK, codec=codec)
    want = _files(ref_base, total)
    got = _files(fixture_volume, total)
    assert [len(g) for g in got] == [len(w) for w in want]
    assert len(want[0]) == geo.shard_file_size(
        os.path.getsize(fixture_volume + ".dat"), LB, SB,
        geo.parse_code(codec).k)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"shard {i} differs"
    assert _vif(fixture_volume) == _vif(ref_base)
    assert port_encoder.code_of(fixture_volume) == \
        geo.parse_code(codec)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("codec,lost", [("", [3]), ("", [1, 4, 11, 13]),
                                        ("28.4", [0, 27, 30]),
                                        ("lrc-10.2.2", [2]),
                                        ("lrc-10.2.2", [0, 7, 13])])
def test_rebuild_identical(fixture_volume, codec, lost, backend):
    total = geo.parse_code(codec).total
    # the reference encodes; the port rebuilds and verifies
    ref_encoder.write_ec_files(fixture_volume, backend="numpy",
                               large_block=LB, small_block=SB, chunk=CHUNK,
                               codec=codec)
    orig = _files(fixture_volume, total)
    for i in lost:
        os.remove(fixture_volume + geo.shard_ext(i))
    assert port_encoder.rebuild_ec_files(
        fixture_volume, backend=_backend(backend), chunk=CHUNK) == lost
    assert _files(fixture_volume, total) == orig
    assert port_encoder.verify_ec_files(fixture_volume,
                                        backend=_backend(backend),
                                        chunk=CHUNK)
    assert port_encoder.rebuild_ec_files(
        fixture_volume, backend=_backend(backend)) == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_verify_rejects_tampered_parity(fixture_volume, backend):
    port_encoder.write_ec_files(fixture_volume, backend=_backend(backend),
                                large_block=LB, small_block=SB, chunk=CHUNK)
    assert port_encoder.verify_ec_files(fixture_volume,
                                        backend=_backend(backend),
                                        chunk=CHUNK)
    path = fixture_volume + geo.shard_ext(12)
    with open(path, "r+b") as f:
        f.seek(777)
        b = f.read(1)
        f.seek(777)
        f.write(bytes([b[0] ^ 0x10]))
    assert not port_encoder.verify_ec_files(fixture_volume,
                                            backend=_backend(backend),
                                            chunk=CHUNK)
    assert not ref_encoder.verify_ec_files(fixture_volume, backend="numpy",
                                           chunk=CHUNK)
    os.remove(fixture_volume + geo.shard_ext(0))
    assert not port_encoder.verify_ec_files(fixture_volume,
                                            backend=_backend(backend))


def test_default_codec_clears_stale_marker(fixture_volume):
    port_encoder.write_ec_files(fixture_volume, backend="numpy",
                                large_block=LB, small_block=SB,
                                chunk=CHUNK, codec="28.4")
    assert port_encoder.code_of(fixture_volume).spec == "28.4"
    port_encoder.write_ec_files(fixture_volume, backend="numpy",
                                large_block=LB, small_block=SB, chunk=CHUNK)
    assert port_encoder.code_of(fixture_volume).spec == "10.4"


def test_rebuild_refuses_unrecoverable(fixture_volume):
    port_encoder.write_ec_files(fixture_volume, backend="numpy",
                                large_block=LB, small_block=SB, chunk=CHUNK)
    for i in range(5):
        os.remove(fixture_volume + geo.shard_ext(i))
    with pytest.raises(ValueError):
        port_encoder.rebuild_ec_files(fixture_volume, backend="numpy")


@pytest.mark.parametrize("wide", [True, False])
def test_region_blocks_match_reference(wide):
    rng = np.random.default_rng(4)
    dat = rng.integers(0, 256, 10 * SB * 7 + 333, dtype=np.uint8)
    _, n_small = geo.row_layout(dat.shape[0], LB, SB)
    got = list(port_encoder._region_blocks(dat, 0, n_small, SB, CHUNK,
                                           10, wide=wide))
    want = list(ref_encoder._region_blocks(dat, 0, n_small, SB, CHUNK,
                                           10, wide=wide))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
