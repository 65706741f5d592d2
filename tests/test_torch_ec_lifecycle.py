"""The single-volume EC lifecycle of the port — ec.encode (.ecx and
shards) then ec.decode (.dat and .idx back) — against the JAX package's
on a real Volume fixture with overwrites and deletes, byte for byte:
write_sorted_ecx, write_dat_file after losing data and parity shards,
write_idx_from_ecx with .ecj tombstones, read_ecj and find_dat_size;
the tracing spans of encode and decode; under CudaCodec(device="cpu")
(the kernel's plain version), the native codec, and `auto` routed over
an injected curve. Small blocks (4096/512) keep the large/small region
transition in a few hundred KB."""
import os
import shutil
import time

import numpy as np
import pytest

from seaweedfs_tpu.ec import decoder as ref_decoder
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.storage import needle as ndl
from seaweedfs_tpu.storage import needle_map as ref_needle_map
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch.ec import backend as ecb
from seaweedfs_tpu_torch.ec import decoder, encoder, probe
from seaweedfs_tpu_torch.ec import geometry as geo
from seaweedfs_tpu_torch.ops import codec_cuda
from seaweedfs_tpu_torch.storage import idx as idxmod
from seaweedfs_tpu_torch.storage import needle_map, types
from seaweedfs_tpu_torch.utils import tracing

LB, SB = 4096, 512


@pytest.fixture()
def volume(tmp_path):
    """A real volume: 300 needles, 20 overwritten, 15 deleted."""
    v = Volume(str(tmp_path), "", 7, create=True)
    rng = np.random.default_rng(4321)
    for i in range(300):
        v.append_needle(ndl.Needle(id=i + 1,
                                   cookie=int(rng.integers(0, 2**32)),
                                   data=rng.bytes(int(rng.integers(1, 400)))))
    for key in rng.choice(np.arange(1, 301), 20, replace=False):
        v.append_needle(ndl.Needle(id=int(key), cookie=7,
                                   data=rng.bytes(int(rng.integers(1, 90)))))
    for key in rng.choice(np.arange(1, 290), 15, replace=False):
        v.delete_needle(int(key))
    v.close()
    return str(tmp_path / "7")


@pytest.fixture()
def cpu_cuda(monkeypatch):
    """The registry's `cuda` backend as the kernel's plain version."""
    codec = codec_cuda.CudaCodec(slab=1000, device="cpu")
    monkeypatch.setitem(ecb._instances, "cuda", codec)
    return codec


@pytest.fixture()
def routed(monkeypatch, tmp_path, cpu_cuda):
    """`auto` over an injected curve: the card measured faster than the
    CPU codec from 4 MiB up, slower below (this volume is ~100 KB)."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_PROBE_CACHE",
                       str(tmp_path / "ec_probe.json"))
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_BACKEND", raising=False)
    curve = {"fingerprint": probe.host_fingerprint(),
             "measured_at": time.time(), "cpu_backend": "native",
             "cpu_mbps": 1000.0, "device_backend": "cuda",
             "device": {"platform": "gpu", "kind": "test", "count": 1},
             "rows": [{"size": 1 << 20, "depth": 1, "e2e_mbps": 200.0},
                      {"size": 4 << 20, "depth": 2, "e2e_mbps": 3000.0},
                      {"size": 64 << 20, "depth": 4, "e2e_mbps": 9000.0}]}
    monkeypatch.setattr(probe, "_curves", {"": curve})
    monkeypatch.setattr(ecb, "_auto_choice", None)
    return curve


def _twin(base: str, tag: str) -> str:
    other = os.path.join(os.path.dirname(base), tag)
    for ext in (".dat", ".idx"):
        shutil.copyfile(base + ext, other + ext)
    return other


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _latest(name: str) -> dict:
    spans = [sp for tr in tracing.traces_json(limit=20)
             for sp in tr["spans"] if sp["name"] == name]
    assert spans, name
    return max(spans, key=lambda sp: sp["start"])


def test_ecx_matches_reference(volume):
    ref = _twin(volume, "ref")
    ref_encoder.write_sorted_ecx(ref)
    encoder.write_sorted_ecx(volume)
    assert _read(volume + ".ecx") == _read(ref + ".ecx")
    db, ref_db = needle_map.MemDb(), ref_needle_map.MemDb()
    db.load_from_idx(volume + ".idx")
    ref_db.load_from_idx(ref + ".idx")
    assert len(db) == len(ref_db) == 300 - 15
    seen = []
    db.ascending_visit(lambda k, o, s: seen.append((k, o, s)))
    assert [k for k, _, _ in seen] == sorted(k for k, _, _ in seen)
    assert all(ref_db.get(k) == (o, s) for k, o, s in seen)
    arr = idxmod.read_index(volume + ".ecx")
    assert len(arr) == 285
    assert [types.NeedleValue.from_bytes(_read(volume + ".ecx")[:16])] == \
        [types.NeedleValue(int(arr["key"][0]), int(arr["offset"][0]),
                           types.u32_to_size(int(arr["size"][0])))]


@pytest.mark.parametrize("backend", ["cuda", "native", "auto"])
@pytest.mark.parametrize("lost", [[0, 5, 11], [2, 3, 12, 13], [13]])
def test_encode_then_decode_matches_reference(volume, routed, backend,
                                              lost):
    ref = _twin(volume, "ref")
    ref_encoder.write_ec_files(ref, backend="numpy", large_block=LB,
                               small_block=SB, chunk=2048)
    ref_encoder.write_sorted_ecx(ref)
    encoder.write_ec_files(volume, backend=backend, large_block=LB,
                           small_block=SB, chunk=2048)
    encoder.write_sorted_ecx(volume)
    sp = _latest("ec.write_ec_files")
    chosen = ecb.get_backend("auto").chosen if backend == "auto" \
        else backend
    assert chosen == ("native" if backend == "auto" else backend)
    assert sp["peer"] == chosen and sp["status"] == ""
    for i in range(14):
        assert _read(volume + geo.shard_ext(i)) == \
            _read(ref + geo.shard_ext(i)), f"shard {i}"

    # the volume ends with delete records (tombstone needles appended by
    # delete_needle): the .ecx-derived size stops at the last live
    # needle, and the decoded .dat is that prefix of the original
    original = _read(volume + ".dat")
    dat_size = decoder.find_dat_size(volume)
    assert dat_size == ref_decoder.find_dat_size(ref)
    assert len(original) - 512 < dat_size <= len(original)
    original = original[:dat_size]
    for base in (volume, ref):
        os.remove(base + ".dat")
        for i in lost:
            os.remove(base + geo.shard_ext(i))
    ref_decoder.write_dat_file(ref, dat_size, large_block=LB,
                               small_block=SB, backend="numpy")
    decoder.write_dat_file(volume, dat_size, large_block=LB,
                           small_block=SB, backend=backend)
    assert _read(volume + ".dat") == _read(ref + ".dat") == original
    lost_data = [i for i in lost if i < 10]
    assert all(os.path.exists(volume + geo.shard_ext(i))
               for i in lost_data)
    assert not any(os.path.exists(volume + geo.shard_ext(i))
                   for i in lost if i >= 10)
    if lost_data:
        assert _latest("ec.rebuild_missing_data")["status"] == ""


def test_decode_runs_the_kernel_path(volume, cpu_cuda):
    encoder.write_ec_files(volume, backend="cuda", large_block=LB,
                           small_block=SB, chunk=2048)
    size = os.path.getsize(volume + ".dat")
    original = _read(volume + ".dat")
    os.remove(volume + geo.shard_ext(4))
    calls = []
    real = cpu_cuda._kernel

    def counted(mats, x, out=None):
        calls.append(x.shape)
        return real(mats, x, out)

    cpu_cuda._kernel = counted
    decoder.write_dat_file(volume, size, large_block=LB, small_block=SB,
                           backend="cuda")
    assert calls and _read(volume + ".dat") == original


def test_idx_from_ecx_and_ecj_match_reference(volume):
    ref = _twin(volume, "ref")
    for base, mod, enc in ((volume, decoder, encoder),
                           (ref, ref_decoder, ref_encoder)):
        enc.write_sorted_ecx(base)
        assert mod.read_ecj(base) == []
        for key in (5, 77, 2**40 + 3):
            mod.append_ecj(base, key)
        mod.write_idx_from_ecx(base)
    assert decoder.read_ecj(volume) == ref_decoder.read_ecj(ref) == \
        [5, 77, 2**40 + 3]
    assert _read(volume + ".idx") == _read(ref + ".idx")
    with open(volume + ".ecj", "ab") as f:
        f.write(b"\x01\x02\x03")    # a torn tail entry is ignored
    assert decoder.read_ecj(volume) == [5, 77, 2**40 + 3]
    arr = idxmod.read_index(volume + ".idx")
    ecx = idxmod.read_index(volume + ".ecx")
    assert np.array_equal(arr[:len(ecx)], ecx)
    assert [int(k) for k in arr["key"][len(ecx):]] == [5, 77, 2**40 + 3]
    assert all(types.u32_to_size(int(s)) == types.TOMBSTONE_SIZE
               for s in arr["size"][len(ecx):])


@pytest.mark.parametrize("size", [1, 3, 100, 1 << 20])
def test_needle_size_math_matches_reference(size):
    assert decoder.needle_entry_disk_size(size) == \
        ref_decoder.needle_entry_disk_size(size)
    assert decoder.needle_entry_disk_size(size) % 8 == 0


def test_find_dat_size_of_an_empty_index(tmp_path):
    base = str(tmp_path / "9")
    open(base + ".ecx", "wb").close()
    assert decoder.find_dat_size(base) == 0 == \
        ref_decoder.find_dat_size(base)


def test_auto_routes_a_bulk_volume_to_the_card(volume, routed):
    """The same injected curve sends a 64 MiB request to the card: the
    router's choice, not the volume's backend name, decides the path."""
    assert ecb.choose_backend_for_size(64 << 20) == "cuda"
    assert ecb.pipeline_depth_for(64 << 20) == 4
    rs = ecb.ReedSolomon(10, 4, backend="auto")
    assert encoder._resolved_name(rs, 64 << 20) == "cuda"
    assert encoder._resolved_name(rs, 1000) == "native"
