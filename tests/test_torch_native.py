"""The port's native host codec (seaweedfs_tpu_torch/native/, built with
g++ from its own copy of gf256_codec.cc) against the JAX package's numpy
codec and, when its library loads, the JAX package's native library, on
the same seeded inputs; tolerance 0. Also NativeCodec under forced
schedule modes and the whole-file encode bypass
(`write_ec_files(backend="native")`) against the reference's numpy
encode, for RS(10,4) and lrc-10.2.2 at uneven .dat sizes."""
import os
import shutil
import subprocess

import numpy as np
import pytest

from seaweedfs_tpu import native as ref_native
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import geometry as ref_geo
from seaweedfs_tpu.ops import codec_numpy as ref_codec_numpy
from seaweedfs_tpu.ops import rs_matrix
from seaweedfs_tpu.ops import schedule as ref_schedule
from seaweedfs_tpu_torch import native
from seaweedfs_tpu_torch.ec import encoder as port_encoder
from seaweedfs_tpu_torch.ec import geometry as geo
from seaweedfs_tpu_torch.native import build
from seaweedfs_tpu_torch.ops import codec_native
from seaweedfs_tpu_torch.utils import metrics, tracing

LB, SB = 4096, 512   # test large / small block


def _ref_native():
    """The JAX package's native library, or None where it cannot build."""
    try:
        ref_native.load()
    except (OSError, subprocess.CalledProcessError) as e:  # no g++
        print(f"reference native library unavailable: {e}")
        return None
    return ref_native


def _coef(spec, missing=None):
    code = ref_geo.parse_code(spec)
    if missing is None:
        return rs_matrix.parity_rows_for(code)
    present = [i for i in range(code.total) if i not in missing]
    return rs_matrix.recovery_rows_for(code, present, missing)[0]


def test_library_builds_from_its_own_source():
    path = build.build(verbose=False)
    assert os.path.dirname(path) == build.BUILD_DIR
    assert path == build.library_path()
    assert os.path.basename(path).startswith("libgf256_codec-")
    assert build.SRC.startswith(os.path.dirname(native.__file__))
    assert native.load()._name == path
    assert native.available() and native.has_scheduled()
    assert 0 <= native.simd_level() <= 3


def test_build_needs_gxx_when_nothing_is_built(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not native.available()
    with pytest.raises(FileNotFoundError):
        build.build(verbose=False)


@pytest.mark.parametrize("spec,missing", [("10.4", None),
                                          ("10.4", [1, 4, 11, 13]),
                                          ("28.4", None),
                                          ("lrc-10.2.2", None),
                                          ("lrc-12.3.2", [3])])
@pytest.mark.parametrize("width", [1, 31, 4097, 100_003])
def test_coded_and_scheduled_matmul_match_reference(spec, missing, width):
    coef = _coef(spec, missing)
    rng = np.random.default_rng(width + coef.shape[1])
    x = rng.integers(0, 256, (coef.shape[1], width), dtype=np.uint8)
    want = ref_codec_numpy.coded_matmul(coef, x)
    got = native.coded_matmul(coef, x)
    flat = ref_schedule.flatten(ref_schedule.plan_for(coef))
    sched = native.scheduled_matmul(flat, x, coef.shape[0])
    assert np.array_equal(got, want)
    assert np.array_equal(sched, want)
    ref = _ref_native()
    if ref is not None:
        assert np.array_equal(got, ref.coded_matmul(coef, x))
        assert np.array_equal(sched, ref.scheduled_matmul(flat, x,
                                                          coef.shape[0]))


def test_scheduled_matmul_rejects_a_foreign_program():
    coef = _coef("10.4")
    flat = ref_schedule.flatten(ref_schedule.plan_for(coef))
    x = np.zeros((9, 64), dtype=np.uint8)
    with pytest.raises(ValueError, match="does not match"):
        native.scheduled_matmul(flat, x, 4)
    with pytest.raises(ValueError, match="do not match"):
        native.coded_matmul(coef, x)


def test_crc32c_matches_reference():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (5, 1001), dtype=np.uint8)
    got = native.crc32c_batch(rows)
    assert [native.crc32c(r.tobytes()) for r in rows] == got.tolist()
    assert native.crc32c(rows[0].tobytes()[500:],
                         native.crc32c(rows[0].tobytes()[:500])) == got[0]
    ref = _ref_native()
    if ref is not None:
        assert np.array_equal(got, ref.crc32c_batch(rows))


@pytest.mark.parametrize("mode", ["on", "off", "auto"])
@pytest.mark.parametrize("spec", ["10.4", "lrc-10.2.2"])
def test_native_codec_forced_schedule_modes(monkeypatch, mode, spec):
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SCHEDULE", mode)
    codec = codec_native.NativeCodec()
    coef = _coef(spec)
    rng = np.random.default_rng(17)
    for width in (13, (5 << 20) // 10 + 7):   # past the 4 MiB sample cap
        x = rng.integers(0, 256, (10, width), dtype=np.uint8)
        assert np.array_equal(codec.coded_matmul(coef, x),
                              ref_codec_numpy.coded_matmul(coef, x))
    snap = codec.schedule_snapshot()
    assert snap["buckets"] == (1 if mode == "auto" else 0)
    assert snap["failed"] == 0


def _files(base, total):
    out = []
    for i in range(total):
        with open(base + geo.shard_ext(i), "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("codec", ["", "lrc-10.2.2"])
@pytest.mark.parametrize("size", [1, 40_961, 10 * LB * 3 + 12_345])
def test_native_file_encode_matches_reference(tmp_path, codec, size):
    rng = np.random.default_rng(size)
    base = str(tmp_path / "3")
    with open(base + ".dat", "wb") as f:
        f.write(rng.bytes(size))
    ref_base = str(tmp_path / "4")
    shutil.copyfile(base + ".dat", ref_base + ".dat")
    ref_encoder.write_ec_files(ref_base, backend="numpy", large_block=LB,
                               small_block=SB, chunk=2048, codec=codec)
    lab = {"op": "encode", "backend": "native"}
    before = metrics.counter_value("ec_codec_bytes_total", lab)
    port_encoder.write_ec_files(base, backend="native", large_block=LB,
                                small_block=SB, codec=codec)
    total = geo.parse_code(codec).total
    want, got = _files(ref_base, total), _files(base, total)
    assert [len(g) for g in got] == [len(w) for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"shard {i} differs"
    assert metrics.counter_value("ec_codec_bytes_total", lab) == \
        before + size
    spans = [sp for tr in tracing.traces_json(limit=5)
             for sp in tr["spans"] if sp["name"] == "ec.write_ec_files"]
    assert spans and spans[0]["peer"] == "native"
