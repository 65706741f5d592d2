"""Host-side modules of the torch port against the JAX package's, byte
for byte (tolerance 0: all of it is integer GF(256) arithmetic): gf256
tables, rs_matrix for every known code, the numpy codec, geometry, the
.vif sidecar and the metrics registry. Also scans the port's sources
and chip_smoke.py for imports of jax or seaweedfs_tpu (the image imports
jax into every process, so sys.modules cannot tell)."""
import ast
import json
import os

import numpy as np
import pytest

from seaweedfs_tpu.ec import backend as ref_backend
from seaweedfs_tpu.ec import geometry as ref_geo
from seaweedfs_tpu.ops import codec_numpy as ref_codec_numpy
from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops import rs_matrix as ref_rs
from seaweedfs_tpu.storage import volume_info as ref_vinfo
from seaweedfs_tpu_torch.ec import backend as port_backend
from seaweedfs_tpu_torch.ec import geometry as port_geo
from seaweedfs_tpu_torch.ops import codec_numpy as port_codec_numpy
from seaweedfs_tpu_torch.ops import gf256 as port_gf256
from seaweedfs_tpu_torch.ops import rs_matrix as port_rs
from seaweedfs_tpu_torch.storage import volume_info as port_vinfo
from seaweedfs_tpu_torch.utils import metrics as port_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODES = ref_backend.KNOWN_CODES


@pytest.mark.parametrize("table", ["EXP", "LOG", "MUL_TABLE", "INV",
                                   "BITMAT"])
def test_gf256_tables(table):
    assert np.array_equal(getattr(port_gf256, table),
                          getattr(ref_gf256, table))


def test_gf256_expand_and_invert():
    rng = np.random.default_rng(11)
    m = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    assert np.array_equal(port_gf256.expand_to_bits(m),
                          ref_gf256.expand_to_bits(m))
    a = rng.integers(0, 256, (6, 6), dtype=np.uint8)
    a[np.diag_indices(6)] |= 1
    try:
        want = ref_gf256.mat_inv(a)
    except ValueError:
        with pytest.raises(ValueError):
            port_gf256.mat_inv(a)
    else:
        assert np.array_equal(port_gf256.mat_inv(a), want)


def test_known_codes_match():
    assert port_backend.KNOWN_CODES == ref_backend.KNOWN_CODES


@pytest.mark.parametrize("spec", CODES)
def test_encode_matrix_for_every_code(spec):
    pc, rc = port_geo.parse_code(spec), ref_geo.parse_code(spec)
    assert (pc.kind, pc.k, pc.n_local, pc.n_global) == \
        (rc.kind, rc.k, rc.n_local, rc.n_global)
    assert np.array_equal(port_rs.encode_matrix_for(pc),
                          ref_rs.encode_matrix_for(rc))
    assert np.array_equal(port_rs.parity_rows_for(pc),
                          ref_rs.parity_rows_for(rc))


@pytest.mark.parametrize("spec", CODES)
def test_recovery_rows_for_every_code(spec):
    pc, rc = port_geo.parse_code(spec), ref_geo.parse_code(spec)
    rng = np.random.default_rng(len(spec))
    patterns = [[0], [pc.k - 1], [pc.total - 1]]
    for _ in range(6):
        n_lost = int(rng.integers(1, pc.m + 1))
        patterns.append(sorted(rng.choice(pc.total, n_lost, replace=False)
                               .tolist()))
    checked = 0
    for missing in patterns:
        present = [i for i in range(pc.total) if i not in missing]
        if not rc.recoverable(present):
            assert not pc.recoverable(present)
            continue
        rows_p, in_p = port_rs.recovery_rows_for(pc, present, missing)
        rows_r, in_r = ref_rs.recovery_rows_for(rc, present, missing)
        assert in_p == in_r, missing
        assert np.array_equal(rows_p, rows_r), missing
        checked += 1
    assert checked >= 3


@pytest.mark.parametrize("k,m", [(10, 4), (28, 4), (12, 5)])
def test_codec_numpy(k, m):
    rng = np.random.default_rng(k * 100 + m)
    coef = ref_rs.parity_rows(k, m)
    data = rng.integers(0, 256, (k, 1001), dtype=np.uint8)
    assert np.array_equal(port_codec_numpy.coded_matmul(coef, data),
                          ref_codec_numpy.coded_matmul(coef, data))
    assert port_codec_numpy.NumpyCodec.name == "numpy"


@pytest.mark.parametrize("spec", ["", "10.4", "28.4", "lrc-10.2.2",
                                  "lrc-12.3.2"])
def test_geometry_parse_code(spec):
    pc, rc = port_geo.parse_code(spec), ref_geo.parse_code(spec)
    for attr in ("spec", "kind", "k", "m", "total", "group_size",
                 "is_rs"):
        assert getattr(pc, attr) == getattr(rc, attr)
    assert port_geo.parse_codec(spec) == ref_geo.parse_codec(spec)
    assert pc.local_groups == rc.local_groups
    assert pc.global_parities == rc.global_parities


@pytest.mark.parametrize("bad", ["0.4", "30.4", "lrc-10.3.2", "lrc-10.2",
                                 "lrc-0.1.1"])
def test_geometry_rejects_bad_codes(bad):
    with pytest.raises(ValueError):
        ref_geo.parse_code(bad)
    with pytest.raises(ValueError):
        port_geo.parse_code(bad)


@pytest.mark.parametrize("dat_size", [0, 1, 5119, 5120, 5121,
                                      40961, 1 << 20, (1 << 30) + 7])
def test_geometry_layout(dat_size):
    for k in (10, 28):
        args = (dat_size, 4096, 512, k)
        assert port_geo.row_layout(*args) == ref_geo.row_layout(*args)
        assert port_geo.shard_file_size(*args) == \
            ref_geo.shard_file_size(*args)
    assert port_geo.row_layout(dat_size) == ref_geo.row_layout(dat_size)


def test_geometry_constants_and_ext():
    for name in ("DATA_SHARDS", "PARITY_SHARDS", "TOTAL_SHARDS",
                 "MAX_SHARD_COUNT", "LARGE_BLOCK", "SMALL_BLOCK"):
        assert getattr(port_geo, name) == getattr(ref_geo, name)
    assert [port_geo.shard_ext(i) for i in range(32)] == \
        [ref_geo.shard_ext(i) for i in range(32)]


def test_volume_info_roundtrip(tmp_path):
    p_port, p_ref = str(tmp_path / "a.vif"), str(tmp_path / "b.vif")
    port_vinfo.save_volume_info(p_port, port_vinfo.VolumeInfo(
        replication="001", ec_codec="lrc-10.2.2",
        files=[port_vinfo.RemoteFile(key="k1", file_size=9)]))
    ref_vinfo.save_volume_info(p_ref, ref_vinfo.VolumeInfo(
        replication="001", ec_codec="lrc-10.2.2",
        files=[ref_vinfo.RemoteFile(key="k1", file_size=9)]))
    with open(p_port) as a, open(p_ref) as b:
        assert json.load(a) == json.load(b)
    vi = port_vinfo.maybe_load_volume_info(p_ref)
    assert vi.ec_codec == "lrc-10.2.2" and vi.remote_file().key == "k1"
    assert port_vinfo.maybe_load_volume_info(str(tmp_path / "none")) is None


def test_metrics_histogram_and_counter():
    lab = {"stage": "kernel", "backend": "test-host-math"}
    before = port_metrics.counter_value("ec_codec_stage_seconds_count", lab)
    port_metrics.histogram_observe("ec_codec_stage_seconds", 0.25, lab)
    port_metrics.histogram_observe("ec_codec_stage_seconds", 2.0, lab)
    assert port_metrics.counter_value("ec_codec_stage_seconds_count",
                                      lab) == before + 2
    text = port_metrics.render()
    assert "# TYPE ec_codec_stage_seconds histogram" in text
    assert 'backend="test-host-math"' in text
    assert port_metrics.counter_value("no_such_counter") == 0.0


def _port_python_files():
    root = os.path.join(REPO, "seaweedfs_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for base, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "seaweedfs_tpu" or name.startswith("seaweedfs_tpu."))


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_python_files()
    assert len(files) >= 15, files
    bad = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and isinstance(node.args[0].value, str)
                  and getattr(node.func, "attr",
                              getattr(node.func, "id", "")) in
                  ("import_module", "__import__")):
                names = [node.args[0].value]
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_import_scan_catches_forbidden_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("seaweedfs_tpu.ops")
    assert not _forbidden("seaweedfs_tpu_torch.ops")
    assert not _forbidden("jaxtyping_free") and not _forbidden("torch")
