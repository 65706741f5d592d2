"""Host-side modules of the torch port against the JAX package's, byte
for byte (tolerance 0: all of it is integer GF(256) arithmetic): gf256
tables, rs_matrix for every known code, the numpy codec, geometry, the
.vif sidecar and the metrics registry. Also scans the port's sources
and the root scripts (chip_smoke.py, host_profile.py) for imports of
jax or seaweedfs_tpu (the image imports jax into every process, so
sys.modules cannot tell), of aiohttp,
requests and the libraries under them (the card's machine has none of
them), and of anything beyond the standard library, numpy, torch and
triton — but for PIL, which images/__init__.py alone may import, inside
a function and under a handler of ImportError, as the reference does."""
import ast
import json
import os
import sys

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
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                            "host_profile.py")]
    for base, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


# google_crc32c, aiohttp, requests and what carries them (urllib3, the
# websocket stacks): the card's machine has none of them
_BANNED_TOP = ("jax", "seaweedfs_tpu", "google_crc32c", "aiohttp",
               "requests", "urllib3", "websockets", "websocket")
# beyond the standard library, the port may import only these
# chip_smoke: host_profile.py drives its phases
_CARD_PACKAGES = {"numpy", "torch", "triton", "seaweedfs_tpu_torch",
                  "chip_smoke"}


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in _BANNED_TOP


def _imports(path: str) -> list[tuple[int, str]]:
    """(line, module) of every import in a file, dynamic ones included."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = []
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
        out += [(node.lineno, n) for n in names]
    return out


def _outside_the_card(name: str) -> bool:
    top = name.split(".")[0]
    return top not in sys.stdlib_module_names and top not in _CARD_PACKAGES


# PIL (an image codec library) is taken the reference's way: imported
# inside resized / cropped, within a try whose handler catches
# ImportError, so a host without it serves the stored bytes
_PIL_MODULE = "seaweedfs_tpu_torch/images/__init__.py"


def _catches_import_error(handler: ast.ExceptHandler) -> bool:
    kinds = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    return any(isinstance(k, ast.Name)
               and k.id in ("ImportError", "ModuleNotFoundError")
               for k in kinds)


def _guarded_imports(path: str) -> set[int]:
    """Lines of the imports made inside a function, within the body of
    a try whose handler catches ImportError."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for func in ast.walk(tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(func):
            if isinstance(node, ast.Try) and \
                    any(map(_catches_import_error, node.handlers)):
                out |= {sub.lineno for stmt in node.body
                        for sub in ast.walk(stmt)
                        if isinstance(sub, (ast.Import, ast.ImportFrom))}
    return out


def _sanctioned(path: str, line: int, name: str) -> bool:
    return (name.split(".")[0] == "PIL"
            and os.path.relpath(path, REPO) == _PIL_MODULE
            and line in _guarded_imports(path))


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_python_files()
    assert len(files) >= 15, files
    rel = {os.path.relpath(p, REPO) for p in files}
    # the walk reaches every module, the self-healing plane's and the
    # HA control plane's included
    assert {"seaweedfs_tpu_torch/master/watchdog.py",
            "seaweedfs_tpu_torch/shell/commands_volume.py",
            "seaweedfs_tpu_torch/server/master_server.py",
            "seaweedfs_tpu_torch/master/raft.py",
            "seaweedfs_tpu_torch/rpc/websocket.py",
            "seaweedfs_tpu_torch/server/master_follower.py",
            "seaweedfs_tpu_torch/shell/commands_cluster.py",
            "seaweedfs_tpu_torch/master/tiering.py",
            "seaweedfs_tpu_torch/master/collector.py",
            "seaweedfs_tpu_torch/remote_storage/client.py",
            "seaweedfs_tpu_torch/s3/client.py",
            "seaweedfs_tpu_torch/query/json_query.py",
            "seaweedfs_tpu_torch/query/sql.py",
            "seaweedfs_tpu_torch/operation/chunked_file.py",
            "seaweedfs_tpu_torch/operation/tools.py",
            "seaweedfs_tpu_torch/operation/backup.py",
            "seaweedfs_tpu_torch/s3/eventstream.py",
            "seaweedfs_tpu_torch/scaffold.py",
            "seaweedfs_tpu_torch/mount/weedfs.py",
            "seaweedfs_tpu_torch/mount/fuse_ctypes.py",
            "seaweedfs_tpu_torch/images/__init__.py",
            "seaweedfs_tpu_torch/analysis/engine.py"} <= rel
    bad = [f"{os.path.relpath(path, REPO)}:{line} {n}"
           for path in files for line, n in _imports(path) if _forbidden(n)]
    assert not bad, bad


def test_port_imports_only_what_the_card_has():
    """Any third-party module could pull aiohttp or requests in behind
    its own imports: the port takes nothing past the standard library,
    numpy, torch and triton."""
    bad = [f"{os.path.relpath(path, REPO)}:{line} {n}"
           for path in _port_python_files()
           for line, n in _imports(path)
           if _outside_the_card(n) and not _sanctioned(path, line, n)]
    assert not bad, bad


def test_pil_is_imported_only_lazily_by_images():
    path = os.path.join(REPO, _PIL_MODULE)
    pil = [line for line, n in _imports(path) if n.startswith("PIL")]
    assert len(pil) == 2 and set(pil) <= _guarded_imports(path)
    assert [os.path.relpath(p, REPO) for p in _port_python_files()
            for line, n in _imports(p)
            if n.split(".")[0] == "PIL"] == [_PIL_MODULE] * 2


@pytest.mark.parametrize("src,guarded", [
    ("from PIL import Image\n", False),
    ("try:\n    import PIL\nexcept ImportError:\n    PIL = None\n",
     False),
    ("def f():\n    from PIL import Image\n    return Image\n", False),
    ("def f():\n    try:\n        from PIL import Image\n"
     "    except Exception:\n        return None\n", False),
    ("def f():\n    try:\n        pass\n    except ImportError:\n"
     "        from PIL import Image\n", False),
    ("def f():\n    try:\n        from PIL import Image\n"
     "    except (OSError, ImportError):\n        return None\n", True),
])
def test_a_pil_import_elsewhere_is_refused(src, guarded, tmp_path):
    """Only a guarded import inside a function counts as lazy, and only
    in images/__init__.py: the same import in any other file, or a
    top-level one, is refused."""
    path = tmp_path / "m.py"
    path.write_text(src)
    (line, name), = [(ln, n) for ln, n in _imports(str(path))
                     if n.startswith("PIL")]
    assert _outside_the_card(name)
    assert (line in _guarded_imports(str(path))) == guarded
    assert not _sanctioned(str(path), line, name)


def test_import_scan_catches_forbidden_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("seaweedfs_tpu.ops")
    assert not _forbidden("seaweedfs_tpu_torch.ops")
    assert not _forbidden("jaxtyping_free") and not _forbidden("torch")
    assert _forbidden("google_crc32c")
    assert _forbidden("aiohttp") and _forbidden("aiohttp.web")
    assert _forbidden("requests") and _forbidden("requests.adapters")
    assert _forbidden("urllib3.util")
    assert not _forbidden("http.client") and not _forbidden("requests_x")


def test_import_scan_catches_a_module_that_imports_them(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import http.client\nfrom aiohttp import web\n"
                   "def f():\n    import requests.adapters\n"
                   "    importlib.import_module('urllib3')\n"
                   "    import yarl\n    from . import sibling\n")
    names = [n for _, n in _imports(str(src))]
    assert sorted(n for n in names if _forbidden(n)) == [
        "aiohttp", "requests.adapters", "urllib3"]
    assert sorted(n for n in names if _outside_the_card(n)) == [
        "aiohttp", "requests.adapters", "urllib3", "yarl"]


SERVER_AND_SHELL = ["rpc/http.py", "utils/retry.py", "rpc/httpclient.py",
                    "master/sequence.py", "master/topology.py",
                    "master/placement.py", "server/master_server.py",
                    "wdclient/client.py", "operation/verbs.py",
                    "utils/ratelimit.py", "server/volume_server.py",
                    "server/cluster.py", "shell/env.py",
                    "shell/commands_ec.py", "shell/repl.py", "cli.py",
                    "utils/httprange.py", "cluster/membership.py",
                    "shell/commands_volume.py"]


@pytest.mark.parametrize("module", SERVER_AND_SHELL)
def test_scan_covers_the_server_and_shell_layer(module):
    """The control plane's modules are scanned, each has its reference
    at the same path, and none imports jax, seaweedfs_tpu, aiohttp,
    requests or anything the card's machine lacks."""
    path = os.path.join(REPO, "seaweedfs_tpu_torch", module)
    assert path in _port_python_files()
    assert os.path.exists(os.path.join(REPO, "seaweedfs_tpu", module))
    names = [n for _, n in _imports(path)]
    assert not [n for n in names if _forbidden(n) or _outside_the_card(n)]


FILER_AND_S3 = ["utils/compression.py", "utils/extheaders.py",
                "filer/__init__.py", "filer/entry.py",
                "filer/filechunks.py", "filer/filerstore.py",
                "filer/event_log.py", "filer/filer_conf.py",
                "filer/filer.py", "filer/stream.py",
                "cluster/lock_manager.py", "server/filer_server.py",
                "s3/__init__.py", "s3/auth.py", "s3/chunked.py",
                "s3/server.py"]


@pytest.mark.parametrize("module", FILER_AND_S3)
def test_scan_covers_the_filer_and_s3_layer(module):
    """The filer / DLM / S3 slice's modules are scanned, each has its
    reference at the same path, and none imports jax, seaweedfs_tpu,
    aiohttp, requests or anything the card's machine lacks."""
    path = os.path.join(REPO, "seaweedfs_tpu_torch", module)
    assert path in _port_python_files()
    assert os.path.exists(os.path.join(REPO, "seaweedfs_tpu", module))
    names = [n for _, n in _imports(path)]
    assert not [n for n in names if _forbidden(n) or _outside_the_card(n)]


MESH_LAYER = ["parallel/mesh.py", "ops/codec_mesh.py",
              "models/ec_pipeline.py", "ec/probe.py", "ec/backend.py",
              "cli.py"]


@pytest.mark.parametrize("module", MESH_LAYER)
def test_scan_covers_the_mesh_layer(module):
    """The multi-GPU slice's modules are scanned, each has its reference
    at the same path, and none imports jax, seaweedfs_tpu or anything
    the card's machine lacks."""
    path = os.path.join(REPO, "seaweedfs_tpu_torch", module)
    assert path in _port_python_files()
    assert os.path.exists(os.path.join(REPO, "seaweedfs_tpu", module))
    names = [n for _, n in _imports(path)]
    assert not [n for n in names if _forbidden(n) or _outside_the_card(n)]


TIER_LAYER = ["s3/sigv4_client.py", "s3/client.py",
              "remote_storage/__init__.py", "remote_storage/client.py",
              "storage/backend.py", "storage/volume.py",
              "storage/disk_location.py", "storage/store.py",
              "ec/volume.py", "server/volume_server.py",
              "shell/commands_volume.py", "shell/repl.py",
              "master/tiering.py", "master/collector.py",
              "server/master_server.py", "server/cluster.py", "cli.py",
              "rpc/httpclient.py"]


@pytest.mark.parametrize("module", TIER_LAYER)
def test_scan_covers_the_tier_layer(module):
    """The tiered-storage slice's modules are scanned, each has its
    reference at the same path, and none imports jax, seaweedfs_tpu,
    aiohttp, requests or anything the card's machine lacks."""
    path = os.path.join(REPO, "seaweedfs_tpu_torch", module)
    assert path in _port_python_files()
    assert os.path.exists(os.path.join(REPO, "seaweedfs_tpu", module))
    names = [n for _, n in _imports(path)]
    assert not [n for n in names if _forbidden(n) or _outside_the_card(n)]


OBSERVABILITY_LAYER = ["utils/faults.py", "utils/retry.py",
                       "utils/tracing.py", "rpc/http.py",
                       "rpc/httpclient.py", "rpc/trace_push.py",
                       "master/collector.py", "master/workload.py",
                       "master/topology.py", "server/master_server.py",
                       "server/volume_server.py",
                       "server/filer_server.py", "s3/server.py",
                       "server/master_follower.py", "server/cluster.py",
                       "wdclient/client.py", "cli.py"]


@pytest.mark.parametrize("module", OBSERVABILITY_LAYER)
def test_scan_covers_the_observability_layer(module):
    """The robustness and observability slice's new and changed
    modules are scanned, each has its reference at the same path, and
    none imports jax, seaweedfs_tpu, aiohttp, requests or anything the
    card's machine lacks."""
    path = os.path.join(REPO, "seaweedfs_tpu_torch", module)
    assert path in _port_python_files()
    assert os.path.exists(os.path.join(REPO, "seaweedfs_tpu", module))
    names = [n for _, n in _imports(path)]
    assert not [n for n in names if _forbidden(n) or _outside_the_card(n)]


STORAGE_LAYER = ["ec/geometry.py", "native/__init__.py", "storage/types.py",
                 "storage/needle.py", "storage/super_block.py",
                 "storage/backend.py", "storage/needle_map.py",
                 "storage/volume.py", "storage/disk_location.py",
                 "utils/sketch.py", "ec/volume.py", "storage/store.py"]


@pytest.mark.parametrize("module", STORAGE_LAYER)
def test_scan_covers_the_storage_layer(module):
    """The storage layer's modules are in the scanned set, each has its
    reference at the same path, and none imports jax, seaweedfs_tpu or
    google_crc32c."""
    path = os.path.join(REPO, "seaweedfs_tpu_torch", module)
    assert path in _port_python_files()
    assert os.path.exists(os.path.join(REPO, "seaweedfs_tpu", module))
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [n for n in names if _forbidden(n)]


DATA_PLANE_LAYER = ["native/build.py", "native/dataplane.py",
                    "storage/volume.py", "utils/faults.py",
                    "server/volume_server.py", "s3/native_front.py",
                    "s3/server.py", "filer/native_front.py",
                    "server/filer_server.py", "server/cluster.py",
                    "rpc/http.py", "cli.py"]


@pytest.mark.parametrize("module", DATA_PLANE_LAYER)
def test_scan_covers_the_native_data_plane(module):
    """The native data plane slice's new and changed modules are
    scanned, each has its reference at the same path, and none imports
    jax, seaweedfs_tpu, aiohttp, requests or anything the card's machine
    lacks."""
    path = os.path.join(REPO, "seaweedfs_tpu_torch", module)
    assert path in _port_python_files()
    assert os.path.exists(os.path.join(REPO, "seaweedfs_tpu", module))
    names = [n for _, n in _imports(path)]
    assert not [n for n in names if _forbidden(n) or _outside_the_card(n)]


def test_data_plane_builds_from_the_port_tree(monkeypatch):
    """native/dataplane.cc is compiled from the port's own tree into the
    gitignored _build/, plain and sanitized alike — never from
    seaweedfs_tpu/native/, whose prebuilt libraries sit beside their
    source."""
    from seaweedfs_tpu_torch.native import build

    port_native = os.path.join(REPO, "seaweedfs_tpu_torch", "native")
    assert build.DP_SRC == os.path.join(port_native, "dataplane.cc")
    assert os.path.exists(build.DP_SRC)
    assert build.BUILD_DIR == os.path.join(REPO, "seaweedfs_tpu_torch",
                                           "_build")
    monkeypatch.delenv(build.SANITIZE_ENV, raising=False)
    for mode in ("", "asan", "tsan"):
        path = build.dp_lib_path(mode)
        assert os.path.dirname(path) == build.BUILD_DIR, path
        assert "seaweedfs_tpu/native" not in path
    compiles = []
    monkeypatch.setattr(build, "_compile",
                        lambda src, lib, flags, verbose:
                        compiles.append((src, lib)) or lib)
    build.build_dataplane(verbose=False, mode="")
    assert compiles == [(build.DP_SRC, build.dp_lib_path(""))]
    with open(os.path.join(REPO, ".gitignore"), encoding="utf-8") as f:
        assert "seaweedfs_tpu_torch/_build/" in f.read().split()
    # the binding loads the library native/build.py names
    with open(os.path.join(port_native, "dataplane.py"),
              encoding="utf-8") as f:
        assert "ctypes.CDLL(_b.build_dataplane(" in f.read()


REMOTE_MOUNT_LAYER = ["rpc/meta_subscriber.py", "remote_storage/__init__.py",
                      "remote_storage/mount.py", "remote_storage/client.py",
                      "remote_storage/gcs_client.py",
                      "remote_storage/azure_client.py",
                      "remote_storage/sync.py", "remote_storage/gateway.py",
                      "utils/rs256.py", "utils/gcp_auth.py",
                      "shell/commands_fs.py", "shell/commands_s3.py",
                      "shell/commands_remote.py", "shell/repl.py",
                      "shell/env.py", "server/filer_server.py",
                      "filer/event_log.py", "cli.py"]


@pytest.mark.parametrize("module", REMOTE_MOUNT_LAYER)
def test_scan_covers_the_remote_mount_layer(module):
    """The metadata-stream and remote-mount slice's new and changed
    modules are scanned, each has its reference at the same path, and
    none imports jax, seaweedfs_tpu, aiohttp, requests or anything the
    card's machine lacks."""
    path = os.path.join(REPO, "seaweedfs_tpu_torch", module)
    assert path in _port_python_files()
    assert os.path.exists(os.path.join(REPO, "seaweedfs_tpu", module))
    names = [n for _, n in _imports(path)]
    assert not [n for n in names if _forbidden(n) or _outside_the_card(n)]
