"""The port's mesh codec (seaweedfs_tpu_torch/ops/codec_mesh.py,
`-ec.backend=mesh`), its mesh helpers (parallel/mesh.py), the mesh paths
of models/ec_pipeline.py and the three-way router, against the JAX
package's on the 8 CPU devices tests/conftest.py forces on JAX, as
tests/test_mesh_codec.py holds the reference. The port runs on a CPU
mesh of 8 entries (make_mesh(8, device="cpu")), where every piece goes
through the kernel's plain version. Tolerance 0 (integer GF(256)
arithmetic)."""
import time

import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import backend as ref_ecb
from seaweedfs_tpu.ec import probe as ref_probe
from seaweedfs_tpu.models import ec_pipeline as ref_ep
from seaweedfs_tpu.ops import codec_mesh as ref_codec_mesh
from seaweedfs_tpu.ops import schedule as ref_schedule
from seaweedfs_tpu.parallel import mesh as ref_pmesh
from seaweedfs_tpu_torch import cli
from seaweedfs_tpu_torch.ec import backend as ecb
from seaweedfs_tpu_torch.ec import probe
from seaweedfs_tpu_torch.models import ec_pipeline as ep
from seaweedfs_tpu_torch.ops import codec_mesh, codec_numpy, rs_matrix
from seaweedfs_tpu_torch.ops import schedule
from seaweedfs_tpu_torch.parallel import mesh as pmesh
from seaweedfs_tpu_torch.utils import metrics

NAME = {"jax": "cuda", "mesh": "mesh", "numpy": "numpy"}


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


@pytest.fixture(scope="module")
def cpu_mesh():
    return pmesh.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def mesh_codec(cpu_mesh):
    return codec_mesh.MeshCodec(cpu_mesh)


@pytest.fixture(scope="module")
def ref_codec():
    assert len(jax.devices()) == 8, "conftest provides 8 cpu devices"
    return ref_codec_mesh.MeshCodec()


@pytest.fixture(autouse=True)
def _router_state(monkeypatch, tmp_path):
    # the reference's mesh codec runs its dense kernel, as the port's
    # always does: no background measurement of the scheduled program
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SCHEDULE", "off")
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_PROBE_CACHE",
                       str(tmp_path / "ec_probe.json"))
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_BACKEND", raising=False)
    for mod in (pmesh, ref_pmesh):
        monkeypatch.delenv(mod.DEVICES_ENV, raising=False)
        monkeypatch.delenv(mod.COL_ENV, raising=False)
    monkeypatch.setattr(probe, "_curves", {})
    monkeypatch.setattr(ref_probe, "_curves", {})


# ---------------------------------------------------------------------
# the codec against the reference's and the numpy codec
# ---------------------------------------------------------------------

@pytest.mark.parametrize("km", [(10, 4), (28, 4)])
@pytest.mark.parametrize("n", [8192, 5000, 777, 8, 1])
def test_mesh_encode_matches_reference(mesh_codec, ref_codec, rng, km, n):
    """Even and uneven widths: the split over 8 devices (no padding) is
    byte-equal to the reference's pad -> shard -> trim, and to numpy."""
    k, m = km
    coef = rs_matrix.parity_rows(k, m)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    got = mesh_codec.coded_matmul(coef, data)
    assert got.shape == (m, n)
    assert np.array_equal(got, ref_codec.coded_matmul(coef, data)), (km, n)
    assert np.array_equal(got, codec_numpy.coded_matmul(coef, data))


@pytest.mark.parametrize("km", [(10, 4), (28, 4)])
def test_mesh_reconstruct_matches_reference(mesh_codec, ref_codec, rng,
                                            km):
    k, m = km
    rs_mesh = ecb.ReedSolomon(k, m, backend=mesh_codec)
    rs_ref = ref_ecb.ReedSolomon(k, m, backend=ref_codec)
    data = rng.integers(0, 256, (k, 3001), dtype=np.uint8)
    parity = rs_mesh.encode(data)
    assert np.array_equal(parity, rs_ref.encode(data))
    full = np.concatenate([data, parity], axis=0)
    drop = [0, 3, k + 1, k + 3]
    shards = {i: full[i] for i in range(k + m) if i not in drop}
    rec, want = rs_mesh.reconstruct(shards), rs_ref.reconstruct(shards)
    assert sorted(rec) == sorted(want) == sorted(drop)
    for sid in drop:
        assert np.array_equal(rec[sid], want[sid]), (km, sid)
        assert np.array_equal(rec[sid], full[sid]), (km, sid)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_mesh_stream_matches_reference_all_depths(mesh_codec, ref_codec,
                                                  rng, depth):
    """Order kept, uneven widths and an empty block mid-stream, equal to
    the reference's stream at every depth; stages recorded as `mesh`."""
    coef = rs_matrix.parity_rows(10, 4)
    widths = [4096, 1000, 0, 257, 8192, 3]
    blocks = [rng.integers(0, 256, (10, w), dtype=np.uint8)
              for w in widths]
    lab = {"stage": "kernel", "backend": "mesh"}
    before = metrics.counter_value("ec_codec_stage_seconds_count", lab)
    outs = list(mesh_codec.coded_matmul_stream(coef, iter(blocks),
                                               depth=depth))
    want = list(ref_codec.coded_matmul_stream(coef, iter(blocks),
                                              depth=depth))
    assert len(outs) == len(want) == len(blocks)
    for out, ref, blk in zip(outs, want, blocks):
        assert out.shape == (4, blk.shape[1])
        assert np.array_equal(out, ref)
    # one observation per non-empty block, not one per device
    assert metrics.counter_value("ec_codec_stage_seconds_count", lab) == \
        before + len([w for w in widths if w])


@pytest.mark.parametrize("km", [(10, 4), (28, 4)])
def test_mesh_kernel_matches_reference(rng, km):
    """_mesh_kernel (the dense float32 product) against the reference's
    XLA program."""
    import jax.numpy as jnp

    k, m = km
    stripes = rng.integers(0, 256, (4, k, 333), dtype=np.uint8)
    a_bits = ep.parity_bit_matrix(k, m)
    want = np.asarray(ref_codec_mesh._mesh_kernel(
        jnp.asarray(a_bits, dtype=jnp.bfloat16), jnp.asarray(stripes)))
    got = codec_mesh._mesh_kernel(torch.from_numpy(a_bits),
                                  torch.from_numpy(stripes))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("lost", [None, (1, 4, 11, 13)])
def test_mesh_sched_kernel_matches_reference(rng, lost):
    """_mesh_sched_kernel (the XOR program batched over vol) against the
    reference's, for RS(10,4) parity and recovery rows."""
    import jax.numpy as jnp

    if lost is None:
        coef = rs_matrix.parity_rows(10, 4)
    else:
        present = [i for i in range(14) if i not in lost]
        coef, _ = rs_matrix.recovery_rows(10, 4, present, list(lost))
    stripes = rng.integers(0, 256, (3, 10, 129), dtype=np.uint8)
    want = np.asarray(ref_codec_mesh._mesh_sched_kernel(
        ref_schedule.plan_for(coef), jnp.asarray(stripes)))
    got = codec_mesh._mesh_sched_kernel(schedule.plan_for(coef),
                                        torch.from_numpy(stripes))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got[1].numpy(),
                          codec_numpy.coded_matmul(coef, stripes[1]))


def test_mesh_registered_and_needs_a_gpu(monkeypatch):
    assert "mesh" in ecb.backend_names()
    assert ecb.get_backend("mesh").name == "mesh" \
        if torch.cuda.is_available() else True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        codec_mesh.MeshCodec()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ep.rebuild_mesh()
    geo = codec_mesh.MeshCodec(device="cpu").describe()
    assert geo == {"devices": 8, "vol": 4, "col": 2, "platform": "cpu"}
    assert geo == dict(ref_codec_mesh.MeshCodec().describe(),
                       platform="cpu")


# ---------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------

@pytest.mark.parametrize("km", [(10, 4), (28, 4)])
def test_pad_to_mesh_roundtrip_uneven(rng, cpu_mesh, km):
    """pad_to_mesh equals the reference's on uneven batch and columns;
    the sharded encode over the padded tensor, sliced back, equals the
    reference's, and so does the port's over the unpadded one."""
    k, m = km
    mesh = ref_pmesh.make_mesh()
    vol, col = mesh.devices.shape
    assert cpu_mesh.devices.shape == (vol, col)
    batch, cols = vol + 1, 100 * col + 3  # both indivisible
    stripes = rng.integers(0, 256, (batch, k, cols), dtype=np.uint8)

    padded, orig = pmesh.pad_to_mesh(stripes, cpu_mesh)
    ref_padded, ref_orig = ref_pmesh.pad_to_mesh(stripes, mesh)
    assert orig == ref_orig == (batch, cols)
    assert np.array_equal(padded, ref_padded)
    assert padded.shape[0] % vol == 0 and padded.shape[2] % col == 0

    fn, a1 = ref_ep.jitted_encode(k, m)
    want = np.asarray(fn(a1, stripes))
    step, a_bits, place = ep.sharded_encode_scrub(cpu_mesh, k, m)
    zeros = np.zeros((padded.shape[0], m, padded.shape[2]), np.uint8)
    parity, _ = step(a_bits, place(padded), place(zeros))
    assert np.array_equal(parity.gather().numpy()[:batch, :, :cols], want)
    parity, mism = step(a_bits, stripes, want)
    assert np.array_equal(parity.gather().numpy(), want)
    assert int(mism) == 0


def test_pad_to_mesh_even_is_identity(rng, cpu_mesh):
    vol, col = cpu_mesh.devices.shape
    arr = rng.integers(0, 256, (2 * vol, 10, 64 * col), dtype=np.uint8)
    padded, orig = pmesh.pad_to_mesh(arr, cpu_mesh)
    assert padded is arr
    assert orig == (arr.shape[0], arr.shape[2])


def test_make_mesh_errors_and_shapes():
    n = len(pmesh.local_devices("cpu"))
    assert n == len(jax.devices()) == 8
    with pytest.raises(ValueError):
        pmesh.make_mesh(n, col_parallel=n + 1, device="cpu")
    with pytest.raises(ValueError):
        pmesh.make_mesh(n, col_parallel=3, device="cpu")
    with pytest.raises(ValueError):
        pmesh.make_mesh(n + 1, device="cpu")  # more than the host has
    for nd, col in ((8, None), (4, None), (6, 3), (1, None), (3, None)):
        got = pmesh.make_mesh(nd, col, device="cpu").devices.shape
        assert got == ref_pmesh.make_mesh(nd, col).devices.shape, nd


def test_mesh_config_env_parsing(monkeypatch):
    monkeypatch.setenv(pmesh.DEVICES_ENV, "4")
    monkeypatch.setenv(pmesh.COL_ENV, "2")
    assert pmesh.mesh_config() == ref_pmesh.mesh_config() == (4, 2)
    monkeypatch.setenv(pmesh.DEVICES_ENV, "garbage")
    monkeypatch.setenv(pmesh.COL_ENV, "-3")
    assert pmesh.mesh_config() == ref_pmesh.mesh_config() == (None, None)
    monkeypatch.delenv(pmesh.DEVICES_ENV)
    monkeypatch.delenv(pmesh.COL_ENV)
    assert pmesh.mesh_config() == (None, None)
    assert (pmesh.DEVICES_ENV, pmesh.COL_ENV) == \
        (ref_pmesh.DEVICES_ENV, ref_pmesh.COL_ENV)


def test_mesh_codec_respects_env_shape(monkeypatch):
    monkeypatch.setenv(pmesh.DEVICES_ENV, "2")
    monkeypatch.setenv(pmesh.COL_ENV, "1")
    codec = codec_mesh.MeshCodec(device="cpu")
    assert (codec.n_devices, codec.vol, codec.col) == (2, 2, 1)
    assert metrics.render().count("ec_mesh_devices 2") == 1


def test_cli_mesh_flags_reach_the_codec(monkeypatch):
    """-ec.backend=mesh -ec.mesh.devices 4 -ec.mesh.col 2 set the env
    knobs, and a MeshCodec built after reads them."""
    args = cli.build_parser().parse_args(
        ["volume", "-ec.backend=mesh", "-ec.mesh.devices", "4",
         "-ec.mesh.col", "2"])
    assert args.ec_backend == "mesh"
    cli.apply_env_flags(args)
    assert pmesh.mesh_config() == (4, 2)
    geo = codec_mesh.MeshCodec(device="cpu").describe()
    assert (geo["devices"], geo["vol"], geo["col"]) == (4, 2, 2)
    monkeypatch.delenv(pmesh.DEVICES_ENV)
    monkeypatch.delenv(pmesh.COL_ENV)


# ---------------------------------------------------------------------
# the feeds of models/ec_pipeline.py, with and without a mesh
# ---------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("with_mesh", [False, True])
def test_pipelined_encode_stream_matches_reference(rng, cpu_mesh, depth,
                                                   with_mesh):
    blocks = [rng.integers(0, 256, (3, 10, 300 + 17 * i), dtype=np.uint8)
              for i in range(4)]  # uneven batch and columns throughout
    ref_mesh = ref_pmesh.make_mesh() if with_mesh else None
    want = list(ref_ep.pipelined_encode_stream(iter(blocks), depth=depth,
                                               mesh=ref_mesh))
    got = list(ep.pipelined_encode_stream(
        iter(blocks), depth=depth, mesh=cpu_mesh if with_mesh else None,
        device="cpu"))
    assert len(got) == len(want) == len(blocks)
    for out, ref in zip(got, want):
        assert out.shape == ref.shape
        assert np.array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("with_mesh", [False, True])
def test_pipelined_scrub_counts_match_reference(rng, cpu_mesh, with_mesh):
    fn, a_bits = ref_ep.jitted_encode()
    pairs = []
    for i in range(3):
        stripes = rng.integers(0, 256, (3, 10, 501 + i), dtype=np.uint8)
        pairs.append((stripes, np.asarray(fn(a_bits, stripes))))
    bad = [(s, p.copy()) for s, p in pairs]
    bad[0][1][0, 0, 0] ^= 0xFF
    bad[2][1][2, 3, 500] ^= 0x01
    bad[2][1][1, 1, 7] ^= 0x10
    ref_mesh = ref_pmesh.make_mesh() if with_mesh else None
    mesh = cpu_mesh if with_mesh else None
    for feed, want in ((pairs, (0, 3)), (bad, (3, 3))):
        got = ep.pipelined_scrub(iter(feed), mesh=mesh, device="cpu")
        assert got == ref_ep.pipelined_scrub(iter(feed), mesh=ref_mesh) \
            == want


def test_sharded_encode_scrub_matches_reference(rng, cpu_mesh):
    mesh = ref_pmesh.make_mesh()
    stripes = rng.integers(0, 256, (8, 10, 256), dtype=np.uint8)
    step, a_bits, data_sh = ref_ep.sharded_encode_scrub(mesh)
    fn, a1 = ref_ep.jitted_encode()
    expected = np.array(fn(a1, stripes))
    expected[5, 2, 100] ^= 4
    want_p, want_m = step(a_bits, jax.device_put(stripes, data_sh),
                          jax.device_put(expected, data_sh))
    pstep, pa, place = ep.sharded_encode_scrub(cpu_mesh)
    got_p, got_m = pstep(pa, place(stripes), place(expected))
    assert int(got_m) == int(want_m) == 1
    assert np.array_equal(got_p.gather().numpy(), np.asarray(want_p))
    assert len(got_p.pieces) == 8


# ---------------------------------------------------------------------
# three-way router, fingerprint, snapshot
# ---------------------------------------------------------------------

def _curves(cpu_mbps, rows=(), mesh_rows=()):
    """(port curve, reference curve) holding the same measured rows."""
    def one(fp, platform, dev_name):
        curve = {"fingerprint": fp, "measured_at": time.time(),
                 "rows": [dict(r) for r in rows], "cpu_backend": "numpy",
                 "cpu_mbps": cpu_mbps,
                 "device": {"platform": platform, "kind": "test",
                            "count": 8},
                 "device_backend": dev_name}
        if mesh_rows:
            curve["mesh_rows"] = [dict(r) for r in mesh_rows]
            curve["mesh"] = {"devices": 8, "vol": 4, "col": 2,
                             "platform": platform}
        return curve

    return (one(probe.host_fingerprint(), "gpu", "cuda"),
            one(ref_probe.host_fingerprint(), "tpu", "jax"))


def _rows(rates):
    return [{"size": s, "depth": d, "e2e_mbps": r}
            for (s, d), r in rates.items()]


SIZES = [1, 1 << 20, 4 << 20, 8 << 20, 64 << 20, 1 << 30]


def test_router_picks_mesh_when_fastest(monkeypatch):
    port, ref = _curves(300.0,
                        rows=_rows({(1 << 20, 1): 400.0,
                                    (64 << 20, 2): 900.0}),
                        mesh_rows=_rows({(1 << 20, 1): 100.0,
                                         (64 << 20, 4): 4000.0}))
    # small requests cannot amortize the scatter: one card wins
    assert ecb._decide(port, 1 << 20) == "cuda"
    # bulk rides the mesh
    assert ecb._decide(port, 64 << 20) == "mesh"
    for size in SIZES:
        assert ecb._decide(port, size) == NAME[ref_ecb._decide(ref, size)]
    monkeypatch.setattr(probe, "_curves", {"": port})
    monkeypatch.setattr(ref_probe, "_curves", {"": ref})
    assert ecb.choose_backend_for_size(64 << 20) == "mesh"
    # depth for a mesh-routed size comes from the MESH rows
    assert ecb.pipeline_depth_for(64 << 20) == 4
    assert ecb.pipeline_depth_for(1 << 20) == 1
    for size in SIZES:
        assert ecb.pipeline_depth_for(size) == \
            ref_ecb.pipeline_depth_for(size), size


def test_router_never_picks_mesh_below_cpu():
    port, ref = _curves(500.0, rows=_rows({(64 << 20, 2): 90.0}),
                        mesh_rows=_rows({(64 << 20, 4): 400.0}))
    for size in (1 << 20, 64 << 20, 1 << 30):
        assert ecb._decide(port, size) == "numpy" == \
            ref_ecb._decide(ref, size), size


def test_router_mesh_interpolation_and_buckets():
    port, ref = _curves(100.0, rows=_rows({(1 << 20, 1): 50.0}),
                        mesh_rows=_rows({(1 << 20, 1): 200.0,
                                         (64 << 20, 4): 800.0}))
    assert probe.mesh_mbps_at(port, 1 << 20) == 200.0
    assert probe.mesh_mbps_at(port, 64 << 20) == 800.0
    assert 200.0 < probe.mesh_mbps_at(port, 8 << 20) < 800.0
    for size in SIZES:
        assert probe.mesh_mbps_at(port, size) == \
            ref_probe.mesh_mbps_at(ref, size)
        assert probe.mesh_depth_at(port, size) == \
            ref_probe.mesh_depth_at(ref, size)
    buckets = ecb.router_buckets(port)
    want = ref_ecb.router_buckets(ref)
    assert [dict(b, backend=NAME[b["backend"]]) for b in want] == buckets
    assert buckets[-1]["backend"] == "mesh"
    # no mesh rows: the readers give None / the default depth
    bare, _ = _curves(100.0, rows=_rows({(1 << 20, 1): 50.0}))
    assert probe.mesh_mbps_at(bare, 4 << 20) is None
    assert probe.mesh_depth_at(bare, 4 << 20) == 2


def test_fingerprint_carries_device_count_and_mesh_knobs(monkeypatch,
                                                         tmp_path):
    """A curve swept with another set of cards, or under other mesh
    knobs, is not trusted."""
    import json

    fp = probe.host_fingerprint()
    assert fp["device_count"] == torch.cuda.device_count()
    assert fp["probe_version"] == probe.PROBE_VERSION >= 2
    assert fp["mesh_config"] == [None, None]
    stale, _ = _curves(100.0, rows=_rows({(1 << 20, 1): 50.0}))
    stale["fingerprint"] = dict(stale["fingerprint"],
                                device_count=fp["device_count"] + 1)
    path = tmp_path / "ec_probe.json"
    path.write_text(json.dumps(stale))
    assert probe.load_cached() is None
    fresh, _ = _curves(100.0, rows=_rows({(1 << 20, 1): 50.0}))
    path.write_text(json.dumps(fresh))
    assert probe.load_cached() is not None
    monkeypatch.setenv(pmesh.DEVICES_ENV, "2")
    assert probe.host_fingerprint() != fp
    assert probe.load_cached() is None


def test_mesh_geometry_in_debug_snapshot(monkeypatch):
    monkeypatch.setattr(ecb, "_instances", dict(ecb._instances))
    ecb._instances.pop("mesh", None)
    monkeypatch.setenv(pmesh.DEVICES_ENV, "4")
    assert ecb.probe_snapshot()["mesh"] == \
        {"state": "unbuilt", "devices": 4, "col": None}
    ecb._instances["mesh"] = codec_mesh.MeshCodec(device="cpu")
    geo = ecb.probe_snapshot()["mesh"]
    assert geo["state"] == "active"
    assert geo["devices"] == geo["vol"] * geo["col"] == 4


def test_summary_includes_mesh_rows():
    port, ref = _curves(100.0, rows=_rows({(1 << 20, 1): 50.0}),
                        mesh_rows=_rows({(64 << 20, 4): 800.0}))
    s = probe.summary(port)
    assert s["mesh"]["devices"] == 8
    assert s["mesh_best_by_size_mb"]["64"]["e2e_mbps"] == 800.0
    assert s["mesh_best_by_size_mb"] == \
        ref_probe.summary(ref)["mesh_best_by_size_mb"]


def test_cpu_sweep_measures_mesh_rows():
    """A CPU sweep with a mesh codec passed in measures its rows under
    the same protocol (the card's sweep does so whenever more than one
    card is visible)."""
    mesh = codec_mesh.MeshCodec(pmesh.make_mesh(2, device="cpu"))
    curve = probe.run_sweep(sizes=(1 << 16, 1 << 18), depths=(1, 2),
                            budget_s=60, with_ceilings=False,
                            device="cpu", mesh=mesh)
    assert curve["mesh"] == mesh.describe()
    rows = curve["mesh_rows"]
    assert [(r["size"], r["depth"]) for r in rows] == \
        [(1 << 16, 1), (1 << 16, 2), (1 << 18, 1), (1 << 18, 2)]
    assert all(r["e2e_mbps"] > 0 and r["stages_s"]["kernel"] > 0
               for r in rows)
    assert probe.mesh_mbps_at(curve, 1 << 18) is not None
    assert "mesh_best_by_size_mb" in probe.summary(curve)
