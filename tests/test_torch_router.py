"""The measured router of the port (seaweedfs_tpu_torch/ec/probe.py and
the router of ec/backend.py) against the JAX package's, on the same
injected curves, under the name map pallas -> cuda, jax -> torch (the
device backends the two probes prefer), as tests/test_codec_backends.py
and tests/test_ec_codes.py hold the reference. Also the probe cache, a
real CPU sweep (device="cpu", which drives the kernel's plain version),
and the port's device rules: `auto` raises without a card, a failing
device row raises, and AutoCodec pins one backend per operation."""
import json
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import backend as ref_ecb
from seaweedfs_tpu.ec import probe as ref_probe
from seaweedfs_tpu_torch.ec import backend as ecb
from seaweedfs_tpu_torch.ec import probe
from seaweedfs_tpu_torch.ops import codec_cuda, codec_numpy, rs_matrix

NAME = {"pallas": "cuda", "jax": "torch", "numpy": "numpy",
        "native": "native"}
SIZES = [1, 1 << 18, 1 << 20, 2 << 20, 4 << 20, 11 << 20, 16 << 20,
         40 << 20, 64 << 20, 1 << 30]


@pytest.fixture(autouse=True)
def _router_state(monkeypatch, tmp_path):
    """Each test gets its own cache file, empty curve memos and no
    backend override, in both packages."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_PROBE_CACHE",
                       str(tmp_path / "ec_probe.json"))
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_BACKEND", raising=False)
    monkeypatch.setattr(probe, "_curves", {})
    monkeypatch.setattr(ref_probe, "_curves", {})
    monkeypatch.setattr(ecb, "_auto_choice", None)


def _curves(cpu_mbps, rates, cpu="numpy", device="pallas"):
    """(port curve, reference curve) holding the same measured rows."""
    rows = [{"size": s, "depth": d, "e2e_mbps": r}
            for (s, d), r in rates.items()]
    ref = {"fingerprint": ref_probe.host_fingerprint(),
           "measured_at": time.time(), "rows": [dict(r) for r in rows],
           "cpu_backend": cpu, "cpu_mbps": cpu_mbps,
           "device": {"platform": "tpu", "kind": "test", "count": 1},
           "device_backend": device}
    port = {"fingerprint": probe.host_fingerprint(),
            "measured_at": time.time(), "rows": [dict(r) for r in rows],
            "cpu_backend": NAME[cpu], "cpu_mbps": cpu_mbps,
            "device": {"platform": "gpu", "kind": "test", "count": 1},
            "device_backend": NAME[device]}
    return port, ref


CURVES = {
    "monotone": (50.0, {(1 << 20, 1): 10.0, (1 << 20, 2): 8.0,
                        (4 << 20, 2): 40.0, (16 << 20, 2): 160.0,
                        (16 << 20, 4): 120.0, (64 << 20, 4): 320.0}),
    "slow_device": (327.0, {(1 << 20, 2): 3.0, (4 << 20, 2): 6.0,
                            (16 << 20, 2): 9.0, (64 << 20, 4): 9.5}),
    "fast_device": (300.0, {(1 << 20, 1): 50.0, (4 << 20, 2): 250.0,
                            (16 << 20, 2): 900.0, (64 << 20, 4): 2000.0}),
    "one_row": (100.0, {(4 << 20, 1): 400.0}),
    "empty": (100.0, {}),
}


@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("device", ["pallas", "jax"])
def test_curve_reading_and_decisions_match_reference(curve, device):
    cpu_mbps, rates = CURVES[curve]
    port, ref = _curves(cpu_mbps, rates, device=device)
    assert probe.best_by_size(port) == ref_probe.best_by_size(ref)
    for size in SIZES:
        assert probe.e2e_mbps_at(port, size) == \
            ref_probe.e2e_mbps_at(ref, size), size
        assert probe.depth_at(port, size) == ref_probe.depth_at(ref, size)
        assert ecb._decide(port, size) == NAME[ref_ecb._decide(ref, size)]
    got, want = ecb.router_buckets(port), ref_ecb.router_buckets(ref)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["backend"] == NAME[w["backend"]]
        for key in ("size_mb", "pinned_by_env", "device_e2e_mbps",
                    "cpu_mbps", "depth"):
            assert g[key] == w[key], key
    summary, ref_summary = probe.summary(port), ref_probe.summary(ref)
    for key in ("cpu_mbps", "best_by_size_mb", "skipped_rows"):
        assert summary[key] == ref_summary[key]


def test_router_interpolates_monotonically():
    port, _ = _curves(*CURVES["monotone"])
    ys = [probe.e2e_mbps_at(port, x) for x in SIZES]
    assert ys == sorted(ys)
    assert ys[0] == 10.0 and ys[-1] == 320.0  # clamped, no extrapolation
    assert probe.depth_at(port, 16 << 20) == 2
    assert probe.depth_at(port, 64 << 20) == 4


@pytest.mark.parametrize("curve", ["slow_device", "fast_device"])
def test_choose_and_depth_from_the_memo_match_reference(monkeypatch,
                                                        curve):
    port, ref = _curves(*CURVES[curve], cpu="native")
    monkeypatch.setattr(probe, "_curves", {"": port})
    monkeypatch.setattr(ref_probe, "_curves", {"": ref})
    for size in SIZES:
        assert ecb.choose_backend_for_size(size) == \
            NAME[ref_ecb.choose_backend_for_size(size)]
        assert ecb.pipeline_depth_for(size) == \
            ref_ecb.pipeline_depth_for(size)
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_BACKEND", "numpy")
    assert ecb.choose_backend_for_size(1 << 30) == "numpy" == \
        ref_ecb.choose_backend_for_size(1 << 30)
    assert ecb.router_buckets(port)[0]["pinned_by_env"]


def test_no_curve_means_double_buffer():
    assert ecb.pipeline_depth_for(64 << 20) == 2 == \
        ref_ecb.pipeline_depth_for(64 << 20)


def test_probe_cache_roundtrip():
    port, _ = _curves(*CURVES["one_row"])
    probe.save_cache(port)
    got = probe.load_cached()
    assert got is not None and got["rows"] == port["rows"]
    assert probe.peek()["source"] == "cache"
    assert probe.get_curve()["rows"] == port["rows"]


def test_default_cache_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_PROBE_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert probe.cache_path() == str(
        tmp_path / "seaweedfs_tpu_torch" / "ec_probe.json")
    assert probe.cache_path() != ref_probe.cache_path()
    assert probe.cache_path("lrc-10.2.2").endswith(
        "ec_probe-lrc-10_2_2.json")


def test_probe_cache_corrupt_means_a_fresh_sweep(monkeypatch, tmp_path):
    path = tmp_path / "ec_probe.json"
    path.write_text('{"rows": [1, 2')  # truncated JSON
    assert probe.load_cached() is None
    sentinel, _ = _curves(1.0, {})
    monkeypatch.setattr(probe, "run_sweep", lambda **kw: dict(sentinel))
    got = probe.get_curve()
    assert got["source"] == "fresh" and got["cpu_mbps"] == 1.0
    # the fresh sweep replaced the corrupt file
    assert json.loads(path.read_text())["cpu_mbps"] == 1.0


def test_probe_cache_expired_or_foreign_is_a_miss():
    expired, _ = _curves(100.0, {})
    expired["measured_at"] -= probe.cache_ttl_s() + 60
    probe.save_cache(expired)
    assert probe.load_cached() is None
    foreign, _ = _curves(100.0, {})
    foreign["fingerprint"] = dict(foreign["fingerprint"],
                                  host="someone-else")
    probe.save_cache(foreign)
    assert probe.load_cached() is None
    other_card, _ = _curves(100.0, {})
    other_card["fingerprint"] = dict(
        other_card["fingerprint"],
        device={"platform": "gpu", "kind": "another card", "count": 1})
    probe.save_cache(other_card)
    assert probe.load_cached() is None


def test_probe_fingerprint_differs_per_code():
    fp_rs = probe.code_fingerprint("")
    fp_lrc = probe.code_fingerprint("lrc-10.2.2")
    assert fp_rs == ref_probe.code_fingerprint("")
    assert fp_lrc == ref_probe.code_fingerprint("lrc-10.2.2")
    assert fp_rs["matrix_hash"] != fp_lrc["matrix_hash"]
    assert probe.cache_path("lrc-10.2.2") != probe.cache_path("")
    fp = probe.host_fingerprint("lrc-10.2.2")
    assert fp["code"] == fp_lrc and "default_code" not in fp
    assert fp["torch"] == torch.__version__


def test_code_table_and_snapshot_match_reference():
    got = {r["spec"]: r for r in ecb.code_table()}
    want = {r["spec"]: r for r in ref_ecb.code_table()}
    assert sorted(got) == sorted(want) == sorted(ecb.KNOWN_CODES)
    for spec, row in got.items():
        for key in ("kind", "k", "locals", "globals", "total",
                    "storage_overhead", "repair_fanin", "default"):
            assert row[key] == want[spec][key], (spec, key)
    snap = ecb.probe_snapshot()
    assert snap["probe"] == {"state": "unprobed"}
    assert set(snap["code_buckets"]) == set(ecb.KNOWN_CODES)


def test_cpu_sweep_rows_are_well_formed():
    sizes, depths = (64 << 10, 256 << 10), (1, 2)
    t0 = time.perf_counter()
    curve = probe.run_sweep(sizes=sizes, depths=depths, device="cpu")
    assert time.perf_counter() - t0 < 30
    assert curve["device"] == {"platform": "cpu", "kind": "cpu",
                               "count": 1}
    assert curve["device_backend"] == "cuda"
    assert curve["cpu_backend"] == ecb.cpu_backend_name()
    assert curve["cpu_mbps"] > 0
    assert curve["fingerprint"] == probe.host_fingerprint()
    assert [(r["size"], r["depth"]) for r in curve["rows"]] == \
        [(s, d) for s in sizes for d in depths]
    for r in curve["rows"]:
        assert r["blocks"] == r["depth"] + 2
        assert r["e2e_mbps"] > 0 and r["xfer_ceiling_mbps"] > 0
        assert r["vs_ceiling"] > 0
        assert set(r["stages_s"]) == set(probe.STAGES)
        assert r["stages_s"]["kernel"] > 0
    assert len(probe.best_by_size(curve)) == 2
    json.dumps(curve)   # the cache format


def test_budget_skipped_rows_stay_marked():
    curve = probe.run_sweep(sizes=(64 << 10,), depths=(1, 2), budget_s=0,
                            device="cpu")
    assert [r.get("skipped") for r in curve["rows"]] == ["budget"] * 2
    assert probe.e2e_mbps_at(curve, 1 << 20) is None


def test_a_failing_device_row_raises(monkeypatch):
    real = codec_cuda.CudaCodec.coded_matmul_stream

    def broken(self, coef, blocks, depth=2):
        blocks = list(blocks)
        if blocks[0].shape[1] == (256 << 10) // 10:
            raise RuntimeError("device row failed")
        yield from real(self, coef, iter(blocks), depth=depth)

    monkeypatch.setattr(codec_cuda.CudaCodec, "coded_matmul_stream",
                        broken)
    with pytest.raises(RuntimeError, match="device row failed"):
        probe.run_sweep(sizes=(64 << 10, 256 << 10), depths=(1,),
                        device="cpu")


def test_auto_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.run_sweep()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ecb.choose_backend_for_size(64 << 20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ecb.choose_auto_backend()
    rs = ecb.ReedSolomon(10, 4, backend=ecb.AutoCodec())
    data = np.zeros((10, 64), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rs.encode(data)
    assert probe.peek() is None


def test_auto_codec_pins_one_backend_per_operation(monkeypatch):
    """Device measured faster from 16 MiB up, the CPU codec below: an
    unpinned AutoCodec routes each call by its size; resolve_for pins
    one backend for the whole operation."""
    port, _ = _curves(300.0, {(1 << 20, 1): 50.0, (16 << 20, 2): 900.0,
                              (64 << 20, 4): 2000.0}, cpu="native")
    monkeypatch.setattr(probe, "_curves", {"": port})
    monkeypatch.setitem(ecb._instances, "cuda",
                        codec_cuda.CudaCodec(device="cpu"))
    coef = rs_matrix.parity_rows(10, 4)
    x = np.random.default_rng(1).integers(0, 256, (10, 999),
                                          dtype=np.uint8)
    want = codec_numpy.coded_matmul(coef, x)
    auto = ecb.AutoCodec()
    assert np.array_equal(auto.coded_matmul(coef, x), want)
    assert auto.chosen == "native"
    assert ecb._codec_label(auto) == "native"
    assert auto.resolve_for(64 << 20).name == "cuda"
    assert np.array_equal(auto.coded_matmul(coef, x), want)
    assert auto.chosen == "cuda"       # pinned: a small call stays put
    assert np.array_equal(
        np.concatenate(list(auto.coded_matmul_stream(
            coef, iter([x[:, :500], x[:, 500:]]))), axis=1), want)
    assert auto.resolve_for(1 << 20).name == "native"
    fresh = ecb.AutoCodec()
    assert fresh._resolve().name == "cuda"     # the bulk-size choice
    assert ecb.choose_auto_backend() == "cuda"
    lrc = ecb.ReedSolomon(0, 0, backend="auto", code="lrc-10.2.2")
    assert isinstance(lrc.backend, ecb.AutoCodec)
    assert lrc.backend is not ecb.get_backend("auto")
    assert lrc.backend.code_spec == "lrc-10.2.2"
