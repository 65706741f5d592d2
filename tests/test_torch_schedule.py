"""The XOR-schedule pass of the port (seaweedfs_tpu_torch/ops/schedule.py)
and its torch executor (codec_torch.xor_matmul) against the JAX
package's schedule and codec_jax._xor_matmul_body (jitted on the CPU),
on the same seeded numpy inputs; tolerance 0 (integer GF(2) programs).
Also the Chooser's on/off/auto behaviour beside the reference's, and the
port's one deliberate difference: a scheduled program that raises
propagates instead of counting as a dense win."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import geometry as ref_geo
from seaweedfs_tpu.ops import codec_jax, rs_matrix
from seaweedfs_tpu.ops import schedule as ref_schedule
from seaweedfs_tpu_torch.ops import codec_numpy, codec_torch, schedule

_ENV = "SEAWEEDFS_TPU_EC_SCHEDULE"


def _coef(name: str) -> np.ndarray:
    """Parity rows of a code, or "<spec>/rec<ids>" recovery rows."""
    spec, _, lost = name.partition("/rec")
    code = ref_geo.parse_code(spec)
    if not lost:
        return rs_matrix.parity_rows_for(code)
    missing = [int(v) for v in lost.split(",")]
    present = [i for i in range(code.total) if i not in missing]
    return rs_matrix.recovery_rows_for(code, present, missing)[0]


MATRICES = ["10.4", "28.4", "lrc-10.2.2", "lrc-12.3.2",
            "10.4/rec1,4,11,13", "lrc-10.2.2/rec3"]


@pytest.mark.parametrize("name", MATRICES)
def test_build_program_and_flatten_match_reference(name):
    coef = _coef(name)
    got = schedule.build_program(coef)
    want = ref_schedule.build_program(coef)
    assert (got.n_in, got.n_out, got.naive_xors) == \
        (want.n_in, want.n_out, want.naive_xors)
    assert got.ops == want.ops and got.outputs == want.outputs
    assert got.xors <= got.naive_xors
    assert np.array_equal(schedule.flatten(got), ref_schedule.flatten(want))


@pytest.mark.parametrize("name", ["10.4", "lrc-10.2.2/rec3"])
def test_plan_memo_and_summary(name):
    coef = _coef(name)
    assert schedule.plan_for(coef) is schedule.plan_for(coef)
    assert schedule.summary_for(coef) == ref_schedule.summary_for(coef)


@pytest.mark.parametrize("name", ["10.4", "lrc-10.2.2"])
@pytest.mark.parametrize("width", [1, 777, 4099])
def test_xor_program_matches_reference(name, width):
    coef = _coef(name)
    plan = schedule.plan_for(coef)
    rng = np.random.default_rng(width * 7 + coef.shape[1])
    x = rng.integers(0, 256, (coef.shape[1], width), dtype=np.uint8)
    got = codec_torch.xor_matmul(plan, torch.from_numpy(x)).numpy()
    ref_plan = ref_schedule.plan_for(coef)
    body = jax.jit(codec_jax._xor_matmul_body, static_argnums=(0,))
    want = np.asarray(body(ref_plan, jnp.asarray(x)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref_schedule.apply_bytes_numpy(ref_plan, x))
    assert np.array_equal(got, codec_numpy.coded_matmul(coef, x))


@pytest.mark.parametrize("name", ["10.4/rec1,4,11,13", "lrc-12.3.2"])
def test_xor_program_matches_numpy_oracle(name):
    coef = _coef(name)
    plan = schedule.plan_for(coef)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (coef.shape[1], 1501), dtype=np.uint8)
    bits = schedule.gf256.unpack_bits(x)
    assert np.array_equal(schedule.apply_numpy(plan, bits),
                          ref_schedule.apply_numpy(plan, bits))
    got = codec_torch.xor_matmul(plan, torch.from_numpy(x)).numpy()
    assert np.array_equal(got, schedule.apply_bytes_numpy(plan, x))


def test_xor_program_releases_dead_intermediates():
    """The pool keeps one plane row per LIVE variable: replaying the
    release schedule, the widest cut of RS(10,4)'s program stays under
    half its op count (each row is 2 MiB at the default slab; without
    the release every op's row would stay alive)."""
    plan = schedule.plan_for(_coef("10.4"))
    dead = codec_torch._dead_after(plan)
    live, widest = set(), 0
    for (dst, a, b), gone in zip(plan.ops, dead):
        live.add(dst)
        live -= set(gone)
        widest = max(widest, len(live))
    assert set(plan.outputs) <= live
    assert widest < len(plan.ops) // 2, (widest, len(plan.ops))


def _choosers():
    return schedule.Chooser(), ref_schedule.Chooser()


@pytest.mark.parametrize("mode", ["on", "off", "auto"])
@pytest.mark.parametrize("faster", ["sched", "dense"])
@pytest.mark.parametrize("nbytes", [schedule.MIN_SCHED_BYTES - 1,
                                    schedule.MIN_SCHED_BYTES])
def test_chooser_modes_match_reference(monkeypatch, mode, faster, nbytes):
    monkeypatch.setenv(_ENV, mode)
    coef = _coef("10.4")

    def slow():
        time.sleep(0.003)

    def fast():
        pass

    run_sched, run_dense = (fast, slow) if faster == "sched" else \
        (slow, fast)
    port, ref = _choosers()
    got = [port.use_scheduled(coef, nbytes, run_sched, run_dense)
           for _ in range(2)]
    want = [ref.use_scheduled(coef, nbytes, run_sched, run_dense)
            for _ in range(2)]
    assert got == want
    measured = mode == "auto" and nbytes >= schedule.MIN_SCHED_BYTES
    assert port.snapshot()["buckets"] == int(measured)
    if measured:
        (v,) = port.snapshot()["verdicts"]
        assert v["scheduled"] == (faster == "sched")
        assert v["sched_s"] > 0 and v["dense_s"] > 0


def test_chooser_background_matches_reference(monkeypatch):
    monkeypatch.setenv(_ENV, "auto")
    coef = _coef("10.4")
    for ch in _choosers():
        gate = threading.Event()

        def run_sched(gate=gate):
            gate.wait(10)

        def run_dense():
            time.sleep(0.003)

        n = schedule.MIN_SCHED_BYTES
        assert ch.use_scheduled(coef, n, run_sched, run_dense,
                                background=True) is False
        assert ch.snapshot()["measuring"] == 1
        gate.set()
        deadline = time.monotonic() + 10
        while ch.snapshot()["measuring"] and time.monotonic() < deadline:
            time.sleep(0.005)
        assert ch.snapshot()["measuring"] == 0
        assert ch.use_scheduled(coef, n, run_sched, run_dense,
                                background=True) is True


def test_chooser_failure_raises_where_the_reference_swallows(monkeypatch):
    monkeypatch.setenv(_ENV, "auto")
    coef = _coef("10.4")
    n = schedule.MIN_SCHED_BYTES

    def broken():
        raise RuntimeError("scheduled program failed")

    port, ref = _choosers()
    assert ref.use_scheduled(coef, n, broken, lambda: None) is False
    with pytest.raises(RuntimeError, match="scheduled program failed"):
        port.use_scheduled(coef, n, broken, lambda: None)
    assert port.snapshot()["failed"] == 1
    with pytest.raises(RuntimeError, match="scheduled program failed"):
        port.use_scheduled(coef, n, lambda: None, lambda: None)


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_scheduled_program_error_propagates_out_of_coded_matmul(
        monkeypatch, mode):
    monkeypatch.setenv(_ENV, mode)
    monkeypatch.setattr(threading, "excepthook", lambda args: None)

    def broken(program, shards):
        raise RuntimeError("xor program failed")

    monkeypatch.setattr(codec_torch, "xor_matmul", broken)
    codec = codec_torch.TorchCodec(device="cpu")
    coef = _coef("10.4")
    x = np.random.default_rng(2).integers(
        0, 256, (10, schedule.MIN_SCHED_BYTES // 10 + 3), dtype=np.uint8)
    if mode == "on":
        with pytest.raises(RuntimeError, match="xor program failed"):
            codec.coded_matmul(coef, x)
        return
    # auto: the first call serves the dense product while the background
    # measurement runs the broken program; the next call raises its error
    assert np.array_equal(codec.coded_matmul(coef, x),
                          codec_numpy.coded_matmul(coef, x))
    deadline = time.monotonic() + 30
    while codec._chooser.snapshot()["measuring"] and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="xor program failed"):
        codec.coded_matmul(coef, x)


@pytest.mark.parametrize("name", ["10.4", "lrc-10.2.2/rec3"])
def test_torch_codec_scheduled_path_matches(monkeypatch, name):
    """Schedule pinned on: TorchCodec's coded_matmul and stream run the
    XOR program (slab-split, uneven widths) and give the dense bytes."""
    monkeypatch.setenv(_ENV, "on")
    coef = _coef(name)
    k = coef.shape[1]
    codec = codec_torch.TorchCodec(slab=700, device="cpu")
    rng = np.random.default_rng(k)
    x = rng.integers(0, 256, (k, 1999), dtype=np.uint8)
    want = codec_numpy.coded_matmul(coef, x)
    assert np.array_equal(codec.coded_matmul(coef, x), want)
    blocks = [x[:, :1000], x[:, 1000:1000], x[:, 1000:]]
    got = list(codec.coded_matmul_stream(coef, iter(blocks), depth=2))
    assert np.array_equal(np.concatenate(got, axis=1), want)
