"""The yardstick's arithmetic: the roofline's byte count and peaks, the
trace reduction and the readers."""

import pytest

from bench_port import devtrace, roofline
from bench_port.reference import encode
from bench_port.spec import load_reader

H100 = "NVIDIA H100 80GB HBM3"


def test_product_bytes_count_each_input_and_output_byte_once():
    assert roofline.product_bytes(10, 4, 1 << 25) == 14 << 25
    assert roofline.product_bytes(12, 4, 7) == 112
    assert roofline.least_seconds(3_350_000_000, H100) == pytest.approx(1e-3)
    assert roofline.least_seconds(1, "some other card") is None


def test_a_seal_counts_rows_times_blocks_columns():
    # 1 GiB at RS(10,4): 103 rows of 1 MiB blocks -> 103 MiB per shard
    n = encode.shard_bytes(1 << 30, 1 << 30, 1 << 20, 10)
    assert n == 103 << 20
    assert roofline.product_bytes(10, 4, n) == 14 * (103 << 20)
    assert encode.shard_bytes(1 << 30, 1 << 30, 1 << 20, 12) == 86 << 20


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction_busy_idle_kernels_and_gaps():
    trace = {"traceEvents": [
        _ev(devtrace.WINDOW_NAME, "user_annotation", 1000, 1000),
        _ev("coded_matmul_kernel", "kernel", 1100, 100),
        _ev("Memcpy HtoD", "gpu_memcpy", 1150, 100),     # overlaps the kernel
        _ev("coded_matmul_kernel", "kernel", 1600, 50),
        _ev("Memcpy DtoH", "gpu_memcpy", 1950, 200),     # runs past the window
        _ev("before", "kernel", 500, 100),               # outside the window
        _ev("CatArrayBatchedCopy", "kernel", 1700, 40),  # not the product
        _ev("cudaMalloc", "cuda_runtime", 1300, 250),
        _ev("aten::empty", "cpu_op", 1260, 20),
        _ev("cudaEventSynchronize", "cuda_runtime", 1650, 300),  # a wait
    ]}
    r = devtrace.reduce_trace(trace, ("coded_matmul_kernel",))
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx((150 + 50 + 40 + 50) * 1e-6)
    assert r["kernel_s"] == pytest.approx(150e-6)
    assert r["other_kernel_s"] == pytest.approx(40e-6)
    assert devtrace.reduce_trace(trace)["kernel_s"] == 0
    assert r["device_ops"][0] == ["coded_matmul_kernel", pytest.approx(150e-6)]
    assert ["before", 0.0] in r["device_ops"]
    gaps = r["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([350e-6, 210e-6, 100e-6,
                                                  50e-6])
    assert gaps[0][0] == "host: cudaMalloc"       # 1250..1600 vs 1300..1550
    assert gaps[1][0] == devtrace.UNNAMED          # only a wait covers it
    assert gaps[2][0] == devtrace.UNNAMED          # nothing covers half
    assert r["host_calls"] == [("cudaEventSynchronize", pytest.approx(300e-6)),
                               ("cudaMalloc", pytest.approx(250e-6))]
    assert devtrace.reduce_trace({"traceEvents": []}) == {}


def test_readers_read_the_record_and_leave_out_what_is_missing():
    rec = {"bytes": 2e9, "fetch_s": 0.8, "codec_s": 0.4,
           "product_bytes": 3_350_000_000, "device_kind": H100,
           "trace": {"kernel_s": 2e-3, "busy_s": 0.5, "window_s": 20.0}}
    assert load_reader("fetch_s_per_GB.scrub")(rec) == pytest.approx(0.4)
    assert load_reader("codec_s_per_GB.scrub")(rec) == pytest.approx(0.2)
    assert load_reader("coded_matmul_roofline.scrub")(rec) == \
        pytest.approx(50.0)
    assert load_reader("device_idle_pct.scrub")(rec) == pytest.approx(97.5)
    empty = {"bytes": 0, "product_bytes": 1, "device_kind": "cpu",
             "trace": {}}
    for name in ("coded_matmul_roofline", "device_idle_pct", "fetch_s_per_GB",
                 "codec_s_per_GB"):
        assert load_reader(name)(empty) is None
