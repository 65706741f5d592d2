"""The port's one-shot codec call and `verify` timed stage by stage, its
spans on the torch profiler's clock, `ec.verify`'s span tree, and kernel
builds made visible.

* `TorchCodec.coded_matmul` (and `CudaCodec`, which inherits it; both
  on the CPU here) records one h2d, kernel and d2h observation per call
  into ec_codec_call_stage_seconds{stage,backend} and leaves the feed's
  ec_codec_stage_seconds as it was.
* `ReedSolomon.verify` records one `compare` per call and returns the
  JAX package's verdicts on clean and flipped stacks.
* While a torch profiler records, `tracing.span` and the codec's stage
  annotations are `user_annotation` events of its trace; while none
  records, `record_function` is never called.
* `ec_verify` runs under an `ec.verify` span whose children are the
  shard GETs and `ec.verify.stack`.
* `_build.build_all` counts and times a build that runs nvcc (stubbed
  here), and records nothing when the library is there.
"""
import json
import os
import secrets
import stat

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from seaweedfs_tpu.ec.backend import ReedSolomon as RefReedSolomon
from seaweedfs_tpu_torch.ec.backend import ReedSolomon
from seaweedfs_tpu_torch.ops import _build
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.ops.codec_torch import TorchCodec
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell import commands_ec
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.utils import metrics, tracing

from tests.test_torch_scrub import fill_volume

STAGES = ("h2d", "kernel", "d2h")
FEED_STAGES = ("pread", "pin", "h2d", "kernel", "d2h", "relay")


def _calls(stage, backend):
    return metrics.counter_value("ec_codec_call_stage_seconds_count",
                                 {"stage": stage, "backend": backend})


def _feed(backend):
    return {s: (metrics.counter_value("ec_codec_stage_seconds_count",
                                      {"stage": s, "backend": backend}),
                metrics.counter_value("ec_codec_stage_seconds_sum",
                                      {"stage": s, "backend": backend}))
            for s in FEED_STAGES}


def _stack(k=10, m=4, n=3000, seed=5):
    data = np.random.default_rng(seed).integers(0, 256, (k, n),
                                                dtype=np.uint8)
    parity = RefReedSolomon(k, m, backend="numpy").encode(data)
    return np.concatenate([data, parity])


@pytest.mark.parametrize("cls", [CudaCodec, TorchCodec],
                         ids=["cuda", "torch"])
@pytest.mark.parametrize("slab", [1 << 20, 1000], ids=["one-slab", "slabs"])
def test_one_shot_call_records_each_stage_once(cls, slab):
    codec = cls(slab=slab, device="cpu")
    full = _stack()
    rs = RefReedSolomon(10, 4, backend="numpy")
    before = {s: _calls(s, codec.name) for s in STAGES}
    feed = _feed(codec.name)
    sums = {s: metrics.counter_value("ec_codec_call_stage_seconds_sum",
                                     {"stage": s, "backend": codec.name})
            for s in STAGES}
    out = codec.coded_matmul(rs._parity_rows, full[:10])
    assert np.array_equal(out, full[10:])
    for s in STAGES:
        assert _calls(s, codec.name) == before[s] + 1, s
        assert metrics.counter_value(
            "ec_codec_call_stage_seconds_sum",
            {"stage": s, "backend": codec.name}) >= sums[s]
    assert _feed(codec.name) == feed
    # an empty call moves nothing to the device and records nothing
    codec.coded_matmul(rs._parity_rows, full[:10, :0])
    assert all(_calls(s, codec.name) == before[s] + 1 for s in STAGES)


@pytest.mark.parametrize("flip", [None, (0, 17), (12, 2999)],
                         ids=["clean", "data-row", "parity-row"])
def test_verify_records_one_compare_and_keeps_its_verdict(flip):
    full = _stack()
    if flip is not None:
        full[flip] ^= 0x5A
    rs = ReedSolomon(10, 4, backend=CudaCodec(device="cpu"))
    compares = _calls("compare", "cuda")
    kernels = _calls("kernel", "cuda")
    got = rs.verify(full)
    assert got is (flip is None)
    assert got == RefReedSolomon(10, 4, backend="numpy").verify(full)
    assert _calls("compare", "cuda") == compares + 1
    assert _calls("kernel", "cuda") == kernels + 1
    with pytest.raises(ValueError):
        rs.verify(full[:13])
    assert _calls("compare", "cuda") == compares + 1


def test_profiler_trace_holds_the_stages_and_spans(tmp_path):
    rs = ReedSolomon(10, 4, backend=CudaCodec(device="cpu"))
    full = _stack()
    name = "test.span." + secrets.token_hex(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span(name):
            assert rs.verify(full) is True
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    for want in ("ec.verify.compare", "ec.codec.h2d", "ec.codec.kernel",
                 "ec.codec.d2h", name):
        assert want in spans, want
    outer = spans[name]
    for inner in ("ec.codec.h2d", "ec.verify.compare"):
        e = spans[inner]
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    assert spans["ec.codec.d2h"]["ts"] <= spans["ec.verify.compare"]["ts"]
    # the span's ring record keeps its fields
    rec = next(s for t in tracing.traces_json(50) for s in t["spans"]
               if s["name"] == name)
    assert set(rec) == {"trace_id", "span_id", "parent_id", "service",
                        "name", "kind", "peer", "start", "duration",
                        "status"}


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    rs = ReedSolomon(10, 4, backend=CudaCodec(device="cpu"))
    with tracing.span("test.quiet"):
        with tracing.annotate("test.quiet.step"):
            assert rs.verify(_stack()) is True
    with pytest.raises(KeyError):
        with tracing.span("test.quiet.error"):
            raise KeyError("x")
    # the same calls under a profiler reach record_function
    with pytest.raises(AssertionError, match="record_function called"):
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.annotate("test.loud"):
                pass


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = Cluster(str(tmp_path_factory.mktemp("verify-spans")),
                n_volume_servers=3, volume_size_limit=4 << 20,
                max_volumes=40, ec_backend=CudaCodec(device="cpu"))
    yield c
    c.stop()


def test_ec_verify_span_tree(cluster):
    env = CommandEnv(cluster.master_url)
    env.acquire_lock()
    vid = fill_volume(cluster, "vs" + secrets.token_hex(3), n=12, size=8192)
    commands_ec.ec_encode(env, vid)
    out = commands_ec.ec_verify(env, vid, sample_mb=0)
    assert out["verified"] is True
    traces = tracing.traces_json(200)
    root = next(s for t in traces for s in t["spans"]
                if s["name"] == "ec.verify" and not s["parent_id"]
                and s["peer"] == "numpy")
    tree = next(t["spans"] for t in traces
                if t["trace_id"] == root["trace_id"])
    children = [s for s in tree if s["parent_id"] == root["span_id"]]
    gets = {s["span_id"]: s for s in children
            if s["kind"] == "client" and s["name"].startswith("GET ")}
    # each holder's server span joins the trace under the GET that asked
    reads = [s for s in tree if s["kind"] == "server"
             and s["name"] == "handle_ec_shard_read"]
    assert len(reads) == 14
    assert all(s["parent_id"] in gets and gets[s["parent_id"]]["status"]
               == "200" for s in reads)
    stack = [s for s in children if s["name"] == "ec.verify.stack"]
    assert len(stack) == 1 and stack[0]["kind"] == "internal"
    assert root["kind"] == "internal" and root["duration"] >= sum(
        s["duration"] for s in children)


def _stub_nvcc(tmp_path, rc=0):
    """An nvcc that writes an empty library at its `-o` path and exits
    with `rc`."""
    path = tmp_path / "nvcc"
    path.write_text('#!/bin/sh\nwhile [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi\n'
                    '  shift\ndone\necho "ptxas info: stub"\n'
                    f'exit {rc}\n')
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def _stub_build(monkeypatch, tmp_path, name, rc=0):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / f"{name}.cu").write_text("// a stub kernel source\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: _stub_nvcc(tmp_path, rc))


def _build_spans(name):
    return [s for t in tracing.traces_json(200) for s in t["spans"]
            if s["name"] == "cuda.kernel_build" and s["peer"] == name]


def test_kernel_build_counted_once(monkeypatch, tmp_path):
    _stub_build(monkeypatch, tmp_path, "stubk")
    lab = {"kernel": "stubk"}

    def count():
        return metrics.counter_value("cuda_kernel_build_seconds_count", lab)

    before, spans = count(), len(_build_spans("stubk"))
    paths = _build.build_all(["stubk"])
    assert os.path.exists(paths["stubk"])
    assert _build.build_logs["stubk"].startswith("ptxas info: stub")
    assert count() == before + 1
    assert len(_build_spans("stubk")) == spans + 1
    assert metrics.counter_value("cuda_kernel_build_seconds_sum", lab) > 0
    # the library is there: loaded as it is, nothing recorded
    assert _build.build_all(["stubk"]) == paths
    assert count() == before + 1
    assert len(_build_spans("stubk")) == spans + 1
    text = metrics.render()
    assert "# TYPE cuda_kernel_build_seconds histogram" in text
    assert "cuda_kernel_builds_total" not in text


def test_failed_kernel_build_records_no_build(monkeypatch, tmp_path):
    _stub_build(monkeypatch, tmp_path, "stubfail", rc=2)
    lab = {"kernel": "stubfail"}
    before = metrics.counter_value("cuda_kernel_build_seconds_count", lab)
    spans = len(_build_spans("stubfail"))
    with pytest.raises(RuntimeError, match="nvcc exit 2"):
        _build.build_all(["stubfail"])
    assert not os.path.exists(_build.library_path("stubfail"))
    assert metrics.counter_value("cuda_kernel_build_seconds_count",
                                 lab) == before
    # the attempt still shows as a span
    assert len(_build_spans("stubfail")) == spans + 1
