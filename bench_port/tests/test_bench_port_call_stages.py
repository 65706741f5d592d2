"""The readers of the one-shot codec call's stages (h2d_s_per_GB,
d2h_s_per_GB, compare_s_per_GB) on seeded counters: each stage's mean
seconds per call, times the window's passes, over the window's GB; None
while the stage was never recorded."""
import time

import pytest

from bench_port.spec import load_reader

READERS = {"h2d_s_per_GB.scrub": "h2d", "d2h_s_per_GB.scrub": "d2h",
           "compare_s_per_GB.scrub": "compare"}


@pytest.fixture
def registry():
    """The program's metrics registry, emptied for the test and given
    back as it was."""
    from seaweedfs_tpu_torch.utils import metrics

    saved = (dict(metrics._counters), dict(metrics._gauges),
             {k: list(v) for k, v in metrics._histograms.items()})
    metrics.reset()
    yield metrics
    metrics.reset()
    metrics._counters.update(saved[0])
    metrics._gauges.update(saved[1])
    metrics._histograms.update(saved[2])


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_is_none_until_its_stage_is_recorded(registry, metric):
    read = load_reader(metric)
    rec = {"attempted": 24, "bytes": 24 * 1.5e9}
    assert read(rec) is None
    # another stage or another backend is not this one
    for stage in READERS.values():
        if stage != READERS[metric]:
            registry.histogram_observe("ec_codec_call_stage_seconds", 0.3,
                                       {"stage": stage, "backend": "cuda"})
    registry.histogram_observe("ec_codec_call_stage_seconds", 0.3,
                               {"stage": READERS[metric], "backend": "torch"})
    registry.histogram_observe("ec_codec_stage_seconds", 0.3,
                               {"stage": READERS[metric], "backend": "cuda"})
    assert read(rec) is None


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_is_the_mean_per_pass_over_the_window_bytes(registry, metric):
    read = load_reader(metric)
    labels = {"stage": READERS[metric], "backend": "cuda"}
    # the set-up's warm pass and three window passes: 0.1 + 3 x 0.2 s
    for seconds in (0.1, 0.2, 0.2, 0.2):
        registry.histogram_observe("ec_codec_call_stage_seconds", seconds,
                                   labels)
    rec = {"attempted": 3, "bytes": 3 * 1.5e9}
    # mean 0.175 s a call, 3 calls, over 4.5 GB
    assert read(rec) == pytest.approx(0.175 * 3 / 4.5)
    assert read(dict(rec, bytes=0)) is None
    # twice the passes over twice the bytes: the same seconds per GB
    assert read({"attempted": 6, "bytes": 6 * 1.5e9}) == \
        pytest.approx(read(rec))


def test_readers_of_a_cpu_run(registry):
    """A whole small run of each cell on the CPU (CudaCodec on the CPU,
    labelled `cuda`) records every stage, and each reader reads it."""
    from bench_port import harness
    from bench_port.tests.conftest import CELLS, small_spec

    for cell in CELLS:
        registry.reset()
        result, _ = harness.run(cell, 2**33 + 7, 0.2, False,
                                t_start=time.perf_counter(), device="cpu",
                                spec=small_spec(cell), log=lambda line: None)
        assert result["correct"] is True
        rec = {"attempted": result["attempted"], "bytes": 1e9}
        for metric, stage in READERS.items():
            n = registry.counter_value("ec_codec_call_stage_seconds_count",
                                       {"stage": stage, "backend": "cuda"})
            # the warm-up pass and every window pass: one call each
            assert n == result["attempted"] + 1, (cell, stage)
            assert load_reader(metric)(rec) > 0
