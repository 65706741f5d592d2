"""Whole runs of every cell on the CPU at a size a test run holds: a sound
run is correct; the control and each fault the cell can have, planted
under the timed path, come out not correct."""
import numpy as np
import pytest
import torch

from bench_port.tests.conftest import CELLS, run_small


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    from bench_port.spec import Spec

    res = run_small(cell)
    assert res["correct"] is True, res
    assert res["attempted"] > 0 and res["failed"] == 0
    spec = Spec(cell)
    assert set(res["metrics"]) == {m["name"] for m in spec.metrics(False)}
    assert len(res["metrics"]) == 2
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = run_small(cell, control=True)
    assert res["correct"] is False, res
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _patch_kernel(monkeypatch, fault):
    """Plant `fault` in the CUDA codec's kernel (run here as its plain
    version): 'half' leaves the second half of the columns out, 'altered'
    flips one byte of what it produces."""
    from seaweedfs_tpu_torch.ops import codec_cuda

    real = codec_cuda.CudaCodec._kernel

    def kernel(self, mats, x, out=None):
        res = real(self, mats, x, out)
        if fault == "half":
            res[:, res.shape[1] // 2:] = 0
        else:
            res[0, 0] ^= 1
        return res

    monkeypatch.setattr(codec_cuda.CudaCodec, "_kernel", kernel)


def _patch_verify(monkeypatch, fault):
    """Plant `fault` in the scrub's verify only, so the set-up seal stays
    sound."""
    from seaweedfs_tpu_torch.ec.backend import ReedSolomon

    real = ReedSolomon.verify

    def verify(self, shards):
        if fault == "unchanged":   # every pass reports the clean verdict
            return True
        if fault == "altered":
            return not real(self, shards)
        with pytest.MonkeyPatch.context() as mp:
            _patch_kernel(mp, "half")
            return real(self, shards)

    monkeypatch.setattr(ReedSolomon, "verify", verify)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    _patch_verify(monkeypatch, fault)
    res = run_small(cell)
    assert res["correct"] is False, (cell, fault, res)


@pytest.mark.parametrize("cell", CELLS)
def test_a_pass_gone_wrong_late_in_the_window_is_not_correct(cell,
                                                             monkeypatch):
    """Only the passes after the window's fifth come out wrong: every
    pass's verdict is compared, the late ones too."""
    from seaweedfs_tpu_torch.ec.backend import ReedSolomon

    real = ReedSolomon.verify
    calls = []

    def verify(self, shards):
        calls.append(1)
        ok = real(self, shards)
        return ok if len(calls) <= 6 else not ok   # the warm-up and five

    monkeypatch.setattr(ReedSolomon, "verify", verify)
    res = run_small(cell, seconds=1.0)
    assert res["attempted"] > 8, res
    assert res["correct"] is False, res
    assert res["checks"]["verdicts_differing"]["value"] == \
        res["attempted"] - 5


def test_seeded_inputs_repeat_and_differ():
    from bench_port.drivers import seeded_bytes, sub_seed

    a = seeded_bytes(4096, sub_seed(2**31 + 5, 1, 0), torch.device("cpu"))
    b = seeded_bytes(4096, sub_seed(2**31 + 5, 1, 0), torch.device("cpu"))
    c = seeded_bytes(4096, sub_seed(2**31 + 5, 1, 1), torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert sub_seed(2**40, 1) != sub_seed(2**40 + 1, 1)
    assert 0 <= sub_seed(-3, 2) < 2**63
    assert np.unique(a.numpy()).size > 200
