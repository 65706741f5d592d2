"""The command as the driver runs it. Without a card it must print no
result and exit with a code other than 0; on the card (`-m cuda`) one
short run of a cell prints a correct result."""
import json
import os
import subprocess
import sys

import pytest
import torch

from bench_port.spec import ROOT

RUN = [sys.executable, os.path.join("bench_port", "run.py")]


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(RUN + ["--workload", "lrc12_2_2.scrub",
                                "--seed", str(2**31 + 17), "--seconds", "3",
                                "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def test_the_card_test_is_marked_and_decides_inside(monkeypatch):
    marks = [m.name for m in test_a_short_run_on_the_card_is_correct.pytestmark]
    assert marks == ["cuda"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pytest.skip.Exception):
        test_a_short_run_on_the_card_is_correct()


def test_without_a_card_the_command_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path),
               HOME=str(tmp_path))
    out = subprocess.run(RUN + ["--workload", "lrc12_2_2.scrub",
                                "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr
