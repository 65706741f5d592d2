"""BENCHMARK.json against the rules its harness relies on, and the lookup
of configurations, traffic mixes and metric readers by name."""
import json
import os
import re
import shutil

import pytest

from bench_port import spec as specmod

ROOT = specmod.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_names_units_and_references():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for entry in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert set(c["reduced"]) <= set(conf) and conf["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        spec = specmod.Spec(w["name"])
        names = [m["name"] for m in spec.metrics(False)]
        assert "setup_s" in names and len(names) >= 2
        per_layer = spec.metrics(True)
        assert per_layer
        for m in per_layer:
            assert callable(spec.reader(m["name"]))
        assert spec.traffic["rate_metric"] in names


def test_bounds_are_within_the_rules():
    for m in _bench()["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_new_config_traffic_and_metric_files_are_found_by_name(tmp_path):
    bench_dir = tmp_path / "bench_port"
    shutil.copytree(specmod.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    (bench_dir / "configs" / "rs6_3_1g.json").write_text(json.dumps(
        {"name": "rs6_3_1g", "code_kind": "rs", "data_shards": 6,
         "parity_shards": 3}))
    (bench_dir / "traffic" / "scrub_three.json").write_text(json.dumps(
        {"driver": "scrub", "corrupt_every": 3}))
    (bench_dir / "metrics" / "writer_wait_s.py").write_text(
        "def read(record):\n    return 42.0\n")
    b["configs"].append({"name": "rs6_3_1g", "source": "https://example.org",
                         "file": "bench_port/configs/rs6_3_1g.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "rs6_3.scrub_three", "config": "rs6_3_1g",
                           "traffic": "scrub_three", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "writer_wait_s.encode", "unit": "s",
                           "better": "lower", "source": "program_span",
                           "layer": "encoder", "moves": "encode_GBps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec = specmod.Spec("rs6_3.scrub_three", root=str(tmp_path),
                        bench_dir=str(bench_dir))
    assert spec.config["data_shards"] == 6
    assert spec.traffic == {"driver": "scrub", "corrupt_every": 3}
    assert spec.reader("writer_wait_s.encode")({}) == 42.0
    # without `workloads`, a metric belongs to every cell
    assert "writer_wait_s.encode" in [m["name"] for m in spec.metrics(True)]
    assert spec.reader("fetch_s_per_GB.rs6_3") is not None
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")
    with pytest.raises(KeyError):
        specmod.Spec("no.such.cell", root=str(tmp_path),
                     bench_dir=str(bench_dir))
