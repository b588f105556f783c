"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name; a new cell is files and entries only."""

import json
import re
import shutil

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]] + CELLS
                         + [m["name"] for m in METRICS]
                         + [w["traffic"] for w in BENCH["workloads"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(cell in m["workloads"] for m in BENCH["per_layer"]), cell
        moved = {m["moves"] for m in BENCH["per_layer"] if cell in m["workloads"]}
        assert moved <= set(e2e), cell


def test_unique_names_and_pairs():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    run = harness.make_run(BENCH, cell, 1, 1.0, False, 0.0)
    assert run.config["reduced"] == []
    assert harness.traffic_module(run).run
    assert run.cell["limits"] and run.cell["trace_units"] > 0
    for m in run.per_layer:
        assert callable(harness.load_module(harness.reader_path(run.bench_dir, m["name"])).read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    assert config["file"].startswith("portbench/configs/")
    with open(harness.ROOT / config["file"]) as f:
        d = json.load(f)
    assert d["reduced"] == config["reduced"] == []
    assert d["model"]["backbone_type"] in ("SparseUNet", "PointNet")
    assert d["model"]["conv_compute_dtype"] == "float32"


def test_a_new_cell_is_found_from_new_files(tmp_path):
    """A copy of the benchmark with a dummy traffic, cell and metric added
    as files and entries only."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "pointnet-fp32.dummy", "config": "gapartnet-pointnet-fp32",
                               "traffic": "dummy", "chips": 1, "why": "a test"})
    for name in ("dummy_ms", "dummy_ms.shared", "dummy_ms.own"):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": "device_trace", "layer": "test", "moves": "setup_s",
                                   "workloads": ["pointnet-fp32.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "traffic" / "dummy.json").write_text('{"kind": "dummy_kind"}')
    (tmp_path / "portbench" / "traffic" / "dummy_kind.py").write_text(
        "def run(run):\n    return 'dummy ran'\n")
    (tmp_path / "portbench" / "cells" / "pointnet-fp32.dummy.json").write_text(
        '{"limits": {}, "trace_units": 1}')
    (tmp_path / "portbench" / "metrics" / "dummy_ms.py").write_text(
        "def read(trace):\n    return 1.5\n")
    (tmp_path / "portbench" / "metrics" / "dummy_ms.own.py").write_text(
        "def read(trace):\n    return 2.5\n")
    run = harness.make_run(bench, "pointnet-fp32.dummy", 3, 1.0, True, 0.0, root=tmp_path)
    assert harness.traffic_module(run).run(run) == "dummy ran"
    assert [m["name"] for m in run.per_layer] == ["dummy_ms", "dummy_ms.shared", "dummy_ms.own"]
    assert harness.read_per_layer(run, None) == {"dummy_ms": {"value": 1.5, "unit": "ms"},
                                                 "dummy_ms.shared": {"value": 1.5, "unit": "ms"},
                                                 "dummy_ms.own": {"value": 2.5, "unit": "ms"}}
    assert run.config["model"]["backbone_type"] == "PointNet"


def test_run_without_a_card_prints_no_result():
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
