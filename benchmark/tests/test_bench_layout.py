"""The harness finds every cell, configuration, driver and metric by its
name, a cell or metric added as files alone runs, and
BENCHMARK.json keeps to its contract's shape."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import benchmark.run as R

ROOT = R.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def bench():
    return R.load_json(ROOT, "BENCHMARK.json")


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        # read only in the cells it lists, each of which reports `moves`
        assert m["workloads"] and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  R.cell_spec(cell)["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", ["m3500-perstep", "city10k-stream"])
def test_cell_found_by_name(cell):
    spec = R.cell_spec(cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    R.load_file("drivers", spec["workload"]["driver"])
    R.load_file("gen", spec["config"]["graph"]["generator"])
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s",
                                                       "poses_per_s"}
    assert spec["per_layer"]
    for m in spec["end_to_end"]:
        assert callable(R.load_file("end_to_end", m["name"]).read)
    for m in spec["per_layer"]:
        assert callable(R.load_file("layer_metrics", m["name"]).read)
        # each per-layer metric moves an end-to-end metric of its cell
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_unknown_cell_refused():
    with pytest.raises(SystemExit):
        R.cell_spec("no-such-cell")


ADD = r'''
import json
import benchmark.run as R
from benchmark.tests.small import Args
spec = R.cell_spec("tiny-perstep")
run = R.run_cell(Args(5), spec, device="cpu")
rec = {"poses": 10, "spans": {}, "counters": {"batch": 2}}
print(json.dumps({"correct": run["verdict"]["correct"],
                  "driver": R.load_file("drivers", spec["workload"]["driver"])
                  .__file__,
                  "metrics": sorted(R.metrics_of(spec, run, False)),
                  "layer": R.load_file("layer_metrics", "poses_squared")
                  .read(rec)}))
'''


def test_cell_and_metric_added_as_files(tmp_path):
    """A copy of the benchmark with a new configuration, driver, cell and
    per-layer metric, each only added (and entered in
    BENCHMARK.json): the new cell runs through its driver (on the CPU, at
    a tiny size) and the metric is read."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cfg = R.load_json(ROOT, "benchmark/configs/m3500-f64.json")
    cfg["name"] = "tiny-f64"
    cfg["graph"].update(poses=80, closures=20, world=7)
    (tmp_path / "benchmark/configs/tiny-f64.json").write_text(
        json.dumps(cfg))
    shutil.copy(tmp_path / "benchmark/drivers/replay.py",
                tmp_path / "benchmark/drivers/replay_again.py")
    wl = R.load_json(ROOT, "benchmark/workloads/m3500-perstep.json")
    (tmp_path / "benchmark/workloads/tiny-perstep.json").write_text(
        json.dumps(dict(wl, config="tiny-f64", traffic="again",
                        driver="replay_again")))
    (tmp_path / "benchmark/layer_metrics/poses_squared.py").write_text(
        "def read(rec):\n    return rec['poses'] ** 2\n")
    b["configs"].append({"name": "tiny-f64", "source": "a test",
                         "file": "benchmark/configs/tiny-f64.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny-perstep", "config": "tiny-f64",
                           "traffic": "again", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if "m3500-perstep" in m.get("workloads", []):
            m["workloads"].append("tiny-perstep")
    b["per_layer"].append({"name": "poses_squared", "unit": "1",
                           "better": "lower", "source": "program_counter",
                           "layer": "test", "moves": "poses_per_s",
                           "workloads": ["tiny-perstep"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", ADD], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["driver"] == str(tmp_path / "benchmark/drivers/"
                                "replay_again.py")
    assert got["metrics"] == ["poses_per_s", "setup_s", "step_ms_p50"]
    assert got["layer"] == 100
