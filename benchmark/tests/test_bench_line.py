"""The result's line and the command line without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import benchmark.run as R


def run_record():
    return {"passes": [{"poses": 10, "seconds": 1.0,
                        "step_s": [0.1] * 10}],
            "setup_s": 3.0, "memory_peak_bytes": 5,
            "records": {"poses": 10, "pass_s": 1.0, "window_s": 1.0,
                        "busy_s": 0.5, "spans": {}, "counters": {},
                        "growths": [], "captures": 0, "capture_s": 0.0,
                        "k1_launches": [], "k1_device_s": 0.0,
                        "device_kind": "x", "device_ops": [["k", 0.5]],
                        "idle_gaps": [["planning", 0.5]]},
            "verdict": {"correct": True, "failed": 0,
                        "numbers": {"chi2_rel": {"value": 0.0,
                                                 "limit": 1.0}}}}


def test_line_keys():
    spec = R.cell_spec("m3500-perstep")
    line = R.result_line(spec, run_record(), False, "NVIDIA H100")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert set(line["metrics"]) == {"poses_per_s", "step_ms_p50",
                                    "setup_s"}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100",
                              "count": 1, "memory_peak_bytes": 5}
    traced = R.result_line(spec, run_record(), True, "NVIDIA H100")
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "check"]
    assert set(traced["device"]) >= {"busy_s", "window_s"}
    # per-layer metrics only, each a cell's; those with nothing to read
    # are left out
    names = {m["name"] for m in spec["per_layer"]}
    assert set(traced["metrics"]) <= names
    assert "idle_share" in traced["metrics"]
    json.dumps(traced)


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "m3500-perstep", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=R.ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ))
    assert out.returncode == 3
    assert "{" not in out.stdout
    assert "needs 1 CUDA card" in out.stderr
