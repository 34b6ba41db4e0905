"""The cells at sizes a CPU test run holds: the same files, with fewer
poses and closures, and the streaming cell's capacities cut to match;
and a batch-solve cell of the test's own (cells/), which BENCHMARK.json
does not list, run by as many ranks as a test asks for."""

from __future__ import annotations

import os

import benchmark.run as R

SIZES = {"m3500-perstep": (200, 110), "city10k-stream": (300, 300)}


def small_spec(cell: str) -> dict:
    spec = R.cell_spec(cell)
    poses, closures = SIZES[cell]
    spec["config"]["graph"].update(poses=poses, closures=closures)
    if spec["config"]["solver"].get("superstep_size", 1) > 1:
        spec["config"]["solver"].update(node_capacity=128,
                                        factor_capacity=256,
                                        panel_nodes=32)
        spec["workload"]["warmup_poses"] = 70
    return spec


CELLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cells")


def batch_spec(chips: int = 1, workload: str = "batch-small") -> dict:
    """The test's batch-solve cell (cells/batch-small.json and its
    configuration) on `chips` ranks, with BENCHMARK.json's end-to-end
    metrics of every cell."""
    wl = R.load_json(CELLS, workload + ".json")
    bench = R.load_json(R.ROOT, "BENCHMARK.json")
    return {"cell": {"name": workload, "config": wl["config"],
                     "traffic": wl["traffic"], "chips": chips},
            "end_to_end": [m for m in bench["end_to_end"]
                           if "workloads" not in m],
            "per_layer": [],
            "config": R.load_json(CELLS, wl["config"] + ".json"),
            "workload": wl}


class Args:
    """The run's command line, as run_cell reads it."""

    def __init__(self, seed: int, seconds: float = 0.0, trace: int = 0):
        self.seed, self.seconds, self.trace = seed, seconds, trace
