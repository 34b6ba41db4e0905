"""The cells at sizes a CPU test run holds: the same files, with fewer
poses and closures, and the streaming cell's capacities cut to match."""

from __future__ import annotations

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


class Args:
    """The run's command line, as run_cell reads it."""

    def __init__(self, seed: int, seconds: float = 0.0, trace: int = 0):
        self.seed, self.seconds, self.trace = seed, seconds, trace
