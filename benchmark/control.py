"""The readings that the check's limits are set from, at a cell's own
size: the program as the configuration states it, the control (the
program in the precision below the configuration's: --dtype float32) and
the planted faults (--fault, faults.py), each on every seed given, in one
process.

    python3 -m benchmark.control --workload CELL --seeds 11 12 13
        [--dtype float32] [--fault unchanged|altered|half_edges]
        [--passes 2]

Each seed's passes are run and judged as a run's are (its checked steps
drawn from the seed, every pass's end); one JSON line per seed gives the
numbers compared.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import run as R
from .check import judge
from .faults import FAULTS


def readings(spec: dict, seed: int, device: str, dtype: str = None,
             fault: str = None, passes: int = 1) -> dict:
    """One seed's passes of the cell, judged: the numbers compared."""
    config, wl = spec["config"], spec["workload"]
    drivers = R.load_file("drivers", wl["driver"])
    graphs = [R.pass_graph(config, seed, j, wl.get("noise_pool"))
              for j in range(passes)]
    steps = R.checked_steps(seed, len(graphs[0]["truth"]),
                            wl["check"]["steps_per_pass"])
    answers = []
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        driver = drivers.Driver(config, wl, device, graphs[0], dtype=dtype)
        for j, graph in enumerate(graphs):
            rep = driver.build(graph)
            answers += [dict(a, graph=j) for a in
                        driver.run_pass(rep, steps)["answers"]]
            del rep
            drivers.collect(driver.device)
    del driver
    drivers.collect(torch.device(device))
    return judge(graphs, config["prior"], answers, wl["check"]["limits"],
                 device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--passes", type=int, default=1)
    args = ap.parse_args(argv)
    spec = R.cell_spec(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        v = readings(spec, seed, "cuda", args.dtype, args.fault,
                     args.passes)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype or "as configured",
                          "fault": args.fault, "correct": v["correct"],
                          "numbers": {k: n["value"] for k, n in
                                      v["numbers"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
