"""The readings that the check's limits are set from, at a cell's own
size: the program as the configuration states it, the control (the
program in the precision below the configuration's: --dtype float32) and
the planted faults (--fault, faults.py), each on every seed given, in one
process (on each rank of a cell of several, as a run has them).

    python3 -m benchmark.control --workload CELL --seeds 11 12 13
        [--dtype float32] [--fault unchanged|altered|half_edges|
         early_stop|lost_rank] [--passes 2]

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

from . import run as R
from .check import judge
from .faults import FAULTS


def readings(spec: dict, seed: int, device: str, dtype: str = None,
             fault: str = None, passes: int = 1) -> dict:
    """One seed's passes of the cell, judged: the numbers compared."""
    return read_seeds(spec, [seed], device, dtype, fault, passes)[0]


def read_seeds(spec: dict, seeds: list, device: str, dtype: str = None,
               fault: str = None, passes: int = 1, world=None) -> list:
    """Each seed's passes of the cell, judged, in one world of the cell's
    ranks (ranks.py; rank 0, where `world` is None, launches it).  Returns
    each seed's verdict with its seconds on rank 0, None on the others."""
    from . import ranks

    wl = spec["workload"]
    drivers = R.load_file("drivers", wl["driver"])
    if world is None:
        world = ranks.World.launch(
            spec["cell"]["chips"], device, getattr(drivers, "GROUP", False),
            read_seeds,
            {"spec": spec, "seeds": list(seeds), "device": device,
             "dtype": dtype, "fault": fault, "passes": passes},
            wl.get("collective_timeout_s"))
    try:
        with FAULTS[fault]() if fault else contextlib.nullcontext():
            world.join()
            out = [_seed(spec, seed, drivers, world, dtype, passes)
                   for seed in seeds]
        world.close()
    except BaseException:
        world.abort()
        raise
    return None if world.rank else out


def _seed(spec: dict, seed: int, drivers, world, dtype, passes) -> dict:
    t = time.perf_counter()
    config, wl = spec["config"], spec["workload"]
    graphs = [R.pass_graph(config, seed, j, wl.get("noise_pool"))
              for j in range(passes)]
    steps = R.checked_steps(seed, len(graphs[0]["truth"]),
                            wl["check"]["steps_per_pass"])
    answers = []
    driver = drivers.Driver(config, wl, world.device, graphs[0], dtype=dtype)
    for j, graph in enumerate(graphs):
        rep = driver.build(graph)
        world.barrier()
        for a in driver.run_pass(rep, steps)["answers"]:
            if "digest" in a:
                a["digests"] = world.gather(a.pop("digest"))
            answers.append(dict(a, graph=j))
        del rep
        drivers.collect(driver.device)
    del driver
    drivers.collect(world.device)
    if world.rank:
        return None
    v = judge(graphs, config["prior"], answers, wl["check"]["limits"],
              world.device, wl["check"].get("reference", "posegraph"))
    v["seconds"] = time.perf_counter() - t
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--passes", type=int, default=1)
    args = ap.parse_args(argv)
    spec = R.cell_spec(args.workload)
    got = read_seeds(spec, args.seeds, "cuda", args.dtype, args.fault,
                     args.passes)
    for seed, v in zip(args.seeds, got):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype or "as configured",
                          "fault": args.fault, "correct": v["correct"],
                          "numbers": {k: n["value"] for k, n in
                                      v["numbers"].items()},
                          "seconds": v["seconds"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
