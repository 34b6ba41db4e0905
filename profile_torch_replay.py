"""Where the time of the port's main path goes, on one NVIDIA card.

    python3 profile_torch_replay.py

Replays manhattan_world(3500, seed=0) through aprilsam_tpu_torch's Replay on
the card in float64, twice, and prints JSON lines.

First the per-step replay (default SolverConfig, wall-clock gate off,
show_timing on: the port's spans recorded, utils/trace.py), the smoke
run's main path:
  * "paths": step count, mean and total host milliseconds of the fast, full
    and batch steps, outside the profiled window;
  * "stages_ms": host self milliseconds of each span (solver.plan = host
    planning, graphs.dispatch = a dispatch, solver.stats_wait = the wait
    for the step's stats, epoch.* = a batch epoch's phases, ...), summed
    outside the window;
  * "window": torch.profiler over steps [2000, 2300): wall seconds, device busy
    milliseconds (the sum of device-side self time, one stream), the idle
    share, device events per step, and the ten largest device operations.

Then the throughput replay in the bench's config (superstep_size=96 with
the bench's union buckets, policy_lag=3, policy_poll=2, log_chi2 off),
twice, one "superstep" line.  First with the profiler off, graphs off
(solver.graphs.enabled = False: every dispatch runs its body eagerly) and
the host clock around each stage ("timed": host milliseconds in the superstep dispatches,
and within them in plan_step (the union's planning), step_inputs (the
padding of the plan), _frontal_core (gather, measurement rows, QR,
writeback), torch.linalg.qr and _global_sweep; and in batch epochs).  Then
profiled whole, on CUDA graphs (the solver's default; each signature is
captured on its first dispatch): wall seconds and poses/s, device busy
milliseconds, the idle share, device events per superstep, and the ten
largest device operations.  The per-step replay runs on graphs too.
Needs a card; exits 1 without one.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
POSES = 3500
WINDOW = (2000, 2300)


def profile_superstep() -> None:
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.replay import Replay
    from aprilsam_tpu_torch.solver import SolverConfig
    from aprilsam_tpu_torch.solver import incremental
    from aprilsam_tpu_torch.utils.trace import device_rows, host_clock, top

    cfg = SolverConfig(wallclock_gate=False, dtype=np.float64,
                       superstep_size=96, policy_lag=3, policy_poll=2,
                       log_chi2=False,
                       superstep_buckets=(64, 128, 256, 384, 640, 1024))
    graph = manhattan_world(POSES, seed=0)

    def replay(graphs=True):
        rep = Replay(graph, cfg, deferred=True, device="cuda")
        rep.solver.graphs.enabled = graphs
        torch.cuda.synchronize()
        t = time.perf_counter()
        rep.run()
        torch.cuda.synchronize()
        return rep.solver, time.perf_counter() - t

    # 1. the host's split, profiler off: the stages of a superstep
    # dispatch on the host clock
    stages = [(incremental, "plan_step"), (incremental, "step_inputs"),
              (incremental, "_frontal_core"), (incremental, "_global_sweep"),
              (incremental.IncrementalSolver, "_dispatch_superstep"),
              (incremental.IncrementalSolver, "_run_batch"),
              (torch.linalg, "qr")]
    with host_clock(stages) as spent:
        solver, secs = replay(graphs=False)
    timed_line = {"seconds": secs, "poses_per_s": POSES / secs,
                  "host_ms": {k: ms for k, (ms, _n) in spent.items()}}

    # 2. the device, profiler on
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        solver, t_all = replay()
    dev = device_rows(prof)
    busy_ms = sum(us for _k, us, _c in dev) / 1e3
    n_sup = solver.counters["superstep"]
    print(json.dumps({"superstep": {
        "card": torch.cuda.get_device_name(0), "config": "bench",
        "timed": timed_line, "seconds": t_all,
        "poses_per_s": POSES / t_all, "final_chi2": solver.chi2(),
        "counters": solver.counters, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (t_all * 1e3),
        "device_events_per_superstep": sum(c for _k, _us, c in dev) / n_sup,
        "top": top(dev)}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_replay: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.replay import Replay
    from aprilsam_tpu_torch.solver import SolverConfig
    from aprilsam_tpu_torch.utils import trace
    from aprilsam_tpu_torch.utils.trace import device_rows, top

    lo, hi = WINDOW
    cfg = SolverConfig(wallclock_gate=False, show_timing=True,
                       dtype=np.float64)
    rep = Replay(manhattan_world(POSES, seed=0), cfg, device="cuda")
    paths = defaultdict(list)
    stages = defaultdict(float)
    prof = None
    t_win = 0.0
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for k in range(POSES):
        if k == lo:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            t_win = time.perf_counter()
        res = rep.step()
        if k == hi - 1:
            torch.cuda.synchronize()
            t_win = time.perf_counter() - t_win
            prof.__exit__(None, None, None)
        spans = trace.collect()["spans"]
        if lo <= k < hi:
            continue
        paths[res.path].append(res.step_ms)
        for name, s in spans.items():
            stages[name] += s["self_ms"]
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t_all
    trace.disable()
    card = torch.cuda.get_device_name(0)

    print(json.dumps({"card": card, "poses": POSES, "dtype": "float64",
                      "seconds": t_all, "poses_per_s": POSES / t_all}))
    print(json.dumps({"paths": {
        p: {"steps": len(v), "mean_ms": float(np.mean(v)),
            "total_ms": float(np.sum(v))} for p, v in sorted(paths.items())}}))
    print(json.dumps({"stages_ms": dict(stages)}))

    dev = device_rows(prof)
    busy_ms = sum(us for _k, us, _c in dev) / 1e3
    n_win = hi - lo
    win_paths = [r.path for r in rep.results[lo:hi]]
    print(json.dumps({"window": {
        "steps": [lo, hi], "census": {p: win_paths.count(p) for p in
                                      ("fast", "full", "batch")},
        "wall_ms": t_win * 1e3, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (t_win * 1e3),
        "device_events_per_step": sum(c for _k, _us, c in dev) / n_win,
        "top": top(dev)}}), flush=True)

    profile_superstep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
