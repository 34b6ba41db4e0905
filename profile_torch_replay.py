"""Where the time of the port's main path goes, on one NVIDIA card.

    python3 profile_torch_replay.py

Replays manhattan_world(3500, seed=0) through aprilsam_tpu_torch's Replay on
the card in float64 (default SolverConfig, wall-clock gate off, per-stage
timing on), the smoke run's main path, and prints JSON lines:
  * "paths": step count, mean and total host milliseconds of the fast, full
    and batch steps, outside the profiled window;
  * "stages": host milliseconds per solver stage (plan = host planning,
    dispatch = the device step up to its stats readback, batch_epoch = the
    native host epoch and its upload), summed outside the window;
  * "window": torch.profiler over steps [2000, 2300): wall seconds, device busy
    milliseconds (the sum of device-side self time, one stream), the idle
    share, device events per step, and the ten largest device operations.
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


def _device_self_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_replay: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.replay import Replay
    from aprilsam_tpu_torch.solver import SolverConfig

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
        if lo <= k < hi:
            continue
        paths[res.path].append(res.step_ms)
        tp = rep.solver.tp
        if k > 0:                  # step 0 is solve(), which keeps no stamps
            prev = tp.stamps[0][1]
            for name, t in tp.stamps[1:]:
                stages[name] += (t - prev) * 1e3
                prev = t
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t_all
    card = torch.cuda.get_device_name(0)

    print(json.dumps({"card": card, "poses": POSES, "dtype": "float64",
                      "seconds": t_all, "poses_per_s": POSES / t_all}))
    print(json.dumps({"paths": {
        p: {"steps": len(v), "mean_ms": float(np.mean(v)),
            "total_ms": float(np.sum(v))} for p, v in sorted(paths.items())}}))
    print(json.dumps({"stages_ms": dict(stages)}))

    # device-side rows only (kernels, copies, sets), so no time counts twice
    ka = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    if not ka:
        raise RuntimeError("the profiler recorded no device-side rows")
    dev = sorted(((e.key, _device_self_us(e), e.count) for e in ka
                  if _device_self_us(e) > 0), key=lambda r: -r[1])
    busy_ms = sum(us for _k, us, _c in dev) / 1e3
    n_win = hi - lo
    win_paths = [r.path for r in rep.results[lo:hi]]
    print(json.dumps({"window": {
        "steps": [lo, hi], "census": {p: win_paths.count(p) for p in
                                      ("fast", "full", "batch")},
        "wall_ms": t_win * 1e3, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (t_win * 1e3),
        "device_events_per_step": sum(c for _k, _us, c in dev) / n_win,
        "top": [{"op": k[:80], "ms": us / 1e3, "count": c}
                for k, us, c in dev[:10]]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
