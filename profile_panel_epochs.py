"""The panel-backend S = 96 replays of one tree of the port, timed whole and
epoch by epoch, on one NVIDIA card.

    python3 profile_panel_epochs.py [TREE]

TREE is a checkout of the repository (default: the one holding this
script); its aprilsam_tpu_torch is imported, so two commits can be held
against each other in one call (parent, change, change, parent).  Replays
manhattan_world(3500, seed=0) in deferred mode, float64, with
batch_backend="panel" and the bench's superstep buckets, in the two configs
of chip_smoke.py phase 9: "ring" (policy_lag=0, log_chi2 on: 30 panel
epochs) and "bench" (policy_lag=3, policy_poll=2, log_chi2 off: 9).  Each
config runs eagerly and, where the tree has CUDA graphs (solver.graphs),
on graphs after precompile (the solver's signatures and both epoch
ladders).  One JSON line per config and mode:
  * "runs_s", "poses_per_s": three whole replays (wall seconds ending in
    torch.cuda.synchronize()) and the median's poses/s;
  * "epoch_enqueue_ms", "epoch_tail_ms": one more replay in which each
    epoch starts on an idle card (synchronize before) and is waited for
    (synchronize after): the mean host time until the epoch returns (the
    symbolic phase, the panel plan, the launches or replays), and the mean
    time the card still works after that; their sum is the epoch's time
    alone;
  * "final_chi2", "counters" of the last replay.
Needs a card; exits 1 without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from statistics import mean, median

import numpy as np
import torch

POSES = 3500
CONFIGS = {"ring": dict(policy_lag=0, policy_poll=1, log_chi2=True),
           "bench": dict(policy_lag=3, policy_poll=2, log_chi2=False)}


def replay(cfg, graphs: bool, split: bool = False) -> dict:
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.replay import Replay

    # the previous replay's solver and graphs (the split's wrapper makes a
    # cycle)
    gc.collect()
    torch.cuda.empty_cache()
    rep = Replay(manhattan_world(POSES, seed=0), cfg, deferred=True,
                 device="cuda")
    s = rep.solver
    if hasattr(s, "graphs"):
        s.graphs.enabled = graphs
    if graphs:
        from aprilsam_tpu_torch.solver.batch import precompile_device_batch
        from aprilsam_tpu_torch.solver.panel_epoch import \
            precompile_panel_epoch

        s.precompile(nnodes=POSES)
        precompile_device_batch(s.ds, s.cfg, POSES, s.graphs)
        precompile_panel_epoch(s.ds, s.cfg, POSES, s.graphs)
    enqueue, tail = [], []
    if split:
        epoch = s._epoch

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = epoch(*args, **kw)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue.append((t1 - t0) * 1e3)
            tail.append((time.perf_counter() - t1) * 1e3)
            return out
        s._epoch = timed
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep.run()
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t, "enqueue": enqueue,
            "tail": tail, "final_chi2": s.chi2(),
            "counters": dict(s.counters)}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_panel_epochs: needs an NVIDIA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else here)
    sys.path.insert(0, tree)
    from aprilsam_tpu_torch.solver import IncrementalSolver, SolverConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    has_graphs = hasattr(IncrementalSolver(SolverConfig(), device="cuda"),
                         "graphs")
    for name, kw in CONFIGS.items():
        cfg = SolverConfig(wallclock_gate=False, dtype=np.float64,
                           batch_backend="panel", superstep_size=96,
                           superstep_buckets=(64, 128, 256, 384, 640, 1024),
                           **kw)
        for graphs in ((False, True) if has_graphs else (False,)):
            runs = [replay(cfg, graphs) for _ in range(3)]
            split = replay(cfg, graphs, split=True)
            secs = [r["seconds"] for r in runs]
            print(json.dumps({
                "tree": os.path.relpath(tree, here), "card": smi,
                "config": name, "graphs": graphs, "runs_s": secs,
                "poses_per_s": POSES / median(secs),
                "epochs": len(split["enqueue"]),
                "epoch_enqueue_ms": mean(split["enqueue"]),
                "epoch_tail_ms": mean(split["tail"]),
                "final_chi2": runs[-1]["final_chi2"],
                "counters": runs[-1]["counters"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
