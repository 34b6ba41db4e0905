"""Large-N incremental replay on a synthetic Manhattan world: the
counterpart of ``bench_large_inc.py`` on PyTorch.

Shows the reference's unbounded-N contract (realloc growth,
aprilsam.c:411-450) on the port: node and factor capacities double on
demand mid-replay (the state is rebuilt at the new capacity and, on the
card, every CUDA graph is captured again at the new shapes on its first
dispatch), the native planner's windowed fringe scan keeps host planning
O(|F|) per step, and the replay reports a chi2 trace and planning times.

Same flags and defaults as ``bench_large_inc.py``, with --device (default
cuda) in place of --cpu.  Float32 with panel epochs on the card, float64
with the "auto" epoch on the CPU, as the JAX script picks them by
platform; --dtype and --batch_backend override.

    python -m aprilsam_tpu_torch.large_inc [--poses 20000] [--log_chi2]
        [--device cpu] [--panel_nodes 256] [--checkpoints 10] ...

Nothing is captured ahead (no precompile): every signature is captured on
its first dispatch, inside the clock, as the JAX script compiles in-run.
The last line is the JAX script's JSON; the line before it gives the
growths, the graphs captured and their seconds per generation, the memory
reserved, the epochs by backend and K1's launches by shape.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BUCKETS = (64, 128, 256, 384, 640, 1024)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="aprilsam-torch-large-inc",
        description="large-N incremental replay with capacity growth")
    ap.add_argument("--poses", type=int, default=20000)
    ap.add_argument("--log_chi2", action="store_true")
    ap.add_argument("--closure_prob", type=float, default=0.02)
    ap.add_argument("--panel_nodes", type=int, default=256)
    ap.add_argument("--checkpoints", type=int, default=10,
                    help="periodic off-clock chi2 readbacks")
    ap.add_argument("--start_capacity", type=int, default=4096,
                    help="initial node capacity (growth doubles on demand)")
    ap.add_argument("--sweep_window", type=int, default=16,
                    help="windowed-sweep panel capacity (0 = whole-graph "
                         "sweep per superstep)")
    ap.add_argument("--sweep_full_every", type=int, default=16)
    ap.add_argument("--superstep", type=int, default=64)
    ap.add_argument("--policy_lag", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if no card)")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="default: float32 on the card, float64 on the CPU")
    ap.add_argument("--batch_backend", default=None,
                    choices=["auto", "host", "device", "panel"],
                    help="default: panel on the card, auto on the CPU")
    return ap


def large_config(args, device, **overrides):
    """bench_large_inc.py's SolverConfig, by device as the JAX script picks
    it by platform; keyword arguments replace fields."""
    from .solver import SolverConfig

    cpu = device.type == "cpu"
    dtype = args.dtype or ("float64" if cpu else "float32")
    kw = dict(
        dtype=np.float64 if dtype == "float64" else np.float32,
        node_capacity=args.start_capacity,
        factor_capacity=2 * args.start_capacity,
        row_block_capacity=96,
        panel_nodes=args.panel_nodes,
        wallclock_gate=False,
        policy_lag=args.policy_lag, policy_poll=2,
        superstep_size=args.superstep,
        superstep_buckets=BUCKETS,
        sweep_window_panels=args.sweep_window,
        sweep_full_every=args.sweep_full_every,
        log_chi2=bool(args.log_chi2),
        batch_backend=args.batch_backend or ("auto" if cpu else "panel"))
    kw.update(overrides)
    return SolverConfig(**kw)


def make_replay(args, seed: int = 0, **overrides):
    """The script's graph (generated from `seed`) and a deferred Replay of
    it under large_config."""
    from .datasets import manhattan_world
    from .replay import Replay
    from .utils import resolve_device

    device = resolve_device(args.device)
    g = manhattan_world(args.poses, seed=seed,
                        closure_prob=args.closure_prob, block=25,
                        max_closures_per_pose=1)
    cfg = large_config(args, device, **overrides)
    return Replay(g, cfg, batch_update_only=False, deferred=True,
                  device=device)


def run_replay(rep, args, out=print) -> dict:
    """Replay every pose of rep's graph on the clock, with an off-clock
    chi2 read every ``poses // checkpoints`` steps (which dispatches the
    buffered superstep, as the JAX script's reads do); flush() and the
    device's finish inside the clock.  Host planning is timed by wrapping
    solver.incremental.plan_step.  Returns the figures."""
    import torch

    from .kernels import tri_inv
    from .solver import incremental as I

    solver = rep.solver
    cuda = solver.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(solver.device)

    plan_t = [0.0, 0]
    orig_plan = I.plan_step

    def timed_plan(*a, **k):
        tp = time.perf_counter()
        res = orig_plan(*a, **k)
        plan_t[0] += time.perf_counter() - tp
        plan_t[1] += 1
        return res

    I.plan_step = timed_plan
    ck = max(1, args.poses // max(1, args.checkpoints))
    marks = []
    tri_inv.reset_launches()
    try:
        sync()
        t0 = time.perf_counter()
        off = 0.0
        n = 0
        while rep.step() is not None:
            n += 1
            if n % ck == 0:
                t = time.perf_counter()
                c = solver.chi2()
                off += time.perf_counter() - t
                el = time.perf_counter() - t0 - off
                marks.append([n, c])
                out(f"step {n}: chi2 {c:.2f}  {n / el:.1f} poses/s  "
                    f"ncap={solver.cfg.node_capacity}")
                assert np.isfinite(c), "chi2 diverged"
        solver.flush(rep.graph)
        sync()
        total = time.perf_counter() - t0 - off
    finally:
        I.plan_step = orig_plan

    final_chi2 = solver.chi2()
    res = {
        "poses": n, "seconds": total, "poses_per_s": n / total,
        "final_chi2": final_chi2,
        "mean_plan_ms": plan_t[0] / max(1, plan_t[1]) * 1e3,
        "node_capacity": solver.cfg.node_capacity,
        "factor_capacity": solver.cfg.factor_capacity,
        "checkpoints": marks, "counters": dict(solver.counters),
        "epochs": {k: solver.counters[f"epoch_{k}"]
                   for k in ("panel", "dense", "host")},
        "growths": list(solver.growths),
        "graphs": {"captures": solver.graphs.captures,
                   "replays": solver.graphs.replays,
                   "by_generation": {str(k): v for k, v in
                                     solver.graphs.by_generation.items()}},
        "reserved_end": (torch.cuda.memory_reserved(solver.device)
                         if cuda else 0),
        "tri_inv_launches": tri_inv.launches,
        "tri_inv_launches_by_shape": [
            {"shape": [B, N, N], "dtype": dt, "launches": c}
            for (B, N, dt), c in sorted(tri_inv.launches_by_shape.items())],
    }
    if args.log_chi2:
        hist = solver.chi2_history()
        res["ring_entries"] = len(hist)
        assert len(hist) >= n, "metric ring lost entries"
        out(f"chi2 ring: {len(hist)} entries, last {hist[-1]:.2f}")
    return res


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .utils import resolve_device
    from .utils.card import card_line

    device = resolve_device(args.device)
    print(f"device: {device}", flush=True)
    t0 = time.perf_counter()
    rep = make_replay(args)
    g = rep.loaded
    print(f"generated {g.nnodes} poses / {g.nfactors} factors "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)
    res = run_replay(rep, args, out=lambda m: print(m, flush=True))
    card = card_line() if device.type == "cuda" else None
    print(json.dumps({k: v for k, v in res.items() if k != "checkpoints"}),
          flush=True)
    where = f"device={device}" + (f", card={card}" if card else "")
    print(json.dumps({
        "metric": "large_inc_replay_poses_per_sec",
        "value": round(res["poses_per_s"], 2),
        "unit": f"poses/s (poses={res['poses']}, final_chi2="
                f"{res['final_chi2']:.2f}, {where}, mean_plan_ms="
                f"{res['mean_plan_ms']:.3f}, final_ncap="
                f"{res['node_capacity']})",
        "vs_baseline": 0.0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
