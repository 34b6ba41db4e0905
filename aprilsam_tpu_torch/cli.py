"""Replay CLI — the counterpart of examples/aprilsam_demo.c and of
``aprilsam_tpu/cli.py``, on PyTorch.

Same flags and defaults as the JAX package's CLI, plus --device:
  --datapath           g2o/TORO text dataset (VERTEX2/EDGE2)
  --graphpath          binary .graph dataset (default ../data/M3500.graph)
  --batch_update_only  run full batch Gauss-Newton every pose
  --nthreshold 100     batch fallback threshold on relinearized-node count
  --delta_xy 0.1       relinearization xy threshold
  --delta_theta 0.1    relinearization theta threshold
Float32 on the card unless --dtype float64; float64 on the CPU.
--superstep S > 1 is the throughput mode: S steps per joint frontal update,
the policy read two dispatches late, chi2 read once at the end.

    python -m aprilsam_tpu_torch.cli --datapath M3500.txt --quiet --json
    python -m aprilsam_tpu_torch.cli --graphpath M3500.graph --superstep 96
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="aprilsam-torch-demo",
        description="AprilSAM on PyTorch: pose-by-pose M3500-style replay",
    )
    ap.add_argument("--datapath", default="", help="loaded dataset file path")
    ap.add_argument("--graphpath", default="../data/M3500.graph",
                    help="loaded graph file path")
    ap.add_argument("--batch_update_only", action="store_true",
                    help="batch update every pose")
    ap.add_argument("--nthreshold", type=int, default=100,
                    help="batch update if more than nthreshold nodes changed")
    ap.add_argument("--delta_xy", type=float, default=0.1,
                    help="re-linearization xy threshold")
    ap.add_argument("--delta_theta", type=float, default=0.1,
                    help="re-linearization theta threshold")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="device dtype (default: float32 on the card, "
                         "float64 on the CPU)")
    ap.add_argument("--node_capacity", type=int, default=4096)
    ap.add_argument("--no_wallclock_gate", action="store_true",
                    help="disable the batch_time/3 wall-clock fallback gate")
    ap.add_argument("--show_timing", action="store_true",
                    help="print per-step stage timing (plan/dispatch/policy)")
    ap.add_argument("--ordering", choices=["md", "heapmd"], default="md",
                    help="fill-reducing ordering: md (default) or the "
                         "reference's bucketed-heap scheme")
    ap.add_argument("--superstep", type=int, default=1,
                    help="dispatch this many steps as one joint frontal "
                         "update (throughput mode; 1 = per-step reference "
                         "semantics)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if no card)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print one summary JSON line at the end")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .io import load_g2o_text, load_graph_file
    from .replay import Replay
    from .solver import SolverConfig
    from .utils import resolve_device

    device = resolve_device(args.device)
    if args.dtype is None:
        args.dtype = "float64" if device.type == "cpu" else "float32"

    if args.datapath:
        loaded = load_g2o_text(args.datapath)
    else:
        loaded = load_graph_file(args.graphpath)
    if not args.quiet:
        print(f"{loaded.nnodes} nodes,  factors: {loaded.nfactors}")

    cfg = SolverConfig(
        delta_xy=args.delta_xy,
        delta_theta=args.delta_theta,
        nthreshold=args.nthreshold,
        dtype=np.float64 if args.dtype == "float64" else np.float32,
        node_capacity=args.node_capacity,
        factor_capacity=max(8192, args.node_capacity * 2),
        wallclock_gate=not args.no_wallclock_gate,
        show_timing=args.show_timing,
        ordering=args.ordering,
        superstep_size=args.superstep,
        policy_lag=2 if args.superstep > 1 else 0,
        log_chi2=args.superstep <= 1,
    )
    rep = Replay(loaded, cfg, batch_update_only=args.batch_update_only,
                 deferred=args.superstep > 1, device=device)
    res = rep.run(max_steps=args.max_steps, verbose=not args.quiet)

    last = res[-1] if res else None
    final_chi2 = last.chi2 if last is not None else float("nan")
    if final_chi2 != final_chi2:
        # superstep mode logs no per-step chi2; read it once
        rep.solver.flush(rep.graph)
        final_chi2 = rep.solver.chi2()
    if args.json and last is not None:
        print(json.dumps({
            "steps": len(res),
            "final_chi2": final_chi2,
            "total_ms": last.total_ms,
            "mean_step_ms": last.total_ms / len(res),
            "poses_per_sec": 1e3 * len(res) / last.total_ms,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
