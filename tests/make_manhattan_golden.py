"""Regenerate the port's full-length replay golden with the JAX package.

Replays ``manhattan_world(n, seed)`` through ``aprilsam_tpu.replay.Replay``
on the CPU in float64, with the default ``SolverConfig`` and the wall-clock
gate off (the deterministic reference trajectory), and writes one line per
step: ``step path chi2``, where chi2 is the solver's per-step
``chi2_history()`` entry and path is fast, full or batch.

    JAX_PLATFORMS=cpu python tests/make_manhattan_golden.py \
        --out aprilsam_tpu_torch/golden/manhattan3500_seed0.txt

``chip_smoke.py`` holds the port's replay on the card against this file.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aprilsam_tpu.datasets import manhattan_world  # noqa: E402
from aprilsam_tpu.replay import Replay  # noqa: E402
from aprilsam_tpu.solver import SolverConfig  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=3500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    g = manhattan_world(args.poses, seed=args.seed)
    rep = Replay(g, SolverConfig(wallclock_gate=False))
    t0 = time.perf_counter()
    res = rep.run()
    secs = time.perf_counter() - t0
    hist = rep.solver.chi2_history()
    assert len(hist) == len(res), (len(hist), len(res))
    with open(args.out, "w") as f:
        f.write(f"# manhattan_world({args.poses}, seed={args.seed}), JAX "
                "package on the CPU, float64, SolverConfig(wallclock_gate="
                "False); columns: step path chi2_history\n")
        for r, c in zip(res, hist):
            f.write(f"{r.step} {r.path} {float(c)!r}\n")
    census = {p: sum(r.path == p for r in res) for p in ("fast", "full", "batch")}
    print(f"{len(res)} steps in {secs:.1f} s, census {census}, "
          f"final chi2 {float(hist[-1])!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
