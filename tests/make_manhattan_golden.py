"""Regenerate the port's full-length replay goldens with the JAX package.

Replays ``manhattan_world(n, seed)`` through ``aprilsam_tpu.replay.Replay``
on the CPU in float64 with the wall-clock gate off (the deterministic
reference trajectory).

Per-step mode (the default) uses the default ``SolverConfig`` and writes
one line per step: ``step path chi2``, where chi2 is the solver's per-step
``chi2_history()`` entry and path is fast, full or batch.

    JAX_PLATFORMS=cpu python tests/make_manhattan_golden.py \
        --out aprilsam_tpu_torch/golden/manhattan3500_seed0.txt

``--dtype float32`` runs the per-step replay with the solver state in
float32 (``SolverConfig(dtype=np.float32)``, the CLI's default on the card):

    JAX_PLATFORMS=cpu python tests/make_manhattan_golden.py --dtype float32 \
        --out aprilsam_tpu_torch/golden/manhattan3500_seed0_f32.txt

With ``--superstep S`` it writes the superstep golden instead: the replay
in deferred mode at ``superstep_size=S``, ``policy_lag=0`` and
``log_chi2=True`` with the bench ladder of union buckets, one line per
metric-ring entry (``entry chi2``: one per superstep and per batch epoch),
and a header of ``# <key> <json>`` lines holding that config, its counters,
and the final chi2 of three lagged configs: the bench's (``policy_lag=3``,
``policy_poll=2``, ``log_chi2=False``), the bench's with the windowed sweep
(``sweep_window_panels=8``, ``sweep_full_every=8``) and the CLI's
``--superstep S`` (``policy_lag=2``, the default ladder).

    JAX_PLATFORMS=cpu python tests/make_manhattan_golden.py --superstep 96 \
        --out aprilsam_tpu_torch/golden/manhattan3500_seed0_super96.txt

With ``--superstep S --batch_backend panel`` the superstep golden runs
the ring and bench configs with the panel batch epoch instead of the host
one; every header records the replay's batch epochs by the backend that
ran them (``epochs``: panel, dense, host), counted by wrapping the JAX
package's epoch functions for the run.

    JAX_PLATFORMS=cpu python tests/make_manhattan_golden.py --superstep 96 \
        --batch_backend panel \
        --out aprilsam_tpu_torch/golden/manhattan3500_seed0_super96_panel.txt

With ``--bundled B`` it writes the bundled per-step golden: header lines
only, the final chi2, counters, path census and epochs of two per-step
replays in deferred mode at ``bundle_size=B``, ``policy_lag=B`` with mixed
bundles, without (``bundled``) and with (``bundled-coalesced``)
``coalesce_full_solves``.  Each bundle dispatch is waited for, so that the
lagged policy always reads the newest due stats: the JAX package reads the
newest that are ready, and on its asynchronous CPU backend that is a race
whose outcome moves the final chi2 by several units at a thousand poses.

    JAX_PLATFORMS=cpu python tests/make_manhattan_golden.py --bundled 8 \
        --out aprilsam_tpu_torch/golden/manhattan3500_seed0_bundled8.txt

``chip_smoke.py`` holds the port's replays on the card against these files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aprilsam_tpu.datasets import manhattan_world  # noqa: E402
from aprilsam_tpu.replay import Replay  # noqa: E402
from aprilsam_tpu.solver import SolverConfig  # noqa: E402

BENCH_BUCKETS = (64, 128, 256, 384, 640, 1024)


def superstep_configs(S: int, backend: str = "auto") -> dict:
    """The superstep replays of the golden, by name: keyword arguments of
    SolverConfig on top of ``wallclock_gate=False``.  With the panel
    backend, the ring and bench configs only."""
    bench = dict(superstep_size=S, superstep_buckets=BENCH_BUCKETS,
                 policy_lag=3, policy_poll=2, log_chi2=False)
    if backend != "auto":
        bench["batch_backend"] = backend
        return {"ring": dict(bench, policy_lag=0, policy_poll=1,
                             log_chi2=True),
                "bench": bench}
    return {
        "ring": dict(bench, policy_lag=0, policy_poll=1, log_chi2=True),
        "bench": bench,
        "windowed": dict(bench, sweep_window_panels=8, sweep_full_every=8),
        "cli": dict(superstep_size=S, policy_lag=2, log_chi2=False),
    }


def bundled_configs(B: int) -> dict:
    """The bundled per-step replays of the golden, by name."""
    bundled = dict(bundle_size=B, policy_lag=B, mixed_bundles=True)
    return {"bundled": bundled,
            "bundled-coalesced": dict(bundled, coalesce_full_solves=True)}


EPOCHS = Counter()


def count_epochs() -> None:
    """Count the batch epochs by the backend that ran them, by wrapping the
    JAX package's epoch functions for the life of this process (the
    package looks each of them up by module attribute at call time)."""
    from aprilsam_tpu.solver import batch, host_batch, panel_epoch

    for mod, name, key in ((panel_epoch, "panel_epoch_step", "panel"),
                           (batch, "_batch_step", "dense"),
                           (host_batch, "host_batch_epoch", "host")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            EPOCHS[_key] += 1
            return _orig(*a, **kw)

        setattr(mod, name, counted)


def _wait_each_dispatch(solver) -> None:
    """Make a lagged replay deterministic: the policy reads the newest due
    stats that are ready, else the oldest due, and on the asynchronous CPU
    backend readiness is a race; waiting for each bundle dispatch makes
    every due entry ready, so the policy always reads the newest."""
    dispatch = solver._dispatch_queue

    def waited():
        dispatch()
        jax.block_until_ready(solver.ds)
    solver._dispatch_queue = waited


def _replay(g, kw: dict, wait: bool = False):
    """One deferred replay (with `wait`, every stats entry is ready when it
    is due); returns (solver, seconds, path census, epochs by backend)."""
    cfg = SolverConfig(wallclock_gate=False, **kw)
    rep = Replay(g, cfg, deferred=True)
    if wait:
        _wait_each_dispatch(rep.solver)
    EPOCHS.clear()
    t0 = time.perf_counter()
    res = rep.run()
    secs = time.perf_counter() - t0
    census = {p: sum(r.path == p for r in res)
              for p in ("fast", "full", "batch", "super")}
    epochs = {k: EPOCHS[k] for k in ("panel", "dense", "host")}
    return rep.solver, secs, census, epochs


def write_superstep(args) -> None:
    g = manhattan_world(args.poses, seed=args.seed)
    cfgs = superstep_configs(args.superstep, args.batch_backend)
    solver, secs, _census, epochs = _replay(g, cfgs["ring"])
    hist = solver.chi2_history()
    head = {"config": {"wallclock_gate": False, **cfgs["ring"]},
            "counters": dict(solver.counters), "epochs": epochs,
            "seconds": secs}
    print(f"ring: {len(hist)} entries in {secs:.1f} s, counters "
          f"{solver.counters}, epochs {epochs}, final chi2 "
          f"{solver.chi2()!r}")
    for name in [k for k in cfgs if k != "ring"]:
        s, secs, _census, epochs = _replay(g, cfgs[name])
        head[name] = {"config": {"wallclock_gate": False, **cfgs[name]},
                      "final_chi2": s.chi2(), "counters": dict(s.counters),
                      "epochs": epochs, "seconds": secs}
        print(f"{name}: final chi2 {s.chi2()!r} in {secs:.1f} s, counters "
              f"{s.counters}, epochs {epochs}")
    with open(args.out, "w") as f:
        f.write(f"# manhattan_world({args.poses}, seed={args.seed}), JAX "
                "package on the CPU, float64, Replay(deferred=True); "
                "columns: entry chi2_history; header lines: # key json\n")
        for key, val in head.items():
            f.write(f"# {key} {json.dumps(val, sort_keys=True)}\n")
        for i, c in enumerate(hist):
            f.write(f"{i} {float(c)!r}\n")


def write_bundled(args) -> None:
    g = manhattan_world(args.poses, seed=args.seed)
    head = {}
    for name, kw in bundled_configs(args.bundled).items():
        s, secs, census, epochs = _replay(g, kw, wait=True)
        head[name] = {"config": {"wallclock_gate": False, **kw},
                      "final_chi2": s.chi2(), "counters": dict(s.counters),
                      "census": census, "epochs": epochs, "seconds": secs}
        print(f"{name}: final chi2 {s.chi2()!r} in {secs:.1f} s, census "
              f"{census}, counters {s.counters}, epochs {epochs}")
    with open(args.out, "w") as f:
        f.write(f"# manhattan_world({args.poses}, seed={args.seed}), JAX "
                "package on the CPU, float64, Replay(deferred=True), per "
                "step in bundles, each bundle dispatch waited for (the "
                "policy reads the newest due stats); header lines only: "
                "# key json\n")
        for key, val in head.items():
            f.write(f"# {key} {json.dumps(val, sort_keys=True)}\n")


def write_per_step(args) -> None:
    g = manhattan_world(args.poses, seed=args.seed)
    rep = Replay(g, SolverConfig(wallclock_gate=False,
                                 dtype=np.dtype(args.dtype)))
    t0 = time.perf_counter()
    res = rep.run()
    secs = time.perf_counter() - t0
    hist = rep.solver.chi2_history()
    assert len(hist) == len(res), (len(hist), len(res))
    with open(args.out, "w") as f:
        dt = "" if args.dtype == "float64" else f", dtype=np.{args.dtype}"
        f.write(f"# manhattan_world({args.poses}, seed={args.seed}), JAX "
                f"package on the CPU, {args.dtype}, SolverConfig("
                f"wallclock_gate=False{dt}); columns: step path "
                "chi2_history\n")
        for r, c in zip(res, hist):
            f.write(f"{r.step} {r.path} {float(c)!r}\n")
    census = {p: sum(r.path == p for r in res) for p in ("fast", "full", "batch")}
    print(f"{len(res)} steps in {secs:.1f} s, census {census}, "
          f"final chi2 {float(hist[-1])!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=3500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--superstep", type=int, default=1,
                    help="write the superstep golden at this superstep_size "
                         "(1 = the per-step golden)")
    ap.add_argument("--batch_backend", default="auto",
                    choices=["auto", "panel", "device"],
                    help="batch epoch backend of the superstep golden")
    ap.add_argument("--bundled", type=int, default=0,
                    help="write the bundled per-step golden at this "
                         "bundle_size")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"],
                    help="solver dtype of the per-step golden")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    count_epochs()
    if args.bundled > 1:
        write_bundled(args)
    elif args.superstep > 1:
        write_superstep(args)
    else:
        write_per_step(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
