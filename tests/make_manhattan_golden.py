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

With ``--large`` it writes the large-N golden: ``bench_large_inc.py``'s
graph (``manhattan_world(poses, seed=0, closure_prob=0.02, block=25,
max_closures_per_pose=1)``, 20 000 poses by default here) and config
(capacity from ``--start_capacity``, doubling on demand; ``panel_nodes``
256, S = 64, union buckets up to 1024, windowed sweep 16/16) with panel
epochs, at ``policy_lag=0``, ``policy_poll=1`` and ``log_chi2=True``: one
line per metric-ring entry, and a header holding that config, its
counters, its epochs by backend and its capacity growths (the step of
each and the capacities after it), and the same of the script's lagged
config (``policy_lag=3``, ``policy_poll=2``, each superstep dispatch
waited for, so that the policy always reads the newest due stats) with
its final chi2.  A checkpoint's chi2 read dispatches the buffered
superstep, so the reads are part of the trajectory: the ring replay reads
chi2 once, at the end (the script's ``--checkpoints 1``), the lagged one
every ``poses // 10`` steps as the script does by default; the header
records each read.

    JAX_PLATFORMS=cpu python tests/make_manhattan_golden.py --large \
        --out aprilsam_tpu_torch/golden/manhattan20000_large.txt

With ``--geopin K`` it writes the mixed-factor golden (BASELINE.json config
3): ``manhattan_world(n, seed, geopin_every=K)``, its xytpos priors added
as they arrive, replayed pose by pose through the port's
``replay.replay_by_max_endpoint`` into the JAX package's solver at
``SolverConfig(wallclock_gate=False, policy_lag=0)``, one line per step
(``step path chi2``, chi2 the ``chi2_history()`` entry); 3500 poses took
36 min on an 8-core CPU that also ran make_schur100k_golden.py:

    JAX_PLATFORMS=cpu python tests/make_manhattan_golden.py --geopin 25 \
        --out aprilsam_tpu_torch/golden/manhattan3500_seed0_geopin25.txt

With ``--rowgrowth`` it writes the row-capacity growth golden: the port's
``datasets.row_growth_world`` built in the JAX package's graph, solved at
20 poses and updated pose by pose to 40 at ``row_block_capacity=8``, per
step and in supersteps of 4 (``replay_checks.py``'s ROW_GROWTH_* settings):
one line per solve or update (``case step rows path chi2``: the row
capacity after it, the path, the returned chi2, nan where deferred) and a
``# case json`` header line per case with its config, metric ring, final
chi2, counters and seconds (about 30 s on the CPU, mostly compiles):

    JAX_PLATFORMS=cpu python tests/make_manhattan_golden.py --rowgrowth \
        --out aprilsam_tpu_torch/golden/rowgrowth40_jax.txt

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


def large_configs(start: int) -> dict:
    """The large-N replays of the golden, by name: ``bench_large_inc.py``'s
    config (keyword arguments of SolverConfig) with panel epochs, at lag 0
    with the metric ring (``ring``) and at the script's lag (``lagged``)."""
    lagged = dict(node_capacity=start, factor_capacity=2 * start,
                  row_block_capacity=96, panel_nodes=256,
                  wallclock_gate=False, policy_lag=3, policy_poll=2,
                  superstep_size=64, superstep_buckets=BENCH_BUCKETS,
                  sweep_window_panels=16, sweep_full_every=16,
                  log_chi2=False, batch_backend="panel")
    return {"ring": dict(lagged, policy_lag=0, policy_poll=1,
                         log_chi2=True),
            "lagged": lagged}


GROWTHS = []


def record_growths() -> None:
    """Record every capacity growth (the step that caused it and the
    capacities after it) by wrapping the JAX solver's growth check for the
    life of this process."""
    from aprilsam_tpu.solver.incremental import IncrementalSolver

    orig = IncrementalSolver._maybe_grow_capacity

    def recorded(self, g):
        before = (self.cfg.node_capacity, self.cfg.factor_capacity)
        orig(self, g)
        after = (self.cfg.node_capacity, self.cfg.factor_capacity)
        if after != before:
            GROWTHS.append({"step": int(g.nnodes) - 1,
                            "node_capacity": after[0],
                            "factor_capacity": after[1]})

    IncrementalSolver._maybe_grow_capacity = recorded


def _large_replay(g, kw: dict, checkpoints: int, wait: bool = False):
    """One large-N replay with the script's chi2 reads every
    ``nnodes // checkpoints`` steps (with `wait`, every superstep dispatch
    is waited for); returns (solver, seconds, epochs by backend, growths,
    the checkpoints' [step, chi2])."""
    rep = Replay(g, SolverConfig(dtype=np.float64, **kw),
                 batch_update_only=False, deferred=True)
    if wait:
        solver = rep.solver
        dispatch = solver._dispatch_superstep

        def waited():
            dispatch()
            jax.block_until_ready(solver.ds)
        solver._dispatch_superstep = waited
    EPOCHS.clear()
    GROWTHS.clear()
    ck = max(1, g.nnodes // checkpoints)
    marks = []
    t0 = time.perf_counter()
    n = 0
    while rep.step() is not None:
        n += 1
        if n % ck == 0:
            # the script's checkpoint read, which dispatches the buffered
            # superstep (part of the trajectory)
            marks.append([n, rep.solver.chi2()])
    rep.solver.flush(rep.graph)
    jax.block_until_ready(rep.solver.ds)
    secs = time.perf_counter() - t0
    epochs = {k: EPOCHS[k] for k in ("panel", "dense", "host")}
    return rep.solver, secs, epochs, list(GROWTHS), marks


def write_large(args) -> None:
    g = manhattan_world(args.poses, seed=0, closure_prob=0.02, block=25,
                        max_closures_per_pose=1)
    record_growths()
    cfgs = large_configs(args.start_capacity)
    head = {"graph": {"nnodes": int(g.nnodes), "nfactors": int(g.nfactors)}}
    for name, kw in cfgs.items():
        lagged = name == "lagged"
        s, secs, epochs, growths, marks = _large_replay(
            g, kw, 10 if lagged else 1, wait=lagged)
        head[name] = {"config": kw, "final_chi2": s.chi2(),
                      "counters": dict(s.counters), "epochs": epochs,
                      "growths": growths, "checkpoints": marks,
                      "node_capacity": s.cfg.node_capacity,
                      "factor_capacity": s.cfg.factor_capacity,
                      "seconds": secs}
        if name == "ring":
            hist = s.chi2_history()
            head[name]["ring_entries"] = len(hist)
        print(f"{name}: final chi2 {s.chi2()!r} in {secs:.1f} s, counters "
              f"{s.counters}, epochs {epochs}, growths {growths}",
              flush=True)
    with open(args.out, "w") as f:
        f.write(f"# manhattan_world({args.poses}, seed=0, closure_prob=0.02, "
                "block=25, max_closures_per_pose=1), JAX package on the CPU, "
                "float64, bench_large_inc.py's config with panel epochs, "
                "Replay(deferred=True); columns: entry chi2_history (ring "
                "config); header lines: # key json\n")
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


def write_geopin(args) -> None:
    from aprilsam_tpu.graph import FactorGraph
    from aprilsam_tpu.solver import IncrementalSolver
    from aprilsam_tpu.solver.incremental import SeedSpec
    from aprilsam_tpu_torch.replay import replay_by_max_endpoint
    from aprilsam_tpu_torch.replay_checks import MIXED_CONFIG

    g = manhattan_world(args.poses, seed=args.seed, geopin_every=args.geopin)
    s = IncrementalSolver(SolverConfig(**MIXED_CONFIG))
    t0 = time.perf_counter()
    res = replay_by_max_endpoint(g, s, FactorGraph, SeedSpec)
    secs = time.perf_counter() - t0
    hist = s.chi2_history()
    assert len(hist) == len(res), (len(hist), len(res))
    kw = ", ".join(f"{k}={v!r}" for k, v in MIXED_CONFIG.items())
    with open(args.out, "w") as f:
        f.write(f"# manhattan_world({args.poses}, seed={args.seed}, "
                f"geopin_every={args.geopin}), JAX package on the CPU, "
                f"float64, SolverConfig({kw}), priors added as they arrive "
                "(replay_by_max_endpoint); columns: step path chi2_history\n")
        for r, c in zip(res, hist):
            f.write(f"{r['step']} {r['path']} {float(c)!r}\n")
    census = {p: sum(r["path"] == p for r in res)
              for p in ("fast", "full", "batch")}
    print(f"{len(res)} steps in {secs:.1f} s, census {census}, "
          f"final chi2 {float(hist[-1])!r}")


def write_rowgrowth(args) -> None:
    from aprilsam_tpu.graph import FactorGraph
    from aprilsam_tpu.solver import IncrementalSolver
    from aprilsam_tpu.solver.incremental import SeedSpec
    from aprilsam_tpu_torch.datasets import row_growth_world
    from aprilsam_tpu_torch.replay import replay_by_max_endpoint
    from aprilsam_tpu_torch.replay_checks import (ROW_GROWTH_CASES,
                                                  ROW_GROWTH_CONFIG,
                                                  ROW_GROWTH_FIRST,
                                                  ROW_GROWTH_GRAPH,
                                                  row_growth_config)

    head, lines = {}, []
    for case, kw in ROW_GROWTH_CASES.items():
        s = IncrementalSolver(row_growth_config(case, SolverConfig))
        t0 = time.perf_counter()
        res = replay_by_max_endpoint(
            row_growth_world(**ROW_GROWTH_GRAPH, graph=FactorGraph), s,
            FactorGraph, SeedSpec, first=ROW_GROWTH_FIRST)
        secs = time.perf_counter() - t0
        head[case] = {"config": {**ROW_GROWTH_CONFIG, **kw},
                      "ring": [float(c) for c in s.chi2_history()],
                      "final_chi2": float(s.chi2()),
                      "counters": {k: int(v) for k, v in s.counters.items()},
                      "seconds": secs}
        lines += [f"{case} {r['step']} {r['rows']} {r['path']} "
                  f"{r['chi2']!r}" for r in res]
        print(f"{case}: rows {[r['rows'] for r in res]}, final chi2 "
              f"{head[case]['final_chi2']!r} in {secs:.1f} s")
    graph = ", ".join(f"{k}={v!r}" for k, v in ROW_GROWTH_GRAPH.items())
    with open(args.out, "w") as f:
        f.write(f"# row_growth_world({graph}), JAX package on the CPU, "
                f"float64, solved at {ROW_GROWTH_FIRST} poses then updated "
                "pose by pose (replay_by_max_endpoint); columns: case step "
                "rows path chi2 (the returned chi2, nan where deferred); "
                "header lines: # case json\n")
        for case, val in head.items():
            f.write(f"# {case} {json.dumps(val, sort_keys=True)}\n")
        f.write("\n".join(lines) + "\n")


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
    ap.add_argument("--large", action="store_true",
                    help="write the large-N golden (bench_large_inc.py's "
                         "graph and config)")
    ap.add_argument("--start_capacity", type=int, default=4096,
                    help="initial node capacity of the large-N golden")
    ap.add_argument("--geopin", type=int, default=0,
                    help="write the mixed-factor golden, a prior every this "
                         "many poses")
    ap.add_argument("--rowgrowth", action="store_true",
                    help="write the row-capacity growth golden")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    count_epochs()
    if args.rowgrowth:
        write_rowgrowth(args)
    elif args.geopin > 0:
        write_geopin(args)
    elif args.large:
        if args.poses == 3500:
            args.poses = 20000
        write_large(args)
    elif args.bundled > 1:
        write_bundled(args)
    elif args.superstep > 1:
        write_superstep(args)
    else:
        write_per_step(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
