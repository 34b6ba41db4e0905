"""Replays that hold the incremental engine's row-capacity growth and its
ingestion of xytpos priors to the JAX package, on the CPU and on the card
(``chip_smoke.py`` phases ``row-growth`` and ``mixed-factors``,
``tests/test_torch_robustness.py``, ``tests/test_torch_graphs_gpu.py``).
Both drive a graph pose by pose through ``replay.replay_by_max_endpoint``:

  * row growth: ``datasets.row_growth_world`` (40 poses, 80 random
    closures) solved at ROW_GROWTH_FIRST poses, then updated one pose at a
    time, at ``row_block_capacity=8``: the R rows outgrow it (8 -> 12 ->
    18), per step and in supersteps of 4 (ROW_GROWTH_CASES).  Golden:
    ``golden/rowgrowth40_jax.txt``;
  * mixed factors (BASELINE.json config 3): ``manhattan_world(3500,
    seed=0, geopin_every=25)``, 140 xytpos priors arriving through the
    replay, per step at the default SolverConfig (MIXED_CONFIG).  Golden:
    ``golden/manhattan3500_seed0_geopin25.txt`` (a per-step golden).

Both goldens come from ``tests/make_manhattan_golden.py`` (``--rowgrowth``,
``--geopin 25``), the JAX package on the CPU in float64.
"""

from __future__ import annotations

import json
import os

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
ROW_GROWTH_GOLDEN = os.path.join(GOLDEN_DIR, "rowgrowth40_jax.txt")
MIXED_GOLDEN = os.path.join(GOLDEN_DIR, "manhattan3500_seed0_geopin25.txt")

ROW_GROWTH_GRAPH = dict(n_poses=40, closures=80, seed=0)
ROW_GROWTH_FIRST = 20
ROW_GROWTH_CONFIG = dict(node_capacity=256, factor_capacity=1024,
                         panel_nodes=32, wallclock_gate=False,
                         row_block_capacity=8, nthreshold=10**9)
ROW_GROWTH_CASES = {"per-step": {},
                    "deferred": dict(superstep_size=4, policy_lag=0)}
MIXED_GRAPH = dict(n_poses=3500, seed=0, geopin_every=25)
MIXED_CONFIG = dict(wallclock_gate=False, policy_lag=0)
# a step's returned chi2 and each ring entry against the JAX package's,
# relative (absolute 1e-12 near zero): the JAX package reads a step's chi2
# back through a float32 stats vector (2e-8 apart on the CPU at 40 poses),
# the ring in float64 (5e-15 apart)
CHI2_REL = 1e-6


def row_growth_config(case: str, config=None):
    """The SolverConfig of a row-growth case (`config`: the class, the
    port's by default)."""
    if config is None:
        from .solver import SolverConfig as config
    return config(**ROW_GROWTH_CONFIG, **ROW_GROWTH_CASES[case])


def read_row_growth_golden(path: str = ROW_GROWTH_GOLDEN) -> dict:
    """{case: header entry (config, ring, final chi2, counters) with its
    "steps": [{step, rows, path, chi2}]}."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("# "):
                key, _, val = line[2:].partition(" ")
                if val.startswith("{"):
                    out[key] = dict(json.loads(val), steps=[])
                continue
            case, step, rows, p, chi2 = line.split()
            out[case]["steps"].append({"step": int(step), "rows": int(rows),
                                       "path": p, "chi2": float(chi2)})
    return out


def _rel(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-12)


def hold_row_growth(records: list, ring, final_chi2: float,
                    gold: dict) -> dict:
    """A row-growth replay (replay_by_max_endpoint's records, the metric
    ring and the final chi2) against the golden's entry for its case:
    each step's row capacity and path exactly, each returned chi2 (NaN
    where both defer it), each ring entry and the final chi2 within
    CHI2_REL.  Returns the figures, "bad" listing what failed."""
    want = gold["steps"]
    bad = []
    rows = [r["rows"] for r in records]
    paths = [r["path"] for r in records]
    if rows != [w["rows"] for w in want]:
        bad.append(f"row capacities {rows} != {[w['rows'] for w in want]}")
    if paths != [w["path"] for w in want]:
        bad.append(f"paths {paths} != {[w['path'] for w in want]}")
    got = np.asarray([r["chi2"] for r in records])
    ref = np.asarray([w["chi2"] for w in want])
    step_rel = 0.0
    if got.shape != ref.shape or not np.array_equal(np.isnan(got),
                                                    np.isnan(ref)):
        bad.append(f"{got.shape} returned chi2 ({np.isnan(got).sum()} "
                   f"deferred); golden {ref.shape} "
                   f"({np.isnan(ref).sum()} deferred)")
    elif (~np.isnan(ref)).any():
        live = ~np.isnan(ref)
        step_rel = float(np.max(_rel(got[live], ref[live])))
    ring, gring = np.asarray(ring), np.asarray(gold["ring"])
    ring_rel = (float(np.max(_rel(ring, gring)))
                if ring.shape == gring.shape else None)
    final_rel = float(_rel(final_chi2, gold["final_chi2"]))
    if not step_rel <= CHI2_REL:
        bad.append(f"a step's chi2 is {step_rel} from JAX's, relative")
    if ring_rel is None or not ring_rel <= CHI2_REL:
        bad.append(f"ring of {ring.shape} is {ring_rel} from JAX's "
                   f"{gring.shape}")
    if not final_rel <= CHI2_REL:
        bad.append(f"final chi2 {final_chi2!r} against JAX's "
                   f"{gold['final_chi2']!r}")
    return {"rows": rows, "growth_steps": [
                r["step"] for r, p in zip(records, [rows[0]] + rows)
                if r["rows"] != p],
            "step_chi2_rel": step_rel, "ring_rel": ring_rel,
            "final_chi2": final_chi2, "final_rel": final_rel,
            "tol": CHI2_REL, "bad": bad}


def run_row_growth(case: str, device="cuda") -> dict:
    """The port's row-growth replay of `case`.  On the card its graphs are
    prepared (bench.prepare: precompile and the batch epoch's ladder)
    before the replay and again after each step whose dispatch grew the
    rows, at the new capacity; each segment between two preparations
    records its dispatches, graph replays, the cache's generation and the
    captures of that generation.  K1's launch counts leave out the
    preparations' dead plans.  On the CPU, where every dispatch is eager,
    nothing is prepared and the segments count no dispatch.  Returns the
    records, ring, final chi2, final states, the solver and the
    segments."""
    from .bench import prepare
    from .datasets import row_growth_world
    from .kernels import tri_inv
    from .replay import replay_by_max_endpoint
    from .solver import IncrementalSolver

    s = IncrementalSolver(row_growth_config(case), device=device)
    g = s.graphs
    segments = []

    def reset():
        if not g.enabled:
            return
        kept = tri_inv.launches, dict(tri_inv.launches_by_shape)
        prepare(s, ROW_GROWTH_GRAPH["n_poses"])
        tri_inv.launches = kept[0]
        tri_inv.launches_by_shape.clear()
        tri_inv.launches_by_shape.update(kept[1])
        g.calls.clear()
        g.replayed.clear()

    def close(until: int) -> None:
        gen = g.generation
        segments.append({
            "until": until, "generation": gen,
            "dispatches": sum(g.calls.values()),
            "replays": sum(g.replayed.values()),
            "captures": g.by_generation.get(gen, {}).get("captures", 0)})

    rows = [s.cfg.row_block_capacity]

    def on_step(rec: dict) -> None:
        if rec["rows"] != rows[-1]:
            rows.append(rec["rows"])
            close(rec["step"])
            reset()

    reset()
    records = replay_by_max_endpoint(row_growth_world(**ROW_GROWTH_GRAPH), s,
                                     first=ROW_GROWTH_FIRST, on_step=on_step)
    close(records[-1]["step"])
    n = ROW_GROWTH_GRAPH["n_poses"]
    return {"records": records, "ring": s.chi2_history(),
            "final_chi2": float(s.chi2()),
            "states": s.ds.state[:n].cpu().numpy(), "solver": s,
            "segments": segments}


def hold_graphs_over_growth(run: dict) -> list:
    """On the card: one cache generation per growth, each counted from 0;
    in each segment, one graph replay per dispatch, but for the growing
    step's dispatches after its growth, which each captured a graph of the
    new generation (none ran eagerly, and none replayed a graph of the
    freed tables).  Returns what failed."""
    s, segs = run["solver"], run["segments"]
    g = s.graphs
    growths = len(segs) - 1
    bad = []
    if not g.enabled:
        bad.append("graphs are off")
    if g.generation != growths or sorted(g.by_generation) != list(
            range(growths + 1)):
        bad.append(f"{growths} row growths, cache generation "
                   f"{g.generation}, generations {sorted(g.by_generation)}")
    for i, seg in enumerate(segs):
        grew = i < growths
        if seg["generation"] != i + grew:
            bad.append(f"segment {seg}: generation {seg['generation']} "
                       f"after {i + grew} growths")
        if seg["dispatches"] == 0 or seg["dispatches"] != seg["replays"] + (
                seg["captures"] if grew else 0):
            bad.append(f"segment {seg}: not one replay per dispatch")
    return bad


def big_bucket_signatures(solver, nnodes: int) -> list:
    """The per-step signatures of the largest frontal bucket at the panel
    counts that default_signatures leaves out.  The JAX package's
    signatures give that bucket only the last two panel counts, as plan
    overflow headroom late in a trajectory; priors arriving mid-replay
    reach it earlier (the mixed-factor replay: at 4 and 8 active
    panels), where the card would capture its graph in the run."""
    sigs = solver.default_signatures(nnodes)
    full = [s for s in sigs if s[0] == "full"]
    big = max(s[1] for s in full)
    return [("full", big, fr, npanb)
            for fr, npanb in sorted({(s[2], s[3]) for s in full})
            if ("full", big, fr, npanb) not in sigs]


def run_mixed(solver, n_poses: int = MIXED_GRAPH["n_poses"]) -> list:
    """The mixed-factor replay of manhattan_world(MIXED_GRAPH) generated
    at `n_poses` poses into `solver`, solved at pose 0 and updated pose
    by pose; returns replay_by_max_endpoint's records."""
    from .datasets import manhattan_world
    from .replay import replay_by_max_endpoint

    return replay_by_max_endpoint(
        manhattan_world(**dict(MIXED_GRAPH, n_poses=n_poses)), solver)
