"""The comparison that decides a run's `correct`.

Every answer the run read (each pass's end; in the per-step mode also a
checked step's chi2 and the states of every pose the solver held then)
is judged by the plain reference (reference/posegraph.py) on the pass's
generated graph, in float64:

  chi2_rel   |chi2 the program returned - the reference's chi2 of the
             states the program returned| / the latter (at least FLOOR:
             before the first loop closes, the odometry chain is met
             exactly and chi2 is rounding, 1e-28, which no relative
             comparison can judge): whether the returned chi2 belongs to
             the returned states at the precision the configuration
             states;
  end_gap    at each pass's end, how far the reference's chi2 of the
             returned states of every pose lies above the optimum of the
             whole graph (the reference's Gauss-Newton from the true
             poses), over the optimum: whether the states are the solve's
             answer.  The incremental solver stops short of the optimum
             (it relinearizes a pose only past the configuration's
             thresholds), so sound runs read above 0; a solve whose
             updates are dropped or wrong reads far above;
  nonfinite  answers with a state or chi2 that is not a finite number
             (an exact comparison: limit 0).

Each number is the largest over the run's answers; the cell's file gives
the limits, and PERF.md the readings they were set from.  Mid-pass the
answer can lie well above the optimum for a while after a loop closes
(sound runs read up to 2.3 times at a checked step), so the optimum is
compared at pass ends alone.
"""

from __future__ import annotations

import math

import numpy as np

from .reference import posegraph as R

NUMBERS = ("chi2_rel", "end_gap", "nonfinite")
FLOOR = 1.0


def judge(graphs: list, prior: dict, answers, limits: dict,
          device="cpu") -> dict:
    """Judge `answers` (dicts of the index of their graph in `graphs`,
    step, chi2, states, and "end" at a pass's end) against `limits`
    ({number: limit}).  Returns {"numbers": {name: {"value", "limit"}},
    "failed": answers out of a limit, "correct": bool, "answers": [graph,
    step, the program's chi2, the reference's chi2 of its states] of
    every finite answer, "end_gap": [each finite pass end's (chi2 -
    optimum) / optimum]}."""
    worst = {"chi2_rel": 0.0, "end_gap": 0.0, "nonfinite": 0}
    failed = 0
    rows, end_gap = [], []
    for ans in answers:
        k, graph = ans["step"], graphs[ans["graph"]]
        x = np.asarray(ans["states"], dtype=np.float64)
        edges = R.edges_upto(graph, k)
        if (x.shape != (k + 1, 3) or not np.all(np.isfinite(x))
                or not math.isfinite(ans["chi2"])):
            worst["nonfinite"] += 1
            failed += 1
            continue
        ref = R.chi2(x, *edges, prior)
        rel = abs(ans["chi2"] - ref) / max(ref, FLOOR)
        rows.append([ans["graph"], k, ans["chi2"], ref])
        worst["chi2_rel"] = max(worst["chi2_rel"], rel)
        out = rel > limits["chi2_rel"]
        if ans.get("end"):
            opt = R.optimum(graph["truth"][:k + 1], *edges, prior,
                            device)[1]
            gap = (ref - opt) / max(opt, FLOOR)
            end_gap.append(gap)
            worst["end_gap"] = max(worst["end_gap"], gap)
            out = out or gap > limits["end_gap"]
        failed += int(out)
    numbers = {n: {"value": worst[n], "limit": limits[n]} for n in NUMBERS}
    correct = bool(answers) and all(
        v["value"] <= v["limit"] for v in numbers.values())
    return {"numbers": numbers, "failed": failed, "correct": correct,
            "answers": rows, "end_gap": end_gap}
