"""The comparison that decides a run's `correct`.

Every answer the run read (each pass's end; in the per-step mode also a
checked step's chi2 and the states of every pose the solver held then)
is judged by a plain reference on the pass's generated graph, in
float64.  The workload file names the reference (`check.reference`, a
module of reference/; absent, posegraph), which gives the numbers
compared (its NUMBERS) and their computation for one answer (its
numbers()); the cell's file gives their limits, and PERF.md the readings
they were set from.  Common to every reference:

  nonfinite  answers with a state or chi2 that is not a finite number,
             or with states of another shape than the graph's after
             their step (an exact comparison: limit 0); nothing else is
             read of such an answer.

A number in COUNTED is summed over the run's answers; every other is the
largest of them, 0 where no answer gives it.
"""

from __future__ import annotations

import importlib
import math

import numpy as np

COUNTED = ("nonfinite", "ranks_disagree")


def reference(name: str = "posegraph"):
    """The module reference/<name>.py."""
    return importlib.import_module(f"{__package__}.reference.{name}")


def judge(graphs: list, prior: dict, answers, limits: dict,
          device="cpu", reference_name: str = "posegraph") -> dict:
    """Judge `answers` (dicts of the index of their graph in `graphs`,
    step, chi2, states, and "end" at a pass's end) by the reference
    `reference_name` against `limits` ({number: limit}).  Returns
    {"numbers": {name: {"value", "limit"}}, "failed": answers out of a
    limit, "correct": bool, "answers": [graph, step, the program's chi2,
    {number: value}] of every finite answer}."""
    ref = reference(reference_name)
    worst = {n: 0 if n in COUNTED else None for n in ref.NUMBERS}
    failed = 0
    rows = []
    for ans in answers:
        k, graph = ans["step"], graphs[ans["graph"]]
        x = np.asarray(ans["states"], dtype=np.float64)
        if (x.shape != (k + 1, 3) or not np.all(np.isfinite(x))
                or not math.isfinite(ans["chi2"])):
            worst["nonfinite"] += 1
            failed += 1
            continue
        got = ref.numbers(graph, prior, ans, x, device)
        rows.append([ans["graph"], k, ans["chi2"], got])
        for n, v in got.items():
            if n in COUNTED:
                worst[n] += v
            elif worst[n] is None or v > worst[n]:
                worst[n] = v
        failed += int(any(v > limits[n] for n, v in got.items()))
    numbers = {n: {"value": 0.0 if worst[n] is None else worst[n],
                   "limit": limits[n]} for n in ref.NUMBERS}
    correct = bool(answers) and all(
        v["value"] <= v["limit"] for v in numbers.values())
    return {"numbers": numbers, "failed": failed, "correct": correct,
            "answers": rows}
