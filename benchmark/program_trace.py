"""The program's own spans (aprilsam_tpu_torch/utils/trace.py) beside the
harness's traced pass, and what recording them costs, on the card.

    python3 -m benchmark.program_trace --workload CELL --seed N [--seconds S]
    python3 -m benchmark.program_trace --workload CELL --seed N --cost P

The first runs the cell as ``python3 -m benchmark.run --trace 1`` does,
with run.py's traced_pass replaced by `traced_pass` here: the same pass
and records, and besides them

  * the recorder held on for the pass alone, its collect() in
    rec["program"] (which the per-layer readers of the program's spans
    read first);
  * the idle breakdown again with the program's spans at depths below
    every harness span (`merged`), so that each idle gap goes to the
    innermost span open at its middle, the program's where one is open
    (trace.idle_by_span, as the harness reads it); and split exactly
    (`idle_split`: each moment of idle time to the innermost span open
    then), since a gap that outlasts a fine span goes whole to one;
  * a launch before the first marker kernel (a profiler session's first
    launch starts tens of µs late, which would overstate the offset),
    and five markers before the pass and five after it: the
    host-to-device clock offsets before and after (`clock_offset`), and
    their difference (the drift; the breakdowns place every span by the
    first);

printed as one JSON line before the result line, with the coverage (the
share of the idle time that falls to the `step` span's own time or to a
harness label, where no other program span is open) and the agreement of
the program's spans with the harness's (planning, epochs, captures).

The second (--cost) times P pairs of untraced passes of the cell on one
solver configuration, recorder off and on in turns (off, on, on, off,
...), and prints each pass's seconds (with the spans, counters and the
program-span metrics of those that recorded: their readings without the
profiler) and the medians.

run.py's traced_pass is to take the recorder, the merge and the second
marker from here, and this copy of it then goes.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict

import numpy as np

from . import run as R
from . import trace

HARNESS_OTHER = "harness, between steps"
MARKS = 5          # marker kernels before and after the pass
PROGRAM_METRICS = ("stats_wait_ms_per_pose", "dispatch_ms_per_replay",
                   "epoch_symbolic_ms")


def merged(harness: list, program: list) -> list:
    """The harness's span records (label, start, end, depth) followed by
    the program's (name, start, end, parent, step), each at the harness's
    deepest depth + 1 + its own nesting depth."""
    base = max((r[3] for r in harness), default=-1) + 1
    depth = []
    out = list(harness)
    for name, t0, t1, parent, _step in program:
        depth.append(0 if parent < 0 else depth[parent] + 1)
        if t1:
            out.append((name, t0, t1, base + depth[-1]))
    return out


def idle_split(busy_s, busy_e, window, spans, offset: int,
               other: str = HARNESS_OTHER) -> list:
    """Idle time of the device inside `window` (device-clock ns) by the
    innermost (deepest) host span open at each moment: [[label, seconds]],
    largest first.  Unlike trace.idle_by_span, which gives a whole gap to
    the span open at its middle, a gap that several spans share is split
    among them."""
    lo, hi = window
    b = np.unique(np.clip(np.asarray(
        [lo, hi] + [t + offset for r in spans for t in (r[1], r[2])],
        np.int64), lo, hi))
    names = sorted({r[0] for r in spans})
    index = {n: i for i, n in enumerate(names)}
    lab = np.full(len(b) - 1, -1)
    for name, t0, t1, *_rest in sorted(spans, key=lambda r: r[3]):
        i0, i1 = np.searchsorted(b, [t0 + offset, t1 + offset])
        lab[i0:i1] = index[name]
    keep = (busy_e > lo) & (busy_s < hi)
    s, e = np.clip(busy_s[keep], lo, hi), np.clip(busy_e[keep], lo, hi)
    busy_to = np.zeros(len(b), np.int64)            # busy time in [lo, b]
    if len(s):
        done = np.concatenate([[0], np.cumsum(e - s)])
        k = np.searchsorted(s, b, side="right")      # intervals begun by b
        last = np.maximum(k - 1, 0)
        busy_to = np.where(k > 0, done[last] + np.minimum(b, e[last])
                           - s[last], 0)
    idle = np.diff(b) - np.diff(busy_to)
    tot = defaultdict(float)
    for i, g in zip(lab.tolist(), idle.tolist()):
        tot[names[i] if i >= 0 else other] += g / 1e9
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])
            if v > 0]


def marks(torch, n: int = MARKS) -> list:
    """`n` marker kernels, each launched onto an idle card right after a
    host stamp: the stamps."""
    stamps = []
    for _ in range(n):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter_ns())
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return stamps


def clock_offset(starts: list, stamps: list) -> int:
    """Device clock minus host clock from markers' device starts and their
    host stamps: each start lags its stamp by the offset and the launch's
    latency, so the least lag is the offset and the least latency."""
    return min(d - h for d, h in zip(starts, stamps))


def traced_pass(driver, rep, checked) -> tuple:
    """benchmark/run.py:traced_pass, with the program's spans recorded,
    merged into the idle breakdown, and the clock placed by markers
    before and after the pass."""
    import torch

    from aprilsam_tpu_torch.replay import Replay
    from aprilsam_tpu_torch.solver import host_batch, incremental
    from aprilsam_tpu_torch.solver.incremental import IncrementalSolver
    from aprilsam_tpu_torch.utils import trace as program
    from aprilsam_tpu_torch.utils.cache import GraphCache

    targets = [
        (Replay, "step", "step, other host work", None, None),
        (incremental, "plan_step", "planning", None, None),
        (host_batch, "host_batch_epoch", "host epoch", None, None),
        (incremental, "run_batch_epoch", "device epoch", None, None),
        (GraphCache, "run", "dispatch", "capture",
         lambda a: a[0].captures),
        (IncrementalSolver, "_maybe_grow_capacity", None, "growth",
         lambda a: len(a[0].growths)),
    ]
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    program.collect()
    program.enable()
    try:
        with trace.Spans(targets) as spans, prof:
            torch.cuda._sleep(1000)     # a session's first launch starts
            torch.cuda.synchronize()    # late: no marker
            before = marks(torch)
            w0 = time.perf_counter_ns()
            res = driver.run_pass(rep, checked)
            w1 = time.perf_counter_ns()
            after = marks(torch)
    finally:
        prog = program.collect(rep.solver)
        program.disable()
    names, starts, durs = trace.device_records(prof)
    markers = [s for n, s in zip(names, starts.tolist())
               if trace.MARKER in n]
    offset = offset2 = None
    if len(markers) == 1 + 2 * MARKS:
        offset = clock_offset(markers[1:1 + MARKS], before)
        offset2 = clock_offset(markers[1 + MARKS:], after)
    keep = np.asarray([trace.MARKER not in n for n in names], dtype=bool)
    names = [n for n, k in zip(names, keep) if k]
    starts, durs = starts[keep], durs[keep]
    bs, be = trace.busy_intervals(starts, durs)
    if offset is not None:
        lo, hi = w0 + offset, w1 + offset
        busy = int(np.sum(np.clip(be, lo, hi) - np.clip(bs, lo, hi)))
        idle = trace.idle_by_span(bs, be, (lo, hi), spans.records, offset,
                                  other=HARNESS_OTHER)
        both = merged(spans.records, prog["records"])
        every = trace.idle_by_span(bs, be, (lo, hi), both, offset, n=1000,
                                   other=HARNESS_OTHER)
        split = idle_split(bs, be, (lo, hi), both, offset)
    else:
        busy, idle, every, split = int(np.sum(be - bs)), None, None, None
    k1 = np.asarray([any(k in n for k in R.K1_KERNELS) for n in names],
                    dtype=bool)
    rec = {"poses": res["poses"], "pass_s": res["seconds"],
           "window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
           "spans": {k: list(v) for k, v in spans.totals.items()},
           "counters": res["counters"], "growths": res["growths"],
           "captures": res["captures"], "capture_s": res["capture_s"],
           "k1_launches": res["k1_launches"],
           "k1_device_s": float(np.sum(durs[k1])) / 1e9,
           "device_kind": torch.cuda.get_device_name(0),
           "device_ops": trace.by_name(names, durs), "idle_gaps": idle,
           "program": prog}
    harness = {t[2] for t in targets} | {t[3] for t in targets}
    print(json.dumps({
        "offset_ns": offset, "offset_after_ns": offset2,
        "drift_ns": (offset2 - offset if offset2 is not None
                     and offset is not None else None),
        "idle_gaps_merged": every,
        "coverage": coverage(every, harness),
        "idle_split": split,
        "coverage_split": coverage(split, harness),
        "agreement": agreement(rec),
        "program_spans": prog["spans"],
        "program_counters": prog["counters"]}), flush=True)
    return res, rec


def coverage(every, harness: set):
    """Idle seconds in all, and the share of them that falls to the
    program's `step` span's own time or to a harness label (no program
    span open but the step)."""
    if every is None:
        return None
    total = sum(s for _n, s in every)
    loose = sum(s for n, s in every
                if n == "step" or n in harness or n == HARNESS_OTHER)
    return {"idle_s": total, "step_or_harness_s": loose,
            "share": loose / total if total else None}


def agreement(rec: dict) -> dict:
    """The program's spans against the harness's in the same pass: each
    pair's two readings in ms, and the second over the first less one."""
    sp, h = rec["program"]["spans"], rec["spans"]

    def ms(name):
        return sp.get(name, {}).get("ms", 0.0)

    pairs = {
        "planning": (h.get("planning", [0.0])[0], ms("solver.plan")),
        "epochs": (sum(h.get(k, [0.0])[0] for k in ("host epoch",
                                                   "device epoch")),
                   ms("epoch")),
        "capture_graph": (rec["capture_s"] * 1e3, ms("graphs.capture_graph")),
    }
    return {k: [a, b, (b / a - 1.0) if a else None]
            for k, (a, b) in pairs.items()}


def cost(args) -> dict:
    """Untraced passes with the recorder off and on, in turns."""
    from aprilsam_tpu_torch.utils import trace as program

    spec = R.cell_spec(args.workload)
    config, wl = spec["config"], spec["workload"]
    pool = wl.get("noise_pool")
    drivers = R.load_file("drivers", wl["driver"])
    graph = R.pass_graph(config, args.seed, 0, pool)
    driver = drivers.Driver(config, wl, "cuda", graph)
    secs = {"off": [], "on": []}
    order = [k for _ in range(args.cost // 2 + 1)
             for k in ("off", "on", "on", "off")][:2 * args.cost]
    for j, mode in enumerate(order):
        rep = driver.build(R.pass_graph(config, args.seed, j, pool))
        if mode == "on":
            program.enable()
        try:
            res = driver.run_pass(rep)
        finally:
            got = program.collect()
            program.disable()
        secs[mode].append(res["seconds"])
        rec = {"poses": res["poses"], "counters": res["counters"],
               "program": got}
        print(json.dumps({"pass": j, "recorder": mode,
                          "seconds": res["seconds"],
                          "records": len(got["records"]),
                          "metrics": {m: R.load_file("layer_metrics",
                                                     m).read(rec)
                                      for m in PROGRAM_METRICS},
                          "counters": got["counters"],
                          "spans": got["spans"]}), flush=True)
        del rep
        drivers.collect(driver.device)
    med = {k: statistics.median(v) for k, v in secs.items()}
    return {"cell": args.workload, "card": R.card_line(), "passes": secs,
            "median_s": med, "cost": med["on"] / med["off"] - 1.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.program_trace")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--cost", type=int, default=0,
                    help="time this many pairs of passes, recorder off "
                         "and on, in place of the traced run")
    args = ap.parse_args(argv)
    if args.cost:
        print(json.dumps(cost(args)), flush=True)
        return 0
    R.traced_pass = traced_pass
    return R.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
