"""What a traced pass records: host spans around the program's calls,
taken from outside the program, and the device's operations from
torch.profiler.

Spans (`Spans`) wrap named functions and methods of the program for the
duration of a block, as the port's ``utils/trace.py:host_clock`` does,
and keep each call's start, end and nesting depth on the host clock.  A
target may be labelled by what the call did: a graph-cache dispatch that
captured is a "capture", a capacity check that grew the state a
"growth", and a call that did neither is dropped or keeps its own label.

The device's records (`device_records`) are read from the profiler's raw
events (``prof.profiler.kineto_results``), so that a pass of a million
kernels costs no per-event Python objects beyond one read; each record
counts once.  `clock_offset` places the host clock on the device's by a
marker kernel launched right after a synchronize.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

MARKER = "spin_kernel"      # torch.cuda._sleep's kernel


class Spans:
    """Host spans of `targets`: (owner, attribute, label, changed_label,
    probe).  With a probe (a function of the call's arguments), a call
    after which the probe reads another value is labelled changed_label,
    and otherwise label; a None label drops the call."""

    def __init__(self, targets):
        self.targets = targets
        self.records = []            # (label, start ns, end ns, depth)
        self.totals = defaultdict(lambda: [0.0, 0])   # label: [ms, calls]
        self._depth = 0
        self._saved = []

    def _wrap(self, fn, label, changed, probe):
        def run(*args, **kw):
            before = probe(args) if probe else None
            depth = self._depth
            self._depth += 1
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kw)
            finally:
                t1 = time.perf_counter_ns()
                self._depth = depth
                name = (changed if probe and probe(args) != before
                        else label)
                if name is not None:
                    self.records.append((name, t0, t1, depth))
                    self.totals[name][0] += (t1 - t0) / 1e6
                    self.totals[name][1] += 1
        return run

    def __enter__(self):
        for owner, attr, label, changed, probe in self.targets:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, label, changed, probe))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()
        return False


def device_records(prof):
    """(names, starts ns, durations ns) of every device-side record of
    `prof`: kernels, copies and sets."""
    from torch.autograd import DeviceType

    names, starts, durs = [], [], []
    for k in prof.profiler.kineto_results.events():
        if k.device_type() != DeviceType.CUDA:
            continue
        names.append(k.name())
        starts.append(k.start_ns())
        durs.append(k.duration_ns())
    return names, np.asarray(starts, np.int64), np.asarray(durs, np.int64)


def busy_intervals(starts, durs):
    """The union of the intervals [start, start + dur) as merged, sorted
    (starts, ends)."""
    if len(starts) == 0:
        return starts, starts
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], (starts + durs)[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    ends = np.append(run_end[idx[1:] - 1], run_end[-1])
    return s[idx], ends


def by_name(names, durs, n: int = 10):
    """The `n` names with the most device time: [[name, seconds]]."""
    tot = defaultdict(int)
    for name, d in zip(names, durs.tolist()):
        tot[name] += d
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], d / 1e9] for name, d in top]


def clock_offset(names, starts, host_ns: int):
    """Device clock minus host clock, from the marker kernel launched
    right after `host_ns`; None where the marker is not in the trace."""
    for name, s in zip(names, starts.tolist()):
        if MARKER in name:
            return s - host_ns
    return None


def idle_by_span(busy_s, busy_e, window, spans, offset: int,
                 n: int = 10, other: str = "no span") -> list:
    """Idle time of the device inside `window` (device-clock ns), by the
    innermost host span open at each idle gap's middle: [[label,
    seconds]], the `n` largest."""
    lo, hi = window
    keep = (busy_e > lo) & (busy_s < hi)
    s, e = np.clip(busy_s[keep], lo, hi), np.clip(busy_e[keep], lo, hi)
    gs = np.concatenate([[lo], e])
    ge = np.concatenate([s, [hi]])
    ok = ge > gs
    gs, ge = gs[ok], ge[ok]
    mid = (gs + ge) // 2
    label = np.full(len(mid), -1)
    names = sorted({r[0] for r in spans})
    depth_of = np.full(len(mid), -1)
    by_depth = defaultdict(list)
    for name, t0, t1, d in spans:
        by_depth[d].append((t0 + offset, t1 + offset, names.index(name)))
    for d, rows in by_depth.items():
        rows.sort()
        st = np.asarray([r[0] for r in rows], np.int64)
        en = np.asarray([r[1] for r in rows], np.int64)
        lab = np.asarray([r[2] for r in rows])
        i = np.searchsorted(st, mid, side="right") - 1
        inside = (i >= 0) & (en[np.maximum(i, 0)] > mid) & (d > depth_of)
        label[inside] = lab[i[inside]]
        depth_of[inside] = d
    tot = defaultdict(float)
    for lab, g in zip(label.tolist(), (ge - gs).tolist()):
        tot[names[lab] if lab >= 0 else other] += g / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:n]]
