"""The port's spans and counters, device time from a torch.profiler run on
the card by operation, and host time in named functions.

Spans and counters (`span`, `count`, `enable`, `disable`, `collect`) are
recorded where the work happens, at host boundaries: never inside a body
that a CUDA graph captures, which runs once at capture and never on a
replay.  Off by default: `span` then returns one shared no-op object,
reading no clock and allocating nothing, and `count` returns; each costs
the test of the module flag `ON`.  Recording is on while `enable()`
holds it on, and while a torch.profiler session runs (`follow_profiler`,
called where a replay's step starts; a span opened after the session
ended turns it off), so that a profiled replay's spans can be placed on
its device trace.  What a profiled replay recorded stays in memory until
`collect()` (the benchmark's readers of the program's spans collect it
after the traced pass), or until a profiled step that follows steps
run without the profiler drops it: what is held is at most one profiled
stretch of steps.  A span keeps its name, its start and end on
`time.perf_counter_ns()` (the clock against which a marker kernel
launched right after a synchronize places the host on the device's
clock), the index of its parent span and the step it belongs to: the
pose index the replay is adding when the span opens.  Records stay in
memory until `collect()` hands them out.  One host thread records.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch.autograd.profiler as _profiler

ON = False        # whether spans and counts record
_held = False     # enable() holds recording on (else it follows the profiler)
# the spans in the order they opened, a column each (plain lists of
# strings and ints: recording allocates no object for the collector to
# walk): name, start ns, end ns (0 while open), parent index (-1: none),
# step
_name, _start, _end, _parent, _steps = [], [], [], [], []
_counts = defaultdict(int)
_open = -1        # index of the innermost open span
_step = -1        # the step the spans opened now belong to


class _Noop:
    """The span of a disabled recorder.  Its __enter__ and __exit__ are a
    function written in C that takes any arguments and returns "", which
    is false, so an exception raised in the block passes on: entering and
    leaving a disabled span runs no Python code (half the cost of two
    Python methods)."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


class _Close:
    """Ends the innermost open span on exit."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, t, v, tb):
        global _open
        if _open >= 0:                 # not handed out by collect() since
            _end[_open] = time.perf_counter_ns()
            _open = _parent[_open]
        return None


NOOP = _Noop()
_CLOSE = _Close()


def span(name: str, step: int = None):
    """A context manager timing the block as the span `name`, a child of
    the innermost open span.  `step` starts a step: this span and every
    span opened after it, until the next step, belong to that step."""
    global _open, _step, ON
    if not ON:
        return NOOP
    if not _held and not _profiler._is_profiler_enabled:
        ON = False                     # the profiler session it followed ended
        return NOOP
    if step is not None:
        _step = step
    _name.append(name)
    _parent.append(_open)
    _steps.append(_step)
    _end.append(0)
    _open = len(_name) - 1
    _start.append(time.perf_counter_ns())
    return _CLOSE


def count(name: str, n: int = 1) -> None:
    """Add `n` to the recorder's counter `name`."""
    if ON:
        _counts[name] += n


def follow_profiler() -> None:
    """Record while a torch.profiler session runs, unless enable() holds
    recording on; called where a step starts.  A profiled step that follows
    one run without the profiler drops what was recorded before it and
    not collected."""
    global ON
    if not _held:
        on = _profiler._is_profiler_enabled
        if on and not ON:
            _clear()
        ON = on


def enable() -> None:
    """Record until disable()."""
    global ON, _held
    ON = _held = True


def disable() -> None:
    """Stop recording; what was recorded waits for collect()."""
    global ON, _held
    ON = _held = False


def _clear() -> None:
    global _open
    for col in (_name, _start, _end, _parent, _steps, _counts):
        col.clear()
    _open = -1


def collect(solver=None) -> dict:
    """Hand out what was recorded since the last collect and start anew
    (call it outside any span).  Returns "spans": {name: {"ms",
    "self_ms", "calls"}} over the closed spans, self ms being the span's
    time less the time its child spans cover; "records": [(name, start
    ns, end ns, parent, step)], parent an index into records or -1; and
    "counters": the recorder's, and where `solver` (an IncrementalSolver)
    is given, its counters ("solver." + name), its graph cache's
    dispatches, replays and captures ("graphs.calls", "graphs.replayed",
    "graphs.captures") and the frontal update's: the live columns of its
    dispatches ("frontal.live_columns"), K2's launches since its
    reset_launches() ("frontal.launches"), by shape
    ("frontal.launches.<3M>x<p>.<dtype>") and the columns they cover
    ("frontal.padded_columns": launches times 3M), read where they are
    kept."""
    recs = list(zip(_name, _start, _end, _parent, _steps))
    counts = dict(_counts)
    _clear()
    covered = [0] * len(recs)
    for _n, t0, t1, parent, _s in recs:
        if parent >= 0 and t1:
            covered[parent] += t1 - t0
    spans = {}
    for (name, t0, t1, _p, _s), c in zip(recs, covered):
        if not t1:
            continue
        s = spans.setdefault(name, {"ms": 0.0, "self_ms": 0.0, "calls": 0})
        s["ms"] += (t1 - t0) / 1e6
        s["self_ms"] += (t1 - t0 - c) / 1e6
        s["calls"] += 1
    counters = counts
    if solver is not None:
        counters.update({"solver." + k: v for k, v in solver.counters.items()})
        g = solver.graphs
        counters.update({"graphs.calls": sum(g.calls.values()),
                         "graphs.replayed": g.replays,
                         "graphs.captures": g.captures})
        from ..kernels import frontal_qr
        by_shape = frontal_qr.launches_by_shape
        counters.update({
            "frontal.live_columns": solver.counters["frontal_live_columns"],
            "frontal.launches": frontal_qr.launches,
            "frontal.padded_columns": sum(n * c for (n, _p, _d), c
                                          in by_shape.items())})
        counters.update({f"frontal.launches.{n}x{p}.{d}": c
                         for (n, p, d), c in sorted(by_shape.items())})
    return {"spans": spans, "records": recs, "counters": counters}


def lines(collected: dict) -> list:
    """collect()'s spans as lines: name, ms and self ms, in the order each
    name first opened; then its counters, `stats.waits` as the share of
    the stats reads (`solver.stats_wait` spans) that waited."""
    first = {}
    for i, r in enumerate(collected["records"]):
        first.setdefault(r[0], i)
    spans = collected["spans"]
    out = [f"   {n:20s} {spans[n]['ms']:9.3f} ms {spans[n]['self_ms']:9.3f} "
           f"ms self" for n in sorted(spans, key=first.get)]
    for n, v in sorted(collected["counters"].items()):
        if n == "stats.waits":
            reads = spans.get("solver.stats_wait", {}).get("calls", 0)
            out.append(f"   {n:20s} {v} of {reads} stats reads waited")
        else:
            out.append(f"   {n:20s} {v}")
    return out


@contextlib.contextmanager
def host_clock(targets):
    """While the block runs, every call of each (owner, attribute) function
    of `targets` (a module's function, a class's method) is timed on the
    host clock.  Yields {attribute less its leading underscores: [ms,
    calls]}.  The callers must look the attribute up at call time, as a
    module global or a method is; the originals are restored on exit."""
    spent = defaultdict(lambda: [0.0, 0])

    def timed(key, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[key][0] += (time.perf_counter() - t) * 1e3
                spent[key][1] += 1
        return run

    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]
    for obj, name, fn in saved:
        setattr(obj, name, timed(name.lstrip("_"), fn))
    try:
        yield spent
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def device_rows(prof) -> list:
    """(name, device µs, count) of every device-side record of `prof`
    (kernels, copies, sets), summed by name, largest first.  Read from the
    profiler's raw records, so a replay of many thousand kernels costs no
    per-event Python objects; each record counts once."""
    from torch.autograd import DeviceType

    rows = {}
    for k in prof.profiler.kineto_results.events():
        if k.device_type() != DeviceType.CUDA:
            continue
        r = rows.setdefault(k.name(), [0.0, 0])
        r[0] += k.duration_ns() / 1e3
        r[1] += 1
    if not rows:
        raise RuntimeError("the profiler recorded no device-side rows")
    return sorted(((n, us, c) for n, (us, c) in rows.items() if us > 0),
                  key=lambda r: -r[1])


def top(dev, n: int = 10) -> list:
    """The `n` largest rows of device_rows, in ms."""
    return [{"op": k[:80], "ms": us / 1e3, "count": c}
            for k, us, c in dev[:n]]
