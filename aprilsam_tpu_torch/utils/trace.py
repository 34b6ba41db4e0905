"""Device time from a torch.profiler run on the card, by operation, and
host time in named functions."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


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
