"""Host ms of a batch epoch's symbolic phase (the native ordering, the
block patterns and etree, and the device epochs' padded planner mirror):
the traced pass's epoch.symbolic spans over its epochs."""

from benchmark.layer_metrics._program import program


def read(rec: dict):
    p = program(rec)
    sym = p and p["spans"].get("epoch.symbolic")
    epochs = rec["counters"].get("batch", 0)
    return sym["ms"] / epochs if sym and epochs else None
