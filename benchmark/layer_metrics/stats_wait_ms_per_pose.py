"""Host ms waiting on the device for the policy's stats, per pose: the
traced pass's solver.stats_wait spans (the lag-0 stats read of a step,
and a deferred read that synchronizes on its copy) over its poses."""

from benchmark.layer_metrics._program import program


def read(rec: dict):
    p = program(rec)
    wait = p and p["spans"].get("solver.stats_wait")
    return wait["ms"] / rec["poses"] if wait else None
