"""Poses per second: every pose of every pass over the passes' summed
timed seconds (host clock, each pass ending in the device's finish)."""


def read(run: dict) -> float:
    passes = run["passes"]
    return sum(p["poses"] for p in passes) / sum(p["seconds"] for p in passes)
