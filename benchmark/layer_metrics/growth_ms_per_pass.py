"""Host ms of the capacity growths in the traced pass (solver.growths:
each growth's ms, state rebuilt at doubled capacity, every graph
dropped)."""


def read(rec: dict):
    g = rec["growths"]
    return sum(x["ms"] for x in g) if g else None
