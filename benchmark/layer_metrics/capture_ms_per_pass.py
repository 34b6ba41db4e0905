"""Host ms of the CUDA graphs captured inside the traced pass: the graph
cache's capture seconds (GraphCache.by_generation) after the pass less
those before its first pose."""


def read(rec: dict):
    return rec["capture_s"] * 1e3 if rec["captures"] else None
