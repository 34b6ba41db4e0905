"""Host ms of a graph-cache dispatch that replays a captured graph: the
traced pass's graphs.dispatch spans that hold a graphs.replay span (their
own time, the input upload and the replay's launch), over the replays."""

from benchmark.layer_metrics._program import program


def read(rec: dict):
    p = program(rec)
    if p is None:
        return None
    recs = p["records"]
    hits = {r[3] for r in recs if r[0] == "graphs.replay"}
    if not hits:
        return None
    return sum(recs[i][2] - recs[i][1] for i in hits) / 1e6 / len(hits)
