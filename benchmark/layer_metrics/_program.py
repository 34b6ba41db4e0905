"""What the program's own span recorder (aprilsam_tpu_torch/utils/trace.py)
kept of the traced pass: rec["program"] where the harness stored it,
else the recorder's collect().  The recorder records while torch.profiler
traces a replay's steps, so after the run it holds the traced pass's
spans; the first reader's collect() is stored in rec for the others.
None where the program has no recorder (a checkout older than it) or it
kept no span."""


def program(rec: dict):
    if "program" not in rec:
        try:
            from aprilsam_tpu_torch.utils import trace
        except ImportError:
            trace = None
        collect = getattr(trace, "collect", None)
        rec["program"] = collect() if collect is not None else None
    p = rec["program"]
    return p if p and p.get("spans") else None
