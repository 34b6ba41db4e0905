"""Host planning ms per pose: the traced pass's time in
solver/incremental.py:plan_step (native asn_plan_step), over its poses."""


def read(rec: dict):
    ms, calls = rec["spans"].get("planning", (0.0, 0))
    return ms / rec["poses"] if calls else None
