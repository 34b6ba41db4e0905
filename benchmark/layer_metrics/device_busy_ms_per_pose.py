"""Device busy ms per pose: the union of the intervals in which an
operation (kernel, copy or set) ran on the card during the traced pass,
over its poses."""


def read(rec: dict):
    return rec["busy_s"] * 1e3 / rec["poses"] if rec["busy_s"] > 0 else None
