"""The device's idle share of the traced pass, in %: 1 - busy / the
pass's wall time under tracing.  Tracing lengthens the wall time (the
harness prints the traced and untraced pass seconds beside it), so the
share reads high."""


def read(rec: dict):
    if rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
