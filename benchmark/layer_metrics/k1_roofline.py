"""Kernel K1's share of its roofline in %: the least time of every K1
launch of the traced pass (each launch's operations and bytes from its
shape, roofline.py, against the card's published peaks) over K1's device
time, its kernels found by name in the device trace."""

from benchmark.roofline import PEAKS, least_seconds, tri_inv_work


def read(rec: dict):
    peaks = PEAKS.get(rec["device_kind"])
    if peaks is None or not rec["k1_launches"] or rec["k1_device_s"] <= 0:
        return None
    least = 0.0
    for B, N, dtype, count in rec["k1_launches"]:
        least += count * least_seconds(*tri_inv_work(B, N, dtype), dtype,
                                       peaks)[0]
    return 100.0 * least / rec["k1_device_s"]
