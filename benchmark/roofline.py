"""The yardstick of the kernels' roofline shares: the cards' published
peaks, and the work of each hand-written kernel counted from its shapes.

Peaks (NVIDIA's data sheets, dense rates, at the card's full power limit;
keyed by the exact name ``torch.cuda.get_device_name`` gives): memory
bytes/s, and the float64 (FP64 tensor core) and float32 (outside the
tensor cores) operation rates.  A share against them is a lower bound on
what the kernel reaches at the card's own power limit, which the harness
prints beside it.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "float64": 67e12,
                              "float32": 67e12},
}

# the names of K1's two kernels (diagonal tiles, column strips) as the
# device trace shows them; aprilsam_tpu_torch/csrc/tri_inv.cu
K1_KERNELS = ("diag_kernel", "strip_kernel")

ELT_BYTES = {"float64": 8, "float32": 4}


def tri_inv_work(B: int, N: int, dtype: str):
    """Operations and bytes of X = T^-1 for T [B, N, N] upper triangular:
    2 (N-1) N (N+1) / 6 floating-point operations (two to a multiply-add:
    about N^3 / 3) and N (N+1) / 2 divisions per matrix (no early exit:
    the work does not depend on the data); the upper
    triangle of T read once and all of X written once."""
    ops = B * (2 * (N - 1) * N * (N + 1) // 6 + N * (N + 1) // 2)
    nbytes = B * (N * (N + 1) // 2 + N * N) * ELT_BYTES[dtype]
    return ops, nbytes


def least_seconds(ops: int, nbytes: int, dtype: str, peaks: dict):
    """The least time the card could take, and what bounds it."""
    t_ops = ops / peaks[dtype]
    t_bytes = nbytes / peaks["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
