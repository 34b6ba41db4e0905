"""Device and precision set-up shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch

from .timeprofile import TimeProfile


def setup_precision() -> None:
    """Keep float32 products in full float32 on the card.

    Counterpart of ``aprilsam_tpu/utils/cache.py:setup_precision``: reduced-
    precision operands made the assembled normal equations indefinite on the
    TPU (DESIGN.md section 3).  The H100's analogue is TF32, which keeps about
    three decimal digits, so it is off for matmul and for cuDNN.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """The solver's device.  A CUDA device must exist: the port never drops
    to the CPU on its own; callers that want the CPU ask for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy float dtype (float32 or float64)."""
    return {np.dtype(np.float64): torch.float64,
            np.dtype(np.float32): torch.float32}[np.dtype(dtype)]


__all__ = ["TimeProfile", "resolve_device", "setup_precision", "torch_dtype"]
