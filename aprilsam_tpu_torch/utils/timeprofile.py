"""Stamp-based profiler — the reference's timeprofile with the same API
surface (reference: common/timeprofile.h:43-118); the port's counterpart of
``aprilsam_tpu/utils/timeprofile.py``.

The reference's profiler is load-bearing, not just observability: the
incremental wall-clock gate reads timeprofile_total_utime to decide batch
fallback (aprilsam.c:557-559).  Here the equivalent role is played by the
solver's step timing; this class serves structured per-stage timing for the
CLI and debugging (pass a tensor as `block_on` to measure device
completion, since CUDA launches are asynchronous).
"""

from __future__ import annotations

import time
from typing import List, Tuple

import torch


class TimeProfile:
    def __init__(self):
        self.stamps: List[Tuple[str, float]] = []
        self.reset()

    def reset(self):
        self.stamps = [("start", time.perf_counter())]

    def stamp(self, name: str, block_on=None):
        """Record a named stamp; optionally wait for the device of a tensor
        first so the interval covers device completion."""
        if block_on is not None and block_on.device.type == "cuda":
            torch.cuda.synchronize(block_on.device)
        self.stamps.append((name, time.perf_counter()))

    def total_ms(self) -> float:
        return (self.stamps[-1][1] - self.stamps[0][1]) * 1e3

    def display(self) -> str:
        out = []
        t0 = self.stamps[0][1]
        prev = t0
        for name, t in self.stamps[1:]:
            out.append(
                f" {len(out):2d} {name:24s} {1e3*(t-prev):9.3f} ms "
                f"{1e3*(t-t0):9.3f} ms"
            )
            prev = t
        return "\n".join(out)

    def __str__(self):
        return self.display()
