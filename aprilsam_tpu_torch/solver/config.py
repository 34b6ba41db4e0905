"""Solver configuration: the same fields and defaults as
``aprilsam_tpu/solver/config.py``.

Split of the reference's april_graph_cholesky_param_t (reference:
aprilsam.h:230-269): immutable hyper-parameters live here; mutable solver
state (R factor, y, ordering, tree, counters) lives in solver/state.py as
tensors on one device plus host symbolic state.

Defaults match the reference demo exactly: tikhonov 1e-4
(april_graph_cholesky_param_init, aprilsam.c:45-64), delta_xy = 0.1,
delta_theta = 0.1, nthreshold = 100 (examples/aprilsam_demo.c:250-252).

The port runs the synchronous per-step path.  The throughput settings of the
JAX package (policy_lag, bundle_size, superstep_size, sweep_window_panels,
coalesce_full_solves) and the device batch backends keep their fields here
so configurations carry across unchanged, but ``unported_settings`` names
them and the solvers raise ``NotImplementedError`` on any of them.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    # --- policy thresholds (reference semantics) ---
    delta_xy: float = 0.1        # relinearization |dx|,|dy| threshold
    delta_theta: float = 0.1     # relinearization |dtheta| threshold
    nthreshold: int = 100        # batch fallback when start_over exceeds this
    tikhonov: float = 1e-4       # diagonal damping, batch assembly only
    # Incremental steps slower than batch_time/3 force a batch
    # (aprilsam.c:557-559); naffected <= small_path_max takes the pruned
    # fast path (aprilsam.c:755-772 "naffected <= 5").
    batch_time_fraction: float = 1.0 / 3.0
    small_path_max: int = 5
    # Disable for deterministic runs (differential tests): the reference's
    # wall-clock gate makes the incremental trajectory machine-dependent.
    wallclock_gate: bool = True

    # --- throughput modes of the JAX package (not ported yet) ---
    policy_lag: int = 0
    policy_poll: int = 1
    bundle_size: int = 1
    bundle_size_full: int = 4
    mixed_bundles: bool = True
    coalesce_full_solves: bool = False
    superstep_size: int = 1
    sweep_window_panels: int = 0
    sweep_full_every: int = 8
    sweep_every_supersteps: int = 1
    superstep_buckets: tuple = None
    ridx_pack_capacity: int = None

    # Fill-reducing ordering style: "md" = exact minimum degree with lazy
    # re-evaluation (newest-last); "heapmd" = the reference's bucketed heap
    # scheme with the +rowi recency bias (heap_minimum_degree_ordering,
    # aprilsam.c:989-1249).
    ordering: str = "md"

    # --- numerics ---
    dtype: np.dtype = np.float64   # device dtype of the solver state
    gn_iters: int = None           # GN iterations per batch epoch (None => 1)
    # Batch epoch backend: "host" and "auto" = native C float64 (exact
    # reference semantics); "device"/"panel" are not ported yet.
    batch_backend: str = "auto"
    check_spd: bool = True         # batch fallback on a non-SPD frontal
                                   # (fixes the reference's ignored is_spd
                                   # flag, smatd.c:669-699)
    log_chi2: bool = True          # per-step chi2 into the metric ring

    # --- capacities ---
    node_capacity: int = 4096      # max nodes before reallocation
    factor_capacity: int = 8192    # max factors
    row_block_capacity: int = 96   # max 3x3 blocks per R row (fill headroom)
    new_factor_capacity: int = 16  # max new factors per incremental step
    # Affected-set buckets: a step whose affected set exceeds the largest
    # takes the batch fallback, as in the JAX package.
    frontal_buckets: tuple = (16, 64, 256, 1024)
    panel_nodes: int = 128         # nodes per triangular-solve panel
    # Capacity of the per-step chi2 ring.  None => 2x node_capacity.
    metric_log_capacity: int = None

    @property
    def effective_log_capacity(self) -> int:
        if self.metric_log_capacity is not None:
            return self.metric_log_capacity
        return 2 * self.node_capacity

    show_timing: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return {np.dtype(np.float64): torch.float64,
                np.dtype(np.float32): torch.float32}[np.dtype(self.dtype)]

    @property
    def effective_gn_iters(self) -> int:
        if self.gn_iters is not None:
            return self.gn_iters
        return 1

    def unported_settings(self) -> List[str]:
        """Settings of the JAX package's throughput modes and device batch
        epochs, which later slices of the port bring over."""
        out = []
        if self.policy_lag > 0:
            out.append("policy_lag>0 (deferred policy)")
        if self.bundle_size > 1:
            out.append("bundle_size>1 (bundled dispatch)")
        if self.superstep_size > 1:
            out.append("superstep_size>1 (supersteps)")
        if self.sweep_window_panels > 0:
            out.append("sweep_window_panels>0 (windowed sweep)")
        if self.coalesce_full_solves:
            out.append("coalesce_full_solves (bundled dispatch)")
        if self.batch_backend in ("device", "panel"):
            out.append(f"batch_backend={self.batch_backend!r} "
                       "(device batch epochs)")
        return out

    def check_ported(self) -> None:
        bad = self.unported_settings()
        if bad:
            raise NotImplementedError(
                "not ported to aprilsam_tpu_torch yet: " + ", ".join(bad)
                + "; the throughput modes and the device batch epochs come "
                "in later slices of the port (ROADMAP.md queue 1)")
