"""Solver configuration: the same fields and defaults as
``aprilsam_tpu/solver/config.py``.

Split of the reference's april_graph_cholesky_param_t (reference:
aprilsam.h:230-269): immutable hyper-parameters live here; mutable solver
state (R factor, y, ordering, tree, counters) lives in solver/state.py as
tensors on one device plus host symbolic state.

Defaults match the reference demo exactly: tikhonov 1e-4
(april_graph_cholesky_param_init, aprilsam.c:45-64), delta_xy = 0.1,
delta_theta = 0.1, nthreshold = 100 (examples/aprilsam_demo.c:250-252).

Every setting of the JAX package's configuration runs in the port: the
synchronous per-step path, the lagged policy, supersteps, the windowed
sweep, bundled dispatch and the host, dense and panel batch epochs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import torch_dtype


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

    # --- throughput modes ---
    # Steps by which batch-fallback decisions may lag (the policy stats are
    # read back asynchronously); 0 = synchronous reference semantics.
    policy_lag: int = 0
    # In lagged mode, read the policy stats once per this many due entries
    # (the device counters are cumulative, so the newest entry suffices).
    policy_poll: int = 1
    # Bundled dispatch: consecutive steps of one signature dispatched
    # together (1 = off); full-path bundles cap at bundle_size_full.  Mixed
    # bundles let fast and full steps share one bundle; with
    # coalesce_full_solves a bundle's full steps share one whole-graph
    # sweep at its end.
    bundle_size: int = 1
    bundle_size_full: int = 4
    mixed_bundles: bool = True
    coalesce_full_solves: bool = False
    # Supersteps: buffer this many steps and dispatch them as ONE joint
    # frontal update on the union affected set, then one sweep.  1 = off.
    superstep_size: int = 1
    # Windowed sweep: > 0 = capacity PW of the panel window a superstep
    # refreshes (the union front + fringe panels); a full sweep runs when
    # the window overflows PW and every sweep_full_every-th superstep.
    sweep_window_panels: int = 0
    sweep_full_every: int = 8
    # Only every K-th superstep sweeps; flush() clears the staleness.
    sweep_every_supersteps: int = 1
    # Affected-set buckets of the union front (None = the ladder below);
    # a union beyond the largest takes the batch fallback.
    superstep_buckets: tuple = None
    # Pattern columns a step's rows may hold to ride a mixed bundle (None =
    # row_block_capacity: every plan fits).
    ridx_pack_capacity: int = None

    @property
    def effective_ridx_pack(self) -> int:
        if self.ridx_pack_capacity is None:
            return self.row_block_capacity
        return self.ridx_pack_capacity

    @property
    def effective_superstep_buckets(self) -> tuple:
        if self.superstep_buckets is not None:
            return self.superstep_buckets
        return (64, 128, 256, 384, 1024)

    # Fill-reducing ordering style: "md" = exact minimum degree with lazy
    # re-evaluation (newest-last); "heapmd" = the reference's bucketed heap
    # scheme with the +rowi recency bias (heap_minimum_degree_ordering,
    # aprilsam.c:989-1249).
    ordering: str = "md"

    # --- numerics ---
    dtype: np.dtype = np.float64   # device dtype of the solver state
    gn_iters: int = None           # GN iterations per batch epoch (None => 1)
    # Batch epoch backend: "host" and "auto" = native C float64 (exact
    # reference semantics); "device" = the dense device epoch; "panel" =
    # the panel device epoch (dense where no panel plan fits, host where
    # the dense one would not fit either).
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
        return torch_dtype(self.dtype)

    @property
    def effective_gn_iters(self) -> int:
        if self.gn_iters is not None:
            return self.gn_iters
        return 1
