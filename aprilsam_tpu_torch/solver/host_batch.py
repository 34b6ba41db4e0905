"""Host (native C) batch epoch.

Counterpart of ``aprilsam_tpu/solver/host_batch.py``: the whole epoch runs
in native float64 on the host (native/sam_native.c) — exactly the
reference's one-Gauss-Newton-step batch (april_graph_cholesky,
aprilsam.c:87-375) — and the resulting block-sparse R, y and states are
written into the device state in place.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import native
from ..graph import FACTOR_XYT
from .batch import BatchInfo
from .config import SolverConfig
from .state import DeviceState
from .symbolic import SymbolicState


def _expand_batch_state(ds: DeviceState, blocks, idx, nnz, y, st, lp, dx,
                        pos, order, chi2_val: float,
                        log_mode: int) -> DeviceState:
    """Write the post-epoch solver state of the first n = len(nnz) nodes
    into the device tensors, in place.

    R and y are cleared beyond row n; states of rows beyond n keep their
    values, and the position map is the identity there (nodes appended
    between epochs take position == node id, aprilsam.c:392-397).  log_mode:
    0 = append chi2 to the metric ring, 1 = overwrite the newest entry (a
    fallback epoch replaces the chi2 of the step that triggered it), 2 =
    leave the ring alone."""
    NCAP = ds.R_idx.shape[0]
    n = len(nnz)
    dev, dt = ds.device, ds.R_blocks.dtype
    t = lambda a, d=dt: torch.as_tensor(np.ascontiguousarray(a), device=dev,
                                        dtype=d)
    ds.R_blocks.zero_()
    ds.R_blocks[:n] = t(blocks)
    ds.R_idx[:n] = t(idx, torch.int64)
    ds.R_idx[n:] = NCAP
    ds.R_nnz.zero_()
    ds.R_nnz[:n] = t(nnz, torch.int64)
    ds.y.zero_()
    ds.y[:n] = t(y)
    ds.state[:n] = t(st)
    ds.l_point[:n] = t(lp)
    ds.delta_X[:n] = t(dx)
    ar = torch.arange(NCAP, dtype=torch.int64, device=dev)
    ds.pos.copy_(ar)
    ds.pos[:n] = t(pos, torch.int64)
    ds.order.copy_(ar)
    ds.order[:n] = t(order, torch.int64)
    ds.relinearized.zero_()
    ds.start_over.zero_()
    ds.spd_ok.fill_(True)

    LOG = ds.chi2_log.shape[0]
    if log_mode == 0:
        if ds.log_ptr < LOG:
            ds.chi2_log[ds.log_ptr] = chi2_val
        ds.log_ptr += 1
    elif log_mode == 1:
        if 1 <= ds.log_ptr <= LOG:
            ds.chi2_log[ds.log_ptr - 1] = chi2_val
    return ds


def _adjacency_csr(nnodes: int, ftypes, fnodes) -> Tuple[np.ndarray, np.ndarray]:
    m = ftypes == FACTOR_XYT
    a = fnodes[m, 0].astype(np.int64)
    b = fnodes[m, 1].astype(np.int64)
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    ptr = np.zeros(nnodes + 1, dtype=np.int32)
    np.add.at(ptr, src + 1, 1)
    ptr = np.cumsum(ptr).astype(np.int32)
    return ptr, dst.astype(np.int32)


def host_batch_epoch(
    ds: DeviceState,
    cfg: SolverConfig,
    nnodes: int,
    ftypes: np.ndarray,
    fnodes: np.ndarray,
    fz: np.ndarray,
    fW: np.ndarray,
    log_mode: int = 0,
) -> Tuple[DeviceState, SymbolicState, BatchInfo]:
    NCAP = cfg.node_capacity
    BCAP = cfg.row_block_capacity

    adj_ptr, adj_idx = _adjacency_csr(nnodes, ftypes, fnodes)
    order = native.order_md(nnodes, adj_ptr, adj_idx, style=cfg.ordering)
    patterns, nnz, parents, _maxnnz = native.symbolic(
        nnodes, adj_ptr, adj_idx, order, BCAP)

    # current states come from the device (one read; batches are rare)
    states = ds.state[:nnodes].cpu().numpy().astype(np.float64)

    m_xyt = ftypes == FACTOR_XYT
    cur = states
    for _ in range(max(1, cfg.effective_gn_iters)):
        blocks, y, x, new_states, delta, chi2, spd = native.batch_solve(
            nnodes, cur,
            fnodes[m_xyt, 0], fnodes[m_xyt, 1], fz[m_xyt], fW[m_xyt],
            fnodes[~m_xyt, 0], fz[~m_xyt], fW[~m_xyt],
            order, BCAP, patterns, nnz, cfg.tikhonov,
        )
        states = cur  # linearization points of the final iteration
        cur = new_states

    # the SymbolicState mirror for the incremental engine
    pos = np.empty(nnodes, dtype=np.int32)
    pos[order] = np.arange(nnodes, dtype=np.int32)
    sym = SymbolicState(
        order=order, pos=pos,
        patterns=[patterns[p, : nnz[p]].copy() for p in range(nnodes)],
        parents=parents.copy(),
    )
    sym.rebuild_children()

    # pattern padding (>= nnodes) becomes the device sentinel NCAP.  The
    # stored linearization points are the pre-update states: relinearize-
    # all happened BEFORE the solve (aprilsam.c:131-135), and R/y are
    # consistent with them.
    idx = patterns.astype(np.int64)
    idx[idx >= nnodes] = NCAP
    ds = _expand_batch_state(ds, blocks, idx, nnz, y.reshape(nnodes, 3),
                             new_states, states, delta, pos, order, chi2,
                             log_mode=log_mode)
    return ds, sym, BatchInfo(chi2=chi2, spd=spd, n=nnodes)
