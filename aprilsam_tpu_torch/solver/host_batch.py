"""Host (native C) batch epoch.

Counterpart of ``aprilsam_tpu/solver/host_batch.py``: the whole epoch runs
in native float64 on the host (native/sam_native.c) — exactly the
reference's one-Gauss-Newton-step batch (april_graph_cholesky,
aprilsam.c:87-375) — and the resulting block-sparse R, y and states are
written into the device state in place, by one upload and one expansion at
the JAX package's signature (NC, MAXZ): the rows bucketed by 1024, the row
width by expand_maxz.  On the card the expansion replays as one CUDA graph
per signature (utils/cache.py); precompile_expand walks the ladder.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import native
from ..graph import FACTOR_XYT
from ..utils import GraphCache, trace
from .batch import BatchInfo
from .config import SolverConfig
from .state import DeviceState, full
from .symbolic import SymbolicState


def _bucket_up(n: int, step: int, cap: int) -> int:
    return min(cap, max(step, ((n + step - 1) // step) * step))


def expand_maxz(maxnnz: int, BCAP: int) -> int:
    """The R-row width of the epoch's upload: 48 or 96 where they fit
    (few signatures; M3500's final epoch has 48), else BCAP."""
    for b in (48, 96):
        if maxnnz <= b <= BCAP:
            return b
    return BCAP


def _expand_body(ds: DeviceState, P: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Write the post-epoch solver state of the first n = P["ctl"][0]
    nodes, uploaded as [NC, MAXZ] rows, into the device tensors, in place.

    R and y are cleared beyond row n; states of rows beyond n keep their
    values, and the position map is the identity there (nodes appended
    between epochs take position == node id, aprilsam.c:392-397).  The
    chi2 goes to the metric-ring row P["ctl"][1].  With n = 0 (a dead
    payload) nothing changes."""
    NCAP = ds.R_idx.shape[0]
    ctl = P["ctl"]
    NC, MAXZ = P["idx"].shape
    live = ctl[0] > 0
    rows = (torch.arange(NC, device=ds.device) < ctl[0])[:, None]

    for t, fill in ((ds.R_blocks, 0.0), (ds.R_idx, NCAP), (ds.R_nnz, 0),
                    (ds.y, 0.0)):
        t.masked_fill_(live, fill)
    for head, src in ((ds.R_blocks[:NC, :MAXZ], P["blocks"]),
                      (ds.R_idx[:NC, :MAXZ], P["idx"]),
                      (ds.R_nnz[:NC], P["nnz"]), (ds.y[:NC], P["y"])):
        head.copy_(torch.where(live, src, head))
    for name, src in (("state", P["st"]), ("l_point", P["lp"]),
                      ("delta_X", P["dx"])):
        head = getattr(ds, name)[:NC]
        head.copy_(torch.where(rows, src, head))
    ar = torch.arange(NCAP, dtype=torch.int64, device=ds.device)
    for name in ("pos", "order"):
        new = ar.clone()
        new[:NC] = P[name]
        t = getattr(ds, name)
        t.copy_(torch.where(live, new, t))
    ds.relinearized.masked_fill_(live, False)
    ds.start_over.masked_fill_(live, 0)
    ds.spd_ok.masked_fill_(live, True)
    full(ds.chi2_log).index_copy_(0, ctl[1:2], P["chi2"])
    return P["chi2"]


def expand_inputs(ds: DeviceState, cfg: SolverConfig, n: int, blocks, idx,
                  nnz, y, st, lp, dx, pos, order, chi2_val: float,
                  log_mode: int, NC: int = None, MAXZ: int = None):
    """The epoch's result for nodes [0, n) padded to (NC, MAXZ) (by
    default the buckets of n and of the widest row); returns (ints,
    floats, ring pointer after).  log_mode: 0 = append chi2 to the metric
    ring, 1 = overwrite the newest entry (a fallback epoch replaces the
    chi2 of the step that triggered it), 2 = leave the ring alone."""
    NCAP, BCAP = cfg.node_capacity, cfg.row_block_capacity
    NC = NC or _bucket_up(n, 1024, NCAP)
    MAXZ = MAXZ or expand_maxz(int(np.max(nnz, initial=1)), BCAP)
    LOG = ds.chi2_log.shape[0]
    ptr = ds.log_ptr
    log_idx, ptr_after = LOG, ptr
    if log_mode == 0:
        log_idx, ptr_after = (ptr if ptr < LOG else LOG), ptr + 1
    elif log_mode == 1 and 1 <= ptr <= LOG:
        log_idx = ptr - 1

    def pad(a, fill, dtype, width=None):
        a = np.asarray(a)
        shape = (NC,) + ((width,) if width else ()) + a.shape[2 if width
                                                             else 1:]
        out = np.full(shape, fill, dtype=dtype)
        if width:
            out[:n] = a[:, :width]
        else:
            out[:n] = a
        return out

    ar = np.arange(NC, dtype=np.int64)
    pos_c, order_c = ar.copy(), ar.copy()
    pos_c[:n], order_c[:n] = pos, order
    ints = dict(ctl=np.asarray([n, log_idx], dtype=np.int64),
                idx=pad(idx, NCAP, np.int64, MAXZ),
                nnz=pad(nnz, 0, np.int64), pos=pos_c, order=order_c)
    floats = dict(blocks=pad(blocks, 0.0, np.float64, MAXZ),
                  y=pad(y, 0.0, np.float64), st=pad(st, 0.0, np.float64),
                  lp=pad(lp, 0.0, np.float64), dx=pad(dx, 0.0, np.float64),
                  chi2=np.asarray([chi2_val], dtype=np.float64))
    return ints, floats, ptr_after


def expand(ds: DeviceState, ints, floats, graphs: GraphCache) -> None:
    NC, MAXZ = ints["idx"].shape
    graphs.run(("expand", NC, MAXZ), ds, ints, floats,
               lambda P: _expand_body(ds, P))


def precompile_expand(ds: DeviceState, cfg: SolverConfig, nnodes_max: int,
                      graphs: GraphCache) -> int:
    """Drive every (NC, MAXZ) expansion signature a replay of nnodes_max
    poses can hit with dead payloads (n = 0), as the JAX package compiles
    them: on the card each one's graph is captured into `graphs` on `ds`, which the dead payloads leave as it was.  (The JAX
    package's log_mode axis is an input here, not a signature.)  Returns
    the number of signatures."""
    NCAP = cfg.node_capacity
    BCAP = cfg.row_block_capacity
    nc_top = _bucket_up(nnodes_max or NCAP, 1024, NCAP)
    ncs = []
    nc = 1024
    while True:
        ncs.append(min(nc, NCAP))
        if nc >= nc_top:
            break
        nc += 1024
    count = 0
    z = np.zeros(0, dtype=np.int64)
    for NC in dict.fromkeys(ncs):
        for MAXZ in sorted({expand_maxz(1, BCAP), expand_maxz(49, BCAP)}):
            f3 = np.zeros((0, 3))
            ints, floats, _p = expand_inputs(
                ds, cfg, 0, np.zeros((0, MAXZ, 3, 3)), np.zeros((0, MAXZ)),
                z, f3, f3, f3, f3, z, z, 0.0, 2, NC=NC, MAXZ=MAXZ)
            expand(ds, ints, floats, graphs)
            count += 1
    if ds.device.type == "cuda":
        torch.cuda.synchronize(ds.device)
    return count


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


def native_symbolic(cfg: SolverConfig, nnodes: int, ftypes, fnodes):
    """The epoch's symbolic phase in native C: the fill-reducing ordering,
    then the block patterns and etree.  Returns (order, patterns [n, BCAP],
    nnz [n], parents [n])."""
    adj_ptr, adj_idx = _adjacency_csr(nnodes, ftypes, fnodes)
    order = native.order_md(nnodes, adj_ptr, adj_idx, style=cfg.ordering)
    patterns, nnz, parents, _maxnnz = native.symbolic(
        nnodes, adj_ptr, adj_idx, order, cfg.row_block_capacity)
    return order, patterns, nnz, parents


def host_batch_epoch(
    ds: DeviceState,
    cfg: SolverConfig,
    nnodes: int,
    ftypes: np.ndarray,
    fnodes: np.ndarray,
    fz: np.ndarray,
    fW: np.ndarray,
    log_mode: int = 0,
    *,
    graphs: GraphCache,
) -> Tuple[DeviceState, SymbolicState, BatchInfo]:
    NCAP = cfg.node_capacity
    BCAP = cfg.row_block_capacity

    with trace.span("epoch.symbolic"):
        order, patterns, nnz, parents = native_symbolic(cfg, nnodes, ftypes,
                                                        fnodes)

    # current states come from the device (one read; batches are rare)
    with trace.span("epoch.state_read"):
        states = ds.state[:nnodes].cpu().numpy().astype(np.float64)

    m_xyt = ftypes == FACTOR_XYT
    cur = states
    with trace.span("epoch.solve"):
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
    with trace.span("epoch.mirror"):
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
    with trace.span("epoch.expand"):
        idx = patterns.astype(np.int64)
        idx[idx >= nnodes] = NCAP
        ints, floats, ptr_after = expand_inputs(
            ds, cfg, nnodes, blocks, idx, nnz, y.reshape(nnodes, 3),
            new_states, states, delta, pos, order, chi2, log_mode)
        expand(ds, ints, floats, graphs)
    ds.log_ptr = ptr_after
    return ds, sym, BatchInfo(chi2=chi2, spd=spd, n=nnodes)
