"""Hybrid incremental/batch solver — the AprilSAM algorithm, synchronous
per-step mode.

Counterpart of the synchronous subset of ``aprilsam_tpu/solver/
incremental.py`` (reference: april_graph_cholesky_inc, aprilsam.c:377-576).
The algebra is the JAX package's.  Two structural facts make the affected
submatrix self-contained: row p of R has nonzeros only at etree ancestors of
p, and the affected set F (paths from the touched nodes to the root,
aprilsam.c:482-498) is ancestor-closed.  The reference's reconstruct ->
add -> refactor cycle therefore collapses into one dense frontal QR:

      qr([R_F ; W^{1/2} J_new])  ->  R_F',   y_F' = Q^T [y_F ; W^{1/2} r]

Then either the fast path (naffected <= small_path_max: x_F = R_F'^{-1}
y_F', plus relinearization bookkeeping on the fringe, the reference's pruned
descent) or the full path (a panel-blocked back-substitution over the whole
block-sparse R through kernels/sweep.py:panel_backsub, whose panel
inverses run in the CUDA kernel K1 on the card).  Then the batch-fallback
policy (aprilsam.c:557-575).

How the port differs from the JAX package, with the algebra unchanged:
  * the host plan (StepPlan) carries numpy arrays, uploaded as tensors;
    there is no packed int32 plan vector;
  * tensors are sized to the step (m affected rows, the step's factors)
    instead of padded to static buckets, and the JAX package's one-hot
    einsums are index ops; the frontal buckets survive only as the
    affected-set limit that sends a step to the batch fallback;
  * the solver state is updated in place.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..geometry import mod2pi, xyt_inv, xyt_mul
from ..graph import FactorGraph, FACTOR_XYT
from ..factors import eval_xyt, eval_xytpos
from ..kernels.linalg3 import chol3, solve_upper3
from ..kernels.sweep import panel_backsub
from ..utils import resolve_device, setup_precision
from ..utils.timeprofile import TimeProfile
from .batch import BatchInfo
from .config import SolverConfig
from .ingest import ingest_graph
from .state import (DeviceState, init_device_state, state_chi2,
                    state_from_numpy, state_to_numpy)
from . import symbolic as sym_mod
from .symbolic import SymbolicState

INT_MAX = np.iinfo(np.int32).max

KNODE = 4   # max new nodes per step
KSEED = 4   # max odometry seedings per step
# Fringe width of a fast step: a larger fringe takes the full path instead
# (an exact, un-pruned solve), as in the JAX package.
MIXED_FR = 32
FRCAP = 128  # fringe capacity handed to the native planner


@dataclass
class SeedSpec:
    """Odometry seeding of a new node's state: dst = src (+) z, or
    dst = src (+) inv(z) when invert (aprilsam_demo.c:180-191)."""

    src: int
    dst: int
    z: np.ndarray
    invert: bool


# ======================================================================
# host step planning
# ======================================================================

@dataclass
class StepTail:
    """A step's new nodes, odometry seeds and factors (host arrays)."""

    node_ids: np.ndarray      # [k] new node ids
    node_states: np.ndarray   # [k, 3] their initial states
    seed_src: np.ndarray      # [s] (deduplicated, last wins per dst)
    seed_dst: np.ndarray      # [s]
    seed_inv: np.ndarray      # [s] bool
    seed_z: np.ndarray        # [s, 3]
    nf_a: np.ndarray          # [kx] new xyt factors
    nf_b: np.ndarray
    nf_z: np.ndarray          # [kx, 3]
    nf_W: np.ndarray          # [kx, 3, 3]
    np_node: np.ndarray       # [kp] new xytpos factors
    np_z: np.ndarray
    np_W: np.ndarray


@dataclass
class StepPlan:
    m: int                    # affected rows (incl. new nodes)
    naffected: int            # affected rows excluding new nodes
    fringe_overflow: bool
    tail: StepTail
    F_pos: np.ndarray         # [m] affected positions, ascending
    F_node: np.ndarray        # [m] their node ids
    new_ridx: np.ndarray      # [m, BCAP] new pattern rows (pad = NCAP)
    new_nnz: np.ndarray       # [m]
    nf_a_slot: np.ndarray     # [kx] front slot of each xyt endpoint
    nf_b_slot: np.ndarray
    np_slot: np.ndarray       # [kp]
    fringe_pos: np.ndarray    # [nfr] fast steps only (empty on full)
    fringe_node: np.ndarray


def _bucket(n: int, buckets) -> Optional[int]:
    for b in buckets:
        if n <= b:
            return b
    return None


def _padded_rows(patterns: List[np.ndarray], rows: np.ndarray, BCAP: int,
                 sentinel: int):
    out = np.full((len(rows), BCAP), sentinel, dtype=np.int32)
    nnz = np.zeros(len(rows), dtype=np.int32)
    for i, p in enumerate(rows):
        pat = patterns[p]
        if len(pat) > BCAP:
            raise OverflowError("row_block_capacity exceeded")
        out[i, : len(pat)] = pat
        nnz[i] = len(pat)
    return out, nnz


def _dedup_seeds(seeds: Sequence[SeedSpec]) -> List[SeedSpec]:
    """Last wins per destination (the reference applies seeds in factor
    order, aprilsam_demo.c:180-191; the device applies them as one
    vectorized scatter)."""
    by_dst = {}
    for s in seeds:
        by_dst[s.dst] = s
    return list(by_dst.values())


def step_tail(g: FactorGraph, f0: int, f1: int, new_ids: Sequence[int],
              seeds: Sequence[SeedSpec]) -> StepTail:
    """The step's ingestion payload: nodes [new_ids], factors [f0, f1) split
    by type in table order, and deduplicated seeds."""
    fn = g.fnodes[f0:f1]
    mx = g.ftype[f0:f1] == FACTOR_XYT
    fz, fW = g.fz[f0:f1], g.fW[f0:f1]
    ids = np.asarray(new_ids, dtype=np.int64)
    return StepTail(
        node_ids=ids,
        node_states=g.state[ids].copy(),
        seed_src=np.asarray([s.src for s in seeds], dtype=np.int64),
        seed_dst=np.asarray([s.dst for s in seeds], dtype=np.int64),
        seed_inv=np.asarray([bool(s.invert) for s in seeds], dtype=bool),
        seed_z=np.asarray([s.z for s in seeds],
                          dtype=np.float64).reshape(-1, 3),
        nf_a=fn[mx, 0].astype(np.int64), nf_b=fn[mx, 1].astype(np.int64),
        nf_z=fz[mx].copy(), nf_W=fW[mx].copy(),
        np_node=fn[~mx, 0].astype(np.int64),
        np_z=fz[~mx].copy(), np_W=fW[~mx].copy(),
    )


def _ensure_native_sym(sym: SymbolicState, NCAP: int, BCAP: int) -> None:
    """Attach the padded planner mirror (pad_idx/pad_nnz, visit stamps and
    child lists of the parent array) to a fresh post-batch SymbolicState."""
    if getattr(sym, "pad_idx", None) is None:
        idx, nnz = sym_mod.padded_pattern_arrays(sym, NCAP, BCAP, NCAP)
        sym.pad_idx = idx
        sym.pad_nnz = nnz
        sym.patterns_stale = False
    if getattr(sym, "mark", None) is None or sym.mark.shape[0] != NCAP:
        sym.mark = np.zeros(NCAP, dtype=np.int32)
        sym.token = np.zeros(1, dtype=np.int32)
        kid_head = np.full(NCAP, -1, dtype=np.int32)
        kid_next = np.full(NCAP, -1, dtype=np.int32)
        kid_prev = np.full(NCAP, -1, dtype=np.int32)
        for c in range(sym.nnodes):
            p = int(sym.parents[c])
            if p < 0:
                continue
            h = kid_head[p]
            kid_next[c] = h
            if h >= 0:
                kid_prev[h] = c
            kid_head[p] = c
        sym.kid_head = kid_head
        sym.kid_next = kid_next
        sym.kid_prev = kid_prev


def sym_patterns_list(sym: SymbolicState) -> List[np.ndarray]:
    """Per-row patterns, read from the native pad arrays when the python
    list has gone stale (the native planner mutates only the pads)."""
    if getattr(sym, "patterns_stale", False):
        return [sym.pad_idx[p, : sym.pad_nnz[p]].copy()
                for p in range(sym.nnodes)]
    return sym.patterns


def plan_step(
    sym: SymbolicState,
    cfg: SolverConfig,
    g: FactorGraph,
    f0: int,
    f1: int,
    n_old: int,
    seeds: Sequence[SeedSpec],
    python_planner: bool = False,
) -> Optional[StepPlan]:
    """Host symbolic work for one incremental step: extend the ordering,
    find the affected set, merge the new factor edges into its row
    patterns, and find the fringe.  Returns None when the affected set
    exceeds the largest frontal bucket (the caller falls back to a batch
    epoch).  `python_planner` runs the pure-python planner instead of the
    native one (the two give identical plans)."""
    NCAP = cfg.node_capacity
    BCAP = cfg.row_block_capacity
    K = cfg.new_factor_capacity
    buckets = cfg.frontal_buckets

    # 1. extend ordering with new nodes (aprilsam.c:392-397)
    new_ids = list(range(n_old, g.nnodes))
    seeds = _dedup_seeds(seeds)
    # seeds apply in ONE vectorized hop (gather src after node ingestion,
    # scatter dst): a src that is itself seeded would read its pre-seed
    # state.  Per-step seeds always come from pre-existing nodes.
    dsts = {s.dst for s in seeds}
    if any(s.src in dsts for s in seeds):
        raise ValueError("seed chains: a seed source is also seeded")
    if len(new_ids) > KNODE or len(seeds) > KSEED:
        raise OverflowError("too many new nodes/seeds in one step")
    sym_mod.append_nodes(sym, new_ids)

    if not python_planner:
        # ---- native planner: one C call does the affected walk, pattern
        # merge, parent re-derivation and fringe scan on the padded arrays
        from .. import native

        _ensure_native_sym(sym, NCAP, BCAP)
        for i in new_ids:
            p = int(sym.pos[i])
            sym.pad_idx[p, 0] = p
            sym.pad_nnz[p] = 1
        fn = g.fnodes[f0:f1]
        ea_pos = sym.pos[fn[:, 0]].astype(np.int32)
        has_b = fn[:, 1] >= 0
        eb_pos = np.where(
            has_b, sym.pos[np.clip(fn[:, 1], 0, None)], -1).astype(np.int32)
        new_pos = sym.pos[new_ids].astype(np.int32) if new_ids else \
            np.zeros(0, dtype=np.int32)
        touched_pos = np.ascontiguousarray(np.concatenate(
            [ea_pos, eb_pos[has_b], new_pos]))
        MAXCAP = buckets[-1]
        F = np.empty(MAXCAP, dtype=np.int32)
        fringe = np.empty(FRCAP, dtype=np.int32)
        mbuf = np.zeros(1, dtype=np.int32)
        nfrbuf = np.zeros(1, dtype=np.int32)
        old_idx = np.empty((MAXCAP, BCAP), dtype=np.int32)
        old_nnz = np.empty(MAXCAP, dtype=np.int32)
        rc = native.plan_step_native(
            sym.nnodes, NCAP, BCAP, sym.parents, sym.pad_idx, sym.pad_nnz,
            sym.mark, sym.token,
            sym.kid_head, sym.kid_next, sym.kid_prev, touched_pos,
            np.ascontiguousarray(ea_pos), np.ascontiguousarray(eb_pos),
            MAXCAP, FRCAP, F, fringe, mbuf, nfrbuf, old_idx, old_nnz)
        if rc == 1:
            return None                       # affected set > largest bucket
        if rc == 2:
            raise OverflowError("row_block_capacity exceeded")
        if rc == 3:
            raise RuntimeError("planner invariant violation")
        sym.patterns_stale = True
        m = int(mbuf[0])
        naffected = m - len(new_ids)
        F = F[:m].copy()
        nfr = int(nfrbuf[0])
        fringe_overflow = _bucket(nfr, (MIXED_FR,)) is None
        fringe = fringe[:0] if fringe_overflow else fringe[:nfr].copy()
        new_rows = sym.pad_idx[F]
        new_nnz = sym.pad_nnz[F]
    else:
        # 2. mark affected (walk to root with OLD parents; new nodes
        #    isolated)
        touched = []
        for f in range(f0, f1):
            a, b = g.fnodes[f]
            touched.append(int(a))
            if b >= 0:
                touched.append(int(b))
        F = sym_mod.mark_affected(sym, touched)
        naffected = len(F)
        new_pos = np.asarray([int(sym.pos[i]) for i in new_ids],
                             dtype=np.int32)
        F = np.unique(np.concatenate([F, new_pos])) if len(new_pos) else F
        m = len(F)
        if _bucket(m, buckets) is None:
            return None
        # 3. symbolic update: pattern growth + new parents (the structural
        #    equivalent of search_tree_append, aprilsam.c:958-987)
        edges = [(int(g.fnodes[f][0]), int(g.fnodes[f][1]))
                 for f in range(f0, f1)]
        sym_mod.update_patterns_incremental(sym, F, edges)
        new_rows, new_nnz = _padded_rows(sym.patterns, F, BCAP, NCAP)
        # 4. fringe (children of F outside F, in the NEW tree)
        fringe = sym_mod.fringe_of(sym, F)
        fringe_overflow = _bucket(len(fringe), (MIXED_FR,)) is None
        if fringe_overflow:
            fringe = fringe[:0]

    # full-path steps never read the fringe (the sweep updates every node)
    if naffected > cfg.small_path_max or fringe_overflow:
        fringe = fringe[:0]

    tail = step_tail(g, f0, f1, new_ids, seeds)
    if len(tail.nf_a) > K or len(tail.np_node) > K:
        raise OverflowError("new_factor_capacity exceeded; raise it in config")

    def slots_of(nodes):
        p = sym.pos[nodes]
        s = np.searchsorted(F, p)
        if len(p) and (np.any(s >= m) or np.any(F[np.minimum(s, m - 1)] != p)):
            raise RuntimeError("factor endpoint outside the affected set")
        return s.astype(np.int64)

    F64 = F.astype(np.int64)
    return StepPlan(
        m=m, naffected=naffected, fringe_overflow=fringe_overflow,
        tail=tail,
        F_pos=F64,
        F_node=sym.order[F].astype(np.int64),
        new_ridx=new_rows.astype(np.int64),
        new_nnz=new_nnz.astype(np.int64),
        nf_a_slot=slots_of(tail.nf_a), nf_b_slot=slots_of(tail.nf_b),
        np_slot=slots_of(tail.np_node),
        fringe_pos=fringe.astype(np.int64),
        fringe_node=sym.order[fringe].astype(np.int64),
    )


# ======================================================================
# device step
# ======================================================================

def _dev(ds: DeviceState, a: np.ndarray, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=ds.device,
                           dtype=dtype)


def inc_ingest_tail(ds: DeviceState, tail: StepTail) -> DeviceState:
    """New nodes + odometry seeding + factor-table appends, in place (the
    first part of every step, and the whole of the plan-overflow path)."""
    dt = ds.state.dtype
    k = len(tail.node_ids)
    if k:
        ids = _dev(ds, tail.node_ids)
        st = _dev(ds, tail.node_states, dt)
        ds.state[ids] = st
        ds.l_point[ids] = st
        ds.delta_X[ids] = 0.0
        ds.nnodes += k
    if len(tail.seed_dst):
        # dst = src (+) z, or src (+) inv(z) (aprilsam_demo.c:180-191)
        z = _dev(ds, tail.seed_z, dt)
        inv = _dev(ds, tail.seed_inv)
        z_eff = torch.where(inv[:, None], xyt_inv(z), z)
        seeded = xyt_mul(ds.state[_dev(ds, tail.seed_src)], z_eff)
        dst = _dev(ds, tail.seed_dst)
        ds.state[dst] = seeded
        ds.l_point[dst] = seeded
    kx = len(tail.nf_a)
    if kx:
        n0 = ds.n_xyt
        if n0 + kx > ds.xyt_a.shape[0]:
            raise OverflowError("xyt factor capacity exceeded")
        sl = slice(n0, n0 + kx)
        ds.xyt_a[sl] = _dev(ds, tail.nf_a)
        ds.xyt_b[sl] = _dev(ds, tail.nf_b)
        ds.xyt_z[sl] = _dev(ds, tail.nf_z, dt)
        ds.xyt_W[sl] = _dev(ds, tail.nf_W, dt)
        ds.n_xyt = n0 + kx
    kp = len(tail.np_node)
    if kp:
        n0 = ds.n_pos
        if n0 + kp > ds.pos_node.shape[0]:
            raise OverflowError("xytpos factor capacity exceeded")
        sl = slice(n0, n0 + kp)
        ds.pos_node[sl] = _dev(ds, tail.np_node)
        ds.pos_z[sl] = _dev(ds, tail.np_z, dt)
        ds.pos_W[sl] = _dev(ds, tail.np_W, dt)
        ds.n_pos = n0 + kp
    return ds


def _psd_ok(Wh, W):
    """The QR update is a Cholesky UPdate: an indefinite W cannot be
    represented (the reference NaNs on it, smatd.c:669-699, and ignores its
    own is_spd flag — this escalates to a batch instead)."""
    if W.shape[0] == 0:
        return torch.ones((), dtype=torch.bool, device=W.device)
    Wsym = torch.triu(W) + torch.triu(W, 1).transpose(1, 2)
    err = torch.abs(torch.einsum("fki,fkj->fij", Wh, Wh) - Wsym)
    scale = 1e-3 * (1.0 + torch.abs(Wsym).amax(dim=(1, 2)))
    return torch.all(err.amax(dim=(1, 2)) <= scale)


def _measurement_rows(Wh, J_slots, m: int, dtype, device):
    """Stack W^{1/2} J for factors whose Jacobian blocks land at front
    slots: J_slots is a list of (slot [F], block [F, 3, 3]).  Returns
    [3F, 3m]."""
    F = Wh.shape[0]
    rows = torch.zeros(F, m, 3, 3, dtype=dtype, device=device)
    ar = torch.arange(F, device=device)
    for slot, blk in J_slots:
        rows.index_put_((ar, slot), blk, accumulate=True)
    return rows.permute(0, 2, 1, 3).reshape(3 * F, 3 * m)


def _frontal_core(ds: DeviceState, plan: StepPlan):
    """Ingest the step, then the dense frontal QR update of the affected
    rows; writes R' and y' back on the new pattern.  Returns (R_up [3m, 3m],
    y_new [3m], spd (0-d bool), pos2f, F_pos)."""
    NCAP = ds.state.shape[0]
    dtype, dev = ds.R_blocks.dtype, ds.device
    m = plan.m
    K3 = 3 * m
    inc_ingest_tail(ds, plan.tail)

    # ---------------- frontal gather: RF[r, c] = R block of row F[r] at
    # column F[c]; pos2f maps a position to its front slot (else -1)
    F_pos = _dev(ds, plan.F_pos)
    ar_m = torch.arange(m, device=dev)
    pos2f = torch.full((NCAP + 1,), -1, dtype=torch.int64, device=dev)
    pos2f[F_pos] = ar_m
    rows = ds.R_blocks[F_pos]                                # [m, BCAP, 3, 3]
    gather_fc = pos2f[ds.R_idx[F_pos].clamp(0, NCAP)]       # [m, BCAP]
    RF = torch.zeros(m, m + 1, 3, 3, dtype=dtype, device=dev)
    RF[ar_m[:, None], torch.where(gather_fc >= 0, gather_fc, m)] = rows
    R_dense = RF[:, :m].permute(0, 2, 1, 3).reshape(K3, K3)
    y_F = ds.y[F_pos].reshape(K3)

    # ---------------- stacked square-root measurement rows
    # (aprilsam.c:508-542 as a QR factor update)
    t = plan.tail
    nf_a, nf_b = _dev(ds, t.nf_a), _dev(ds, t.nf_b)
    nf_W = _dev(ds, t.nf_W, dtype)
    ev = eval_xyt(ds.l_point, nf_a, nf_b, _dev(ds, t.nf_z, dtype), nf_W)
    np_W = _dev(ds, t.np_W, dtype)
    evp = eval_xytpos(ds.state, _dev(ds, t.np_node),
                      _dev(ds, t.np_z, dtype), np_W)
    # W^T/2 via the closed-form 3x3 Cholesky (reads the upper triangle
    # only); tiny jitter keeps PSD-singular priors finite
    Wh_xyt = chol3(nf_W, jitter=1e-12)
    Wh_pos = chol3(np_W, jitter=1e-12)
    w_ok = _psd_ok(Wh_xyt, nf_W) & _psd_ok(Wh_pos, np_W)

    xyt_rows = _measurement_rows(
        Wh_xyt, [(_dev(ds, plan.nf_a_slot), Wh_xyt @ ev.Ja),
                 (_dev(ds, plan.nf_b_slot), Wh_xyt @ ev.Jb)], m, dtype, dev)
    xyt_rhs = (Wh_xyt @ ev.r[:, :, None]).reshape(-1)
    pos_rows = _measurement_rows(
        Wh_pos, [(_dev(ds, plan.np_slot), Wh_pos)], m, dtype, dev)
    pos_rhs = (Wh_pos @ evp.r[:, :, None]).reshape(-1)

    C = torch.cat([R_dense, xyt_rows, pos_rows], dim=0)
    d_stack = torch.cat([y_F, xyt_rhs, pos_rhs], dim=0)

    # ---------------- thin QR refactor (aprilsam.c:850-906)
    Q, Rq = torch.linalg.qr(C, mode="reduced")
    sgn = torch.where(torch.diagonal(Rq) < 0, -1.0, 1.0).to(dtype)
    R_up = sgn[:, None] * Rq
    diag = torch.diagonal(R_up)
    spd = w_ok & torch.all(torch.isfinite(diag) & (diag > 0))

    # forward solve on y (aprilsam.c:702-719): y' = Q^T d
    y_new = sgn * (Q.T @ d_stack)
    ds.y[F_pos] = y_new.reshape(m, 3)

    # ---------------- R' back on the NEW pattern: newblocks[r, b] =
    # Rt[r, front slot of new_ridx[r, b]], zero where the slot is padding
    Rt = R_up.reshape(m, 3, m, 3).permute(0, 2, 1, 3)
    new_ridx = _dev(ds, plan.new_ridx)
    scat_fc = pos2f[new_ridx.clamp(0, NCAP)]
    Rt_p = torch.cat([Rt, torch.zeros(m, 1, 3, 3, dtype=dtype, device=dev)],
                     dim=1)
    ds.R_blocks[F_pos] = Rt_p[ar_m[:, None],
                              torch.where(scat_fc >= 0, scat_fc, m)]
    ds.R_idx[F_pos] = new_ridx
    ds.R_nnz[F_pos] = _dev(ds, plan.new_nnz)
    return R_up, y_new, spd, pos2f, F_pos


def _relin_mask(dx, delta_xy: float, delta_theta: float):
    return ((torch.abs(dx[:, 0]) > delta_xy) | (torch.abs(dx[:, 1]) > delta_xy)
            | (torch.abs(dx[:, 2]) > delta_theta))


def _saturated(start_over):
    # the SPD / wall-clock escalations park start_over near INT_MAX; later
    # steps keep counting without wrapping
    return torch.clamp(start_over, max=1 << 30)


def _finish(ds: DeviceState, chi2, spd, live: bool,
            log_chi2: bool) -> torch.Tensor:
    """Write the metric ring; return the policy stats [chi2, start_over,
    spd_ok] (cumulative since the last batch epoch)."""
    if live:
        ds.spd_ok = ds.spd_ok & spd
        if log_chi2:
            # writes past capacity drop; chi2_history() raises on readback
            if ds.log_ptr < ds.chi2_log.shape[0]:
                ds.chi2_log[ds.log_ptr] = chi2
            ds.log_ptr += 1
    dtype = ds.chi2_log.dtype
    return torch.stack([chi2.to(dtype), ds.start_over.to(dtype),
                        ds.spd_ok.to(dtype)])


def _step_chi2(ds: DeviceState, log_chi2: bool):
    if log_chi2:
        return state_chi2(ds)
    return torch.full((), float("nan"), dtype=ds.chi2_log.dtype,
                      device=ds.device)


def _fast_body(ds: DeviceState, plan: StepPlan, delta_xy: float,
               delta_theta: float, log_chi2: bool) -> torch.Tensor:
    NCAP = ds.state.shape[0]
    R_up, y_new, spd, pos2f, _F = _frontal_core(ds, plan)

    # back-substitution restricted to F (exact: F is ancestor-closed)
    dxF = torch.linalg.solve_triangular(
        R_up, y_new[:, None], upper=True).reshape(plan.m, 3)
    ids_F = _dev(ds, plan.F_node)
    already = ds.relinearized
    relF = _relin_mask(dxF, delta_xy, delta_theta)
    newly = (relF & ~already[ids_F]).sum()
    already[ids_F] = already[ids_F] | relF
    ds.delta_X[ids_F] = dxF

    # fringe: children of F — x, delta_X and relinearization only
    # (solve_node visits them once and prunes, aprilsam.c:752-771).  Their
    # resident rows are current; slot 0 is their own diagonal block.
    if len(plan.fringe_pos):
        fr_pos = _dev(ds, plan.fringe_pos)
        fr_rows = ds.R_blocks[fr_pos]                        # [FR, BCAP, 3, 3]
        fc = pos2f[ds.R_idx[fr_pos].clamp(0, NCAP)]          # [FR, BCAP]
        xw = torch.where((fc >= 0)[..., None], dxF[fc.clamp(min=0)], 0.0)
        off = torch.einsum("kbij,kbj->ki", fr_rows, xw)
        x_fr = solve_upper3(fr_rows[:, 0], ds.y[fr_pos] - off)
        ids_fr = _dev(ds, plan.fringe_node)
        relfr = _relin_mask(x_fr, delta_xy, delta_theta)
        newly = newly + (relfr & ~already[ids_fr]).sum()
        already[ids_fr] = already[ids_fr] | relfr
        ds.delta_X[ids_fr] = x_fr
    ds.start_over = _saturated(ds.start_over) + newly

    ok = ~torch.any(torch.isnan(dxF), dim=1)
    new_state = ds.l_point[ids_F] + dxF
    new_state = torch.cat([new_state[:, :2], mod2pi(new_state[:, 2:])], dim=1)
    ds.state[ids_F] = torch.where(ok[:, None], new_state, ds.state[ids_F])

    chi2 = _step_chi2(ds, log_chi2)
    return _finish(ds, chi2, spd, plan.m > 0, log_chi2)


def _global_sweep(ds: DeviceState, PANEL: int, NPANB: int,
                  delta_xy: float, delta_theta: float) -> DeviceState:
    """Whole-graph back-substitution x = R^{-1} y and the update of every
    node (solve_node with pruning disabled, aprilsam.c:721-779) over the
    NPANB active panels."""
    n = ds.nnodes
    x_pos = panel_backsub(ds.R_blocks, ds.R_idx, ds.y, n, PANEL, NPANB)
    dx = x_pos[ds.pos[:n]]
    relin = _relin_mask(dx, delta_xy, delta_theta)
    newly = (relin & ~ds.relinearized[:n]).sum()
    ds.start_over = _saturated(ds.start_over) + newly
    ds.relinearized[:n] |= relin

    ok = ~torch.any(torch.isnan(dx), dim=1)[:, None]
    new_state = ds.l_point[:n] + dx
    new_state = torch.cat([new_state[:, :2], mod2pi(new_state[:, 2:])], dim=1)
    ds.state[:n] = torch.where(ok, new_state, ds.state[:n])
    ds.delta_X[:n] = torch.where(ok, dx, ds.delta_X[:n])
    return ds


def _full_body(ds: DeviceState, plan: StepPlan, PANEL: int, NPANB: int,
               delta_xy: float, delta_theta: float,
               log_chi2: bool) -> torch.Tensor:
    _R, _y, spd, _pos2f, _F = _frontal_core(ds, plan)
    _global_sweep(ds, PANEL, NPANB, delta_xy, delta_theta)
    chi2 = _step_chi2(ds, log_chi2)
    return _finish(ds, chi2, spd, plan.m > 0, log_chi2)


# ======================================================================
# solver
# ======================================================================

class IncrementalSolver:
    """Counterpart of the reference's incremental API: solve() runs a batch
    epoch, update() an AprilSAM incremental step with automatic batch
    fallback, synchronously (the policy reads each step's stats)."""

    def __init__(self, cfg: Optional[SolverConfig] = None, device="cuda"):
        self.cfg = cfg or SolverConfig()
        self.cfg.check_ported()
        self.device = resolve_device(device)
        setup_precision()
        self.ds = init_device_state(self.cfg, self.device)
        self.sym: Optional[SymbolicState] = None
        self.factor_num = 0
        self.node_num = 0
        self.batch_time_ms = 0.0
        self._ingested_nodes = 0
        self._ingested_factors = 0
        self.last_path = "none"
        self.last_naffected = 0
        self.steps_done = 0
        self.counters = {"fast": 0, "full": 0, "batch": 0}
        self._batch_serial = 0
        # the pure-python planner in place of the native one (tests)
        self.python_planner = False
        self.tp = TimeProfile() if self.cfg.show_timing else None

    # ---------------------------------------------------------------

    def _ingest(self, g: FactorGraph):
        self.ds = ingest_graph(self.ds, g, self.cfg, self._ingested_nodes,
                               self._ingested_factors)
        self._ingested_nodes = g.nnodes
        self._ingested_factors = g.nfactors

    def _apply_seeds(self, seeds: Sequence[SeedSpec]):
        """Odometry seeding outside the step (the fallback path for tails
        beyond the step capacities): dst = src (+) z, in order."""
        ds = self.ds
        for s in seeds:
            z = torch.as_tensor(np.asarray(s.z), dtype=ds.state.dtype,
                                device=ds.device)
            if s.invert:
                z = xyt_inv(z)
            seeded = xyt_mul(ds.state[s.src], z)
            ds.state[s.dst] = seeded
            ds.l_point[s.dst] = seeded

    def _ingest_tail_fast(self, g: FactorGraph,
                          seeds: Sequence[SeedSpec]) -> bool:
        """Ingest the un-ingested tail + seeds as one step payload, for the
        plan-overflow batch path.  Returns False when the tail exceeds the
        step capacities (the caller then uses _ingest + _apply_seeds)."""
        n0, f0 = self._ingested_nodes, self._ingested_factors
        new_ids = list(range(n0, g.nnodes))
        seeds = _dedup_seeds(seeds)
        dsts = {s.dst for s in seeds}
        if (len(new_ids) > KNODE or len(seeds) > KSEED
                or any(s.src in dsts for s in seeds)):
            return False
        tail = step_tail(g, f0, g.nfactors, new_ids, seeds)
        K = self.cfg.new_factor_capacity
        if len(tail.nf_a) > K or len(tail.np_node) > K:
            return False
        inc_ingest_tail(self.ds, tail)
        self._ingested_nodes = g.nnodes
        self._ingested_factors = g.nfactors
        return True

    def _grow_row_capacity(self):
        cfg = dataclasses.replace(
            self.cfg,
            row_block_capacity=int(self.cfg.row_block_capacity * 3 // 2))
        NCAP, BCAP = cfg.node_capacity, cfg.row_block_capacity
        ds = self.ds
        ds.R_blocks = torch.zeros((NCAP, BCAP, 3, 3), dtype=ds.R_blocks.dtype,
                                  device=ds.device)
        ds.R_idx = torch.full((NCAP, BCAP), NCAP, dtype=torch.int64,
                              device=ds.device)
        ds.R_nnz = torch.zeros(NCAP, dtype=torch.int64, device=ds.device)
        self.cfg = cfg

    def _maybe_grow_capacity(self, g: FactorGraph) -> None:
        """Double node/factor capacities before the incoming step could
        overflow them (the reference's reallocs, aprilsam.c:411-450)."""
        cfg = self.cfg
        need_nodes = g.nnodes + KNODE + 1
        n_xyt = g.nf_xyt
        n_pos = g.nfactors - n_xyt
        FPOS = max(256, cfg.factor_capacity // 8)
        need_f = n_xyt + cfg.new_factor_capacity + 1
        need_p = n_pos + cfg.new_factor_capacity + 1
        if (need_nodes <= cfg.node_capacity and need_f <= cfg.factor_capacity
                and need_p <= FPOS):
            return
        ncap = cfg.node_capacity
        while need_nodes > ncap:
            ncap *= 2
        fcap = cfg.factor_capacity
        while need_f > fcap or need_p > max(256, fcap // 8):
            fcap *= 2

        old = state_to_numpy(self.ds)
        old_ncap = cfg.node_capacity
        self.cfg = dataclasses.replace(cfg, node_capacity=ncap,
                                       factor_capacity=fcap)
        h = state_to_numpy(init_device_state(self.cfg, "cpu"))
        for name, src in old.items():
            if src.ndim == 0:
                h[name] = src
                continue
            h[name][tuple(slice(0, s) for s in src.shape)] = src
        # the pattern padding used the OLD capacity
        h["R_idx"][h["R_idx"] >= old_ncap] = ncap
        # identity position map beyond the old capacity
        h["pos"][old_ncap:] = np.arange(old_ncap, ncap, dtype=np.int32)
        h["order"][old_ncap:] = np.arange(old_ncap, ncap, dtype=np.int32)
        self.ds = state_from_numpy(h, self.device)

        # the native planner mirror is capacity-sized: rebuild it lazily
        sym = self.sym
        if sym is not None and getattr(sym, "pad_idx", None) is not None:
            sym.patterns = sym_patterns_list(sym)
            sym.patterns_stale = False
            sym.pad_idx = None
            sym.pad_nnz = None

    def _run_batch(self, g: FactorGraph, record_time: bool = False,
                   log_mode: int = 0) -> BatchInfo:
        from .host_batch import host_batch_epoch

        nn, nf = g.nnodes, g.nfactors
        t0 = time.perf_counter()
        while True:
            try:
                self.ds, self.sym, info = host_batch_epoch(
                    self.ds, self.cfg, nn, g.ftype[:nf], g.fnodes[:nf],
                    g.fz[:nf], g.fW[:nf], log_mode=log_mode)
                break
            except OverflowError:
                self._grow_row_capacity()
        if record_time and self.cfg.wallclock_gate \
                and self.device.type == "cuda":
            # the recorded batch time feeds the wall-clock gate
            torch.cuda.synchronize(self.device)
        if self.tp is not None:
            self.tp.stamp("batch_epoch")
        if record_time:
            # param->batch_time is recorded only when a batch is triggered
            # from the incremental path (aprilsam.c:568-572)
            self.batch_time_ms = (time.perf_counter() - t0) * 1e3
        self.factor_num = max(self.factor_num, nf)
        self.node_num = max(self.node_num, nn)
        self.last_path = "batch"
        self._batch_serial += 1
        self.counters["batch"] += 1
        return info

    def solve(self, g: FactorGraph) -> BatchInfo:
        """Full batch solve (april_graph_cholesky)."""
        if g.nnodes == 0 or g.nfactors == 0:
            return BatchInfo(chi2=0.0, spd=True, n=0)
        self._maybe_grow_capacity(g)
        self._ingest(g)
        info = self._run_batch(g)
        self.steps_done += 1
        return info

    # ---------------------------------------------------------------

    def _apply_policy(self, stats: np.ndarray, serial: int, step_ms: float,
                      g: FactorGraph) -> Optional[BatchInfo]:
        start_over = int(stats[1])
        spd = bool(stats[2] > 0.5)
        if serial != self._batch_serial:
            return None  # stats predate the last batch epoch
        if (self.cfg.wallclock_gate and step_ms > 0.0
                and self.batch_time_ms > 0.0
                and step_ms > self.batch_time_ms * self.cfg.batch_time_fraction):
            start_over = INT_MAX                       # aprilsam.c:557-559
        if self.cfg.check_spd and not spd:
            start_over = INT_MAX
        if start_over > self.cfg.nthreshold:           # aprilsam.c:566-575
            # the epoch's chi2 replaces the triggering step's ring entry
            return self._run_batch(g, record_time=True, log_mode=1)
        return None

    def update(self, g: FactorGraph,
               seeds: Sequence[SeedSpec] = ()) -> BatchInfo:
        """Incremental update (april_graph_cholesky_inc), synchronous:
        returns the step's BatchInfo."""
        if g.nnodes == 0 or g.nfactors == 0:
            return BatchInfo(chi2=0.0, spd=True, n=0)
        if self.sym is None or self.factor_num == g.nfactors:
            # guards (aprilsam.c:380-385)
            return BatchInfo(chi2=float(state_chi2(self.ds)), spd=True, n=0)
        self._maybe_grow_capacity(g)

        if self.tp is not None:
            self.tp.reset()
        t0 = time.perf_counter()
        try:
            plan = plan_step(self.sym, self.cfg, g, self.factor_num,
                             g.nfactors, self.node_num, seeds,
                             python_planner=self.python_planner)
        except OverflowError:
            plan = None
        self.factor_num = g.nfactors
        self.node_num = g.nnodes
        if self.tp is not None:
            self.tp.stamp("plan")

        if plan is None:
            # plan overflow -> batch fallback; the step's nodes, factors
            # and seeds are ingested first (aprilsam_demo.c:180-191)
            if not self._ingest_tail_fast(g, seeds):
                self._ingest(g)
                self._apply_seeds(seeds)
            self.steps_done += 1
            return self._run_batch(g, record_time=True)

        self._ingested_nodes = g.nnodes
        self._ingested_factors = g.nfactors
        self.last_naffected = plan.naffected
        fast = (plan.naffected <= self.cfg.small_path_max
                and not plan.fringe_overflow)
        stats = self._dispatch_one(plan, fast, self._npanb(g.nnodes))
        self.steps_done += 1
        s = stats.cpu().numpy()
        if self.tp is not None:
            self.tp.stamp("dispatch")
        step_ms = (time.perf_counter() - t0) * 1e3
        info = self._apply_policy(s, self._batch_serial, step_ms, g)
        if info is not None:
            return info
        return BatchInfo(chi2=float(s[0]), spd=bool(s[2] > 0.5), n=g.nnodes)

    def _dispatch_one(self, plan: StepPlan, fast: bool,
                      npanb: int) -> torch.Tensor:
        cfg = self.cfg
        self.last_path = "fast" if fast else "full"
        self.counters[self.last_path] += 1
        if fast:
            return _fast_body(self.ds, plan, float(cfg.delta_xy),
                              float(cfg.delta_theta), cfg.log_chi2)
        return _full_body(self.ds, plan, cfg.panel_nodes, npanb,
                          float(cfg.delta_xy), float(cfg.delta_theta),
                          cfg.log_chi2)

    def _npanb(self, nnodes: int) -> int:
        """Number of active sweep panels: the next power of two covering
        ceil(nnodes / PANEL), capped at node_capacity / PANEL."""
        PANEL = self.cfg.panel_nodes
        NPAN = self.cfg.node_capacity // PANEL
        b = 1
        while b * PANEL < nnodes and b < NPAN:
            b *= 2
        return min(b, NPAN)

    def flush(self, g: FactorGraph) -> None:
        """End of a replay.  The synchronous path applies every policy
        decision inside update(), so nothing is pending; kept so replay
        drivers need not know the mode."""

    # ---------------------------------------------------------------

    def chi2(self) -> float:
        return float(state_chi2(self.ds))

    def chi2_history(self) -> np.ndarray:
        """Per-optimize chi2 values from the metric ring."""
        n = self.ds.log_ptr
        LOG = self.ds.chi2_log.shape[0]
        if n > LOG:
            raise RuntimeError(
                f"chi2 metric ring overflowed ({n} entries, capacity {LOG}); "
                "raise SolverConfig.metric_log_capacity for this replay "
                "length")
        return self.ds.chi2_log[:n].cpu().numpy()

    def sync_states(self, g: FactorGraph) -> None:
        n = g.nnodes
        g.state[:n] = self.ds.state[:n].cpu().numpy().astype(np.float64)
        g.l_point[:n] = self.ds.l_point[:n].cpu().numpy().astype(np.float64)
        g.delta_X[:n] = self.ds.delta_X[:n].cpu().numpy().astype(np.float64)
