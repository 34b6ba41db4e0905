"""Panel batch epoch: a left-looking panel Cholesky on the block pattern of
R.

Counterpart of ``aprilsam_tpu/solver/panel_epoch.py`` (reference: the
CSparse up-looking factorization, csparse.c:462-513, recast as a
left-looking panel method):

  host:   the native symbolic phase (batch.py), then the panel plan: per
          panel of PANEL positions its contributing rows (earlier rows whose
          pattern reaches into the panel) and its union tail columns, the
          contribution -> A-entry segment tables, and the index tables of
          the panel loop (build_panel_plan);
  device: batched factor evaluation; A assembled COMPACT on the pattern by
          a gather and a segment sum per entry; Jacobi equilibration; a loop
          over panels: the dense S = Sd - W^T W of the panel from its
          contributors' finished rows, a Cholesky, two triangular solves
          (the panel's R rows and its y), written back on the pattern;
          un-equilibration; back-substitution through
          kernels/sweep.py:panel_backsub (K1); the state update.

A never exists as a dense [3n, 3n] matrix, so the epoch scales with the
pattern, not with n^2.  The caps of panel_caps and their grade-0 -> grade-1
escalation decide whether a plan exists, exactly as in the JAX package.
Inside a plan the port sizes each panel's work to its exact contributor
and tail counts: the JAX package pads them to the graded buckets of its
seg_ladder, and its one-hot contractions, int16-packed upload and
hoisted batch pre-assembly are TPU workarounds that are not copied.  The
compact A and R live as [entries, 3, 3] tensors in pattern order during
the epoch; R is expanded onto the [NCAP, BCAP] block rows at the end.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..factors import eval_xyt, eval_xytpos, gn_blocks_xyt
from ..graph import FACTOR_XYT
from ..kernels.sweep import panel_backsub
from .batch import cholesky_nan, finish_epoch, full_maps, refresh_states
from .config import SolverConfig
from .state import DeviceState, upload
from .symbolic import SymbolicState


def panel_caps(npanb: int, panel: int,
               grade: int = 0) -> Tuple[int, int, int, int, int]:
    """Capacities derived from the active panel count plus an escalation
    grade: (contributors per panel, union tail columns per panel,
    contributions per A entry or B row, compact A entries, contributions).
    Grade 0 is sized to measured M3500 plans (mc max 879, nu max 474,
    multiplicity max 9); a plan that overflows it retries at grade 1 before
    the epoch falls back to the dense or host one."""
    mc = 64 * npanb if npanb <= 16 else (1024 if npanb <= 64 else 2048)
    if grade == 0:
        nu = 32 * npanb if npanb <= 16 else (512 if npanb <= 64 else 1024)
        mult = 16
    else:
        nu = 48 * npanb if npanb <= 16 else (768 if npanb <= 64 else 1536)
        mult = 32
    kexta = 8 * panel * npanb
    nfac3 = 8 * panel * npanb
    return mc, nu, mult, kexta, nfac3


class PanelEpochPlan(NamedTuple):
    """Host-built tables of one panel epoch (all numpy).  The compact
    entries are the pattern entries (p, b), b < nnz[p], in row-major order;
    entry e of row p is row_ptr[p] + b."""

    npanb: int            # active panel count, a power of two (K1's B)
    n_xyt: int            # xyt / xytpos factors of the plan, in table order
    n_pos: int
    perm: np.ndarray      # contribution sources sorted by A entry
    astart: np.ndarray    # [entries] first perm slot of each A entry
    acount: np.ndarray    # [entries] contributions of each A entry
    bperm: np.ndarray     # B contribution sources sorted by row
    bstart: np.ndarray    # [NCAP] first bperm slot of each row
    bcount: np.ndarray    # [NCAP]
    row_ptr: np.ndarray   # [NCAP] first compact entry of each row
    ent_row: np.ndarray   # [entries] row, slot and column of each entry
    ent_slot: np.ndarray
    ent_col: np.ndarray
    tt: np.ndarray        # [panels] PANEL + union tail columns
    a_off: np.ndarray     # [panels + 1] the panel's compact entries
    a_dst: np.ndarray     # [entries] (row in panel) * tt + target column
    c_off: np.ndarray     # [panels + 1] the panel's contributor entries
    c_src: np.ndarray     # compact entry of each contributor entry
    c_dst: np.ndarray     # (contributor) * tt + target column
    cr_off: np.ndarray    # [panels + 1] the panel's contributor rows
    crow: np.ndarray      # contributor row positions
    R_idx: np.ndarray     # [NCAP, BCAP] new pattern (pad NCAP) = pad_idx
    R_nnz: np.ndarray     # [NCAP]
    pos: np.ndarray       # [NCAP]
    order: np.ndarray     # [NCAP]


def _segments(keys: np.ndarray, size: int):
    """(start, count) of each key 0..size-1 in the sorted array keys."""
    start = np.zeros(size, dtype=np.int64)
    count = np.zeros(size, dtype=np.int64)
    uq, first, cnt = np.unique(keys, return_index=True, return_counts=True)
    start[uq] = first
    count[uq] = cnt
    return start, count


def build_panel_plan(cfg: SolverConfig, nnodes: int, sym: SymbolicState,
                     pad_idx: np.ndarray, pad_nnz: np.ndarray,
                     ftypes: np.ndarray, fnodes: np.ndarray,
                     grade: int = 0) -> Optional[PanelEpochPlan]:
    """The panel plan from the symbolic pattern and the factor table
    (vectorized numpy), or None when it exceeds the caps of `grade`."""
    NCAP = cfg.node_capacity
    BCAP = cfg.row_block_capacity
    PANEL = cfg.panel_nodes
    pos, order = full_maps(NCAP, sym)

    npanb = max(1, -(-nnodes // PANEL))
    b = 1
    npan_max = NCAP // PANEL
    while b < npanb and b < npan_max:
        b *= 2
    npanb = min(b, npan_max)

    nnz = pad_nnz[:nnodes].astype(np.int64)
    row_ptr = np.zeros(NCAP, dtype=np.int64)
    row_ptr[1:nnodes] = np.cumsum(nnz[:-1])[: nnodes - 1]
    kexta_live = int(nnz.sum())

    # ---- per-panel contributors + union tails (as the JAX package) ----
    rows_i, slots_i = np.nonzero(
        np.arange(BCAP, dtype=np.int64)[None, :] < nnz[:, None])
    cols_i = pad_idx[rows_i, slots_i].astype(np.int64)
    pan_of_col = cols_i // PANEL
    pan_of_row = rows_i // PANEL
    off_pan = pan_of_col > pan_of_row                     # strictly later
    pkey = np.unique(pan_of_col[off_pan] * NCAP + rows_i[off_pan])
    ppan = pkey // NCAP
    prow_c = pkey % NCAP
    mc = np.bincount(ppan, minlength=npanb)
    if len(mc) > npanb:
        return None
    ukey = np.unique(pan_of_row[off_pan] * (NCAP + 1) + cols_i[off_pan])
    upan = ukey // (NCAP + 1)
    nu = np.bincount(upan, minlength=npanb)
    if len(nu) > npanb:
        return None

    mc_cap, nu_cap, mult_cap, kexta, nfac3 = panel_caps(npanb, PANEL, grade)
    if int(mc.max(initial=0)) > mc_cap or int(nu.max(initial=0)) > nu_cap \
            or kexta_live > kexta:
        return None

    # ---- contribution -> compact-A segment tables ----------------------
    # sources address the device-side concatenations
    #   blocks = [Haa(nx) | Hbb(nx) | Hoff(nx) | Wprior(np)]
    #   bvecs  = [ga(nx)  | gb(nx)  | gprior(np)]
    # where a factor's index within its type is its table order
    is_xyt = ftypes == FACTOR_XYT
    nx = int(is_xyt.sum())
    npo = len(ftypes) - nx
    ix = np.cumsum(is_xyt) - 1
    ip = np.cumsum(~is_xyt) - 1
    pa = pos[fnodes[:, 0].astype(np.int64)]
    pb = pos[np.clip(fnodes[:, 1], 0, None).astype(np.int64)]
    pmin = np.minimum(pa, pb)
    pmax = np.maximum(pa, pb)
    # pattern rows are sorted ascending: slot = #cols < pmax
    d_off = row_ptr[pmin] + (pad_idx[pmin] < pmax[:, None]).sum(axis=1)
    dest = np.concatenate([np.where(is_xyt, row_ptr[pa], -1),
                           np.where(is_xyt, row_ptr[pb], -1),
                           np.where(is_xyt, d_off, -1),
                           np.where(~is_xyt, row_ptr[pa], -1)])
    src = np.concatenate([ix, nx + ix, 2 * nx + ix, 3 * nx + ip])
    vi = np.nonzero(dest >= 0)[0]
    if len(vi) > nfac3:
        return None
    sort = np.argsort(dest[vi], kind="stable")
    perm = src[vi][sort]
    astart, acount = _segments(dest[vi][sort], kexta_live)

    bdest = np.concatenate([np.where(is_xyt, pa, -1),
                            np.where(is_xyt, pb, -1),
                            np.where(~is_xyt, pa, -1)])
    bsrc = np.concatenate([ix, nx + ix, 2 * nx + ip])
    bi = np.nonzero(bdest >= 0)[0]
    bsort = np.argsort(bdest[bi], kind="stable")
    bperm = bsrc[bi][bsort]
    bstart, bcount = _segments(bdest[bi][bsort], NCAP)
    if max(int(acount.max(initial=1)), int(bcount.max(initial=1))) \
            > mult_cap:
        return None

    # ---- the panel loop's index tables (exact sizes) -------------------
    # target columns of panel k: its own PANEL columns, then its union
    # tail (ukey order); column c lands at t = c - k*PANEL inside the
    # panel, else at PANEL + its rank in the tail
    n_act = -(-nnodes // PANEL)
    ustart = np.concatenate([[0], np.cumsum(nu)])
    tt = PANEL + nu[:n_act]

    def target(k, c):
        """(t, whether column c is a target column of panel k)."""
        inside = (c >= k * PANEL) & (c < (k + 1) * PANEL)
        key = k * (NCAP + 1) + c
        j = np.searchsorted(ukey, key)
        hit = inside.copy()
        if len(ukey):
            hit |= ukey[np.minimum(j, len(ukey) - 1)] == key
        return np.where(inside, c - k * PANEL, PANEL + j - ustart[k]), hit

    t_a, _ = target(pan_of_row, cols_i)
    a_dst = (rows_i - pan_of_row * PANEL) * tt[pan_of_row] + t_a
    a_off = np.searchsorted(rows_i, np.arange(n_act + 1) * PANEL)

    # contributor entries: every pattern entry of each contributor row,
    # kept where its column is a target column of the panel
    cnz = nnz[prow_c]
    cent = np.repeat(np.arange(len(prow_c)), cnz)
    cslot = np.arange(len(cent)) - np.repeat(np.cumsum(cnz) - cnz, cnz)
    ck = ppan[cent]
    ccol = pad_idx[prow_c[cent], cslot].astype(np.int64)
    pstart = np.concatenate([[0], np.cumsum(mc)])
    m_loc = cent - pstart[ck]
    t_c, hit = target(ck, ccol)
    c_src = (row_ptr[prow_c[cent]] + cslot)[hit]
    c_dst = (m_loc * tt[ck] + t_c)[hit]
    c_off = np.searchsorted(ck[hit], np.arange(n_act + 1))

    R_nnz = np.zeros(NCAP, dtype=np.int64)
    R_nnz[:nnodes] = nnz

    return PanelEpochPlan(
        npanb=npanb, n_xyt=nx, n_pos=npo, perm=perm, astart=astart,
        acount=acount, bperm=bperm, bstart=bstart, bcount=bcount,
        row_ptr=row_ptr, ent_row=rows_i, ent_slot=slots_i, ent_col=cols_i,
        tt=tt, a_off=a_off, a_dst=a_dst, c_off=c_off, c_src=c_src,
        c_dst=c_dst, cr_off=pstart[:n_act + 1], crow=prow_c, R_idx=pad_idx,
        R_nnz=R_nnz, pos=pos, order=order)


def _segment_sum(vals, start, count, width: int):
    """out[i] = sum of vals[start[i] : start[i] + count[i]] (in order);
    width (host) is the largest count."""
    out_shape = (start.shape[0],) + tuple(vals.shape[1:])
    if width == 0 or vals.shape[0] == 0:
        return vals.new_zeros(out_shape)
    ar = torch.arange(width, device=vals.device)
    tab = (start[:, None] + ar[None, :]).clamp(max=vals.shape[0] - 1)
    mask = (ar[None, :] < count[:, None]).to(vals.dtype)
    g = vals[tab] * mask.view(mask.shape + (1,) * (vals.dim() - 1))
    return g.sum(dim=1)


def panel_epoch_step(ds: DeviceState, plan: PanelEpochPlan, tikhonov: float,
                     PANEL: int, log_mode: int):
    """The panel epoch on the device, in place.  Returns (chi2, spd) as 0-d
    tensors; no synchronizing call."""
    NCAP = ds.state.shape[0]
    dtype, dev = ds.state.dtype, ds.device
    n = ds.nnodes
    P3 = 3 * PANEL
    nx, npo = plan.n_xyt, plan.n_pos
    # the loop bounds stay on the host
    a_off, c_off, cr_off = (plan.a_off.tolist(), plan.c_off.tolist(),
                            plan.cr_off.tolist())
    T = upload(ds, dict(
        perm=plan.perm, astart=plan.astart, acount=plan.acount,
        bperm=plan.bperm, bstart=plan.bstart, bcount=plan.bcount,
        row_ptr=plan.row_ptr, ent_row=plan.ent_row, ent_slot=plan.ent_slot,
        ent_col=plan.ent_col, a_dst=plan.a_dst, c_src=plan.c_src,
        c_dst=plan.c_dst, crow=plan.crow, R_idx=plan.R_idx,
        R_nnz=plan.R_nnz, pos=plan.pos, order=plan.order), {})

    # ---- relinearize all + batched factor evaluation (aprilsam.c:131-195)
    l_point = ds.state.clone()
    pos_new = T["pos"]
    xa, xb = ds.xyt_a[:nx], ds.xyt_b[:nx]
    W = ds.xyt_W[:nx]
    ev = eval_xyt(l_point, xa, xb, ds.xyt_z[:nx], W)
    Haa, Hab, Hba, Hbb, ga, gb = gn_blocks_xyt(ev, W)
    pn, pW = ds.pos_node[:npo], ds.pos_W[:npo]
    evp = eval_xytpos(l_point, pn, ds.pos_z[:npo], pW)
    gp = torch.einsum("fij,fj->fi", pW, evp.r)
    Hoff = torch.where((pos_new[xa] < pos_new[xb])[:, None, None], Hab, Hba)
    blocks = torch.cat([Haa, Hbb, Hoff, pW])
    bvecs = torch.cat([ga, gb, gp])

    # ---- compact A on the pattern and B by rows: a gather and an
    # in-order segment sum per entry (deterministic on the card)
    A_comp = _segment_sum(blocks[T["perm"]], T["astart"], T["acount"],
                          int(plan.acount.max(initial=0)))
    B_full = _segment_sum(bvecs[T["bperm"]], T["bstart"], T["bcount"],
                          int(plan.bcount.max(initial=0)))

    # ---- Jacobi equilibration (the dense epoch's D^-1/2 A D^-1/2): the
    # factorization runs on R~ = R D^-1/2 (column scaling), recovered once
    # at the end; y~ equals the true y
    tik = float(tikhonov)
    dscal = torch.diagonal(A_comp[T["row_ptr"][:n]], dim1=1, dim2=2) + tik
    dvec = torch.ones((NCAP, 3), dtype=dtype, device=dev)
    dvec[:n] = torch.rsqrt(torch.clamp(dscal, min=1e-30))
    ent_row, ent_col = T["ent_row"], T["ent_col"]
    A_eq = (A_comp * dvec[ent_row][:, :, None]) * dvec[ent_col][:, None, :]
    del A_comp
    act3 = (torch.arange(NCAP, device=dev) < n).repeat_interleave(3)
    # tikhonov in equilibrated units on active rows, 1.0 on padding rows
    wdiag = torch.where(act3, tik * dvec.reshape(-1) ** 2, 1.0)
    bvec = (B_full * dvec).reshape(-1)

    # ---- left-looking panel factorization + forward solve --------------
    Rc = torch.zeros_like(A_eq)            # R~ in compact pattern order
    yv = torch.zeros((NCAP, 3), dtype=dtype, device=dev)
    spd = torch.ones((), dtype=torch.bool, device=dev)
    a_dst, c_src, c_dst, crow = T["a_dst"], T["c_src"], T["c_dst"], T["crow"]
    for k, TT in enumerate(plan.tt.tolist()):
        p0 = k * PANEL
        r0, r1 = 3 * p0, 3 * p0 + P3
        ea, eb = a_off[k], a_off[k + 1]
        # the panel's rows of A over its target columns, [P3, 3 TT]
        X = torch.zeros((PANEL * TT, 3, 3), dtype=dtype, device=dev)
        X[a_dst[ea:eb]] = A_eq[ea:eb]
        Acomb = X.view(PANEL, TT, 3, 3).permute(0, 2, 1, 3).reshape(
            P3, 3 * TT)
        Xd = Acomb[:, :P3]
        # the reference's upper-triangle rule at scalar level
        # (aprilsam.c:216-225)
        Sd = torch.triu(Xd) + torch.triu(Xd, 1).T
        Sd.diagonal().add_(wdiag[r0:r1])
        # the contributors' finished rows over the same columns, [3 MC, 3 TT]
        ca, cb = c_off[k], c_off[k + 1]
        MC = cr_off[k + 1] - cr_off[k]
        Wc = torch.zeros((MC * TT, 3, 3), dtype=dtype, device=dev)
        Wc[c_dst[ca:cb]] = Rc[c_src[ca:cb]]
        V = Wc.view(MC, TT, 3, 3).permute(0, 2, 1, 3).reshape(3 * MC,
                                                            3 * TT)
        Vp = V[:, :P3]
        G = Vp.T @ V
        gy = Vp.T @ yv[crow[cr_off[k]:cr_off[k + 1]]].reshape(-1)
        S = Sd - G[:, :P3]
        Su = Acomb[:, P3:] - G[:, P3:]
        by = bvec[r0:r1] - gy

        Ls = cholesky_nan(S)
        diag = torch.diagonal(Ls)
        spd = spd & torch.all(torch.where(
            act3[r0:r1], torch.isfinite(diag) & (diag > 0), True))
        Rpu = torch.linalg.solve_triangular(Ls, Su, upper=False)
        yP = torch.linalg.solve_triangular(Ls, by[:, None], upper=False)
        Rcomb = torch.cat([torch.triu(Ls.T), Rpu], dim=1)
        R4 = Rcomb.view(PANEL, 3, TT, 3).permute(0, 2, 1, 3).reshape(
            PANEL * TT, 3, 3)
        Rc[ea:eb] = R4[a_dst[ea:eb]]
        yv[p0:p0 + PANEL] = yP.view(PANEL, 3)

    # ---- un-equilibrate (R = R~ D^1/2, by columns), onto the block rows
    ds.R_blocks.zero_()
    ds.R_blocks[ent_row, T["ent_slot"]] = Rc / dvec[ent_col][:, None, :]
    ds.y.copy_(yv)

    # ---- back-substitution (K1) + state update (aprilsam.c:298-315)
    x_pos = panel_backsub(ds.R_blocks, T["R_idx"], yv, n, PANEL, plan.npanb)
    refresh_states(ds, l_point, x_pos[pos_new[:n]])
    ds.l_point.copy_(l_point)
    chi2 = finish_epoch(ds, T, log_mode)
    return chi2, spd
