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
escalation decide whether a plan exists, exactly as in the JAX package,
and as there each panel is padded to the smallest seg_ladder grade (MC,
NU) that fits its contributor and tail counts.  The epoch runs as three
kinds of dispatch, each a CUDA graph on the card (utils/cache.py): a head
(evaluation, assembly, equilibration) per active panel count NPANB, one
panel step per (NPANB, grade), replayed once per active panel with that
panel's padded tables, and a tail (back-substitution, state update) per
NPANB; they hand the factor to each other through a workspace.  The JAX
package's one-hot contractions, int16-packed upload and hoisted batch
pre-assembly are TPU workarounds that are not copied.  The compact A and R
live as [entries, 3, 3] tensors in pattern order during the epoch; R is
expanded onto the [NCAP, BCAP] block rows at the end.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..factors import eval_xyt, eval_xytpos, gn_blocks_xyt
from ..graph import FACTOR_XYT
from ..kernels.sweep import panel_backsub
from ..utils import GraphCache
from .batch import (cholesky_nan, epoch_ctl, finish_epoch, full_maps,
                    keep_live, refresh_states)
from .config import SolverConfig
from .state import DeviceState, full
from .symbolic import SymbolicState


def _bucket_pow2(v: int, lo: int) -> int:
    """The least lo * 2^k >= v."""
    b = lo
    while b < v:
        b *= 2
    return b


def seg_ladder(mc_cap: int, nu_cap: int) -> Tuple[Tuple[int, int], ...]:
    """The contributor-count grades (MC, NU) of one epoch, smallest first:
    (64, 256) and (256, 512) where below the caps, then the caps (the JAX
    package's panel_epoch.py:seg_ladder).  Per-panel contributor counts
    are near-monotone in panel position, so the panels split into
    contiguous runs, each padded to the smallest grade that fits it."""
    grades = []
    for mc, nu in ((64, 256), (256, 512)):
        if mc < mc_cap:
            grades.append((mc, min(nu, nu_cap)))
    grades.append((mc_cap, nu_cap))
    return tuple(grades)


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
    entry e of row p is row_ptr[p] + b.  The factor-indexed tables address
    the whole factor tables (FCAP xyt, FPOS xytpos rows), padded to the
    caps of panel_caps; the per-panel tables pad at dispatch
    (panel_inputs)."""

    npanb: int            # active panel count, a power of two (K1's B)
    kexta: int            # compact A entries (cap)
    mult: int             # contributions per A entry or B row (cap)
    ladder: tuple         # seg_ladder's (MC, NU) grades
    grade: np.ndarray     # [panels] each active panel's grade (monotone)
    perm: np.ndarray      # [nfac3] contribution sources sorted by A entry
    astart: np.ndarray    # [kexta] first perm slot of each A entry
    acount: np.ndarray    # [kexta] contributions of each A entry
    bperm: np.ndarray     # [nfac3] B contribution sources sorted by row
    bstart: np.ndarray    # [NCAP] first bperm slot of each row
    bcount: np.ndarray    # [NCAP]
    row_ptr: np.ndarray   # [NCAP] first compact entry of each row
    ent_row: np.ndarray   # [kexta] row (pad NCAP), slot and column of each
    ent_slot: np.ndarray  # entry
    ent_col: np.ndarray
    a_off: np.ndarray     # [panels + 1] the panel's compact entries
    a_row: np.ndarray     # [entries] the entry's row within its panel
    a_t: np.ndarray       # [entries] its target column within the panel
    c_off: np.ndarray     # [panels + 1] the panel's contributor entries
    c_src: np.ndarray     # compact entry of each contributor entry
    c_m: np.ndarray       # its contributor's slot, and its target column
    c_t: np.ndarray
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


def _pad(a, n: int, fill) -> np.ndarray:
    out = np.full(n, fill, dtype=np.int64)
    out[:len(a)] = a
    return out


def build_panel_plan(cfg: SolverConfig, nnodes: int, sym: SymbolicState,
                     pad_idx: np.ndarray, pad_nnz: np.ndarray,
                     ftypes: np.ndarray, fnodes: np.ndarray,
                     grade: int = 0) -> Optional[PanelEpochPlan]:
    """The panel plan from the symbolic pattern and the factor table
    (vectorized numpy), or None when it exceeds the caps of `grade`."""
    NCAP = cfg.node_capacity
    BCAP = cfg.row_block_capacity
    PANEL = cfg.panel_nodes
    FCAP = cfg.factor_capacity
    FPOS = max(256, FCAP // 8)
    pos, order = full_maps(NCAP, sym)

    npanb = min(_bucket_pow2(max(1, -(-nnodes // PANEL)), 1),
                NCAP // PANEL)

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

    # each panel at the smallest seg_ladder grade that fits it, monotonized
    # so that the grades run in elimination order (the JAX package's rule)
    ladder = seg_ladder(mc_cap, nu_cap)
    n_act = -(-nnodes // PANEL)
    fit = ((mc[:n_act, None] <= np.asarray([g[0] for g in ladder])[None])
           & (nu[:n_act, None] <= np.asarray([g[1] for g in ladder])[None]))
    gm = np.maximum.accumulate(fit.argmax(axis=1)) if n_act else \
        np.zeros(0, dtype=np.int64)

    # ---- contribution -> compact-A segment tables ----------------------
    # sources address the device-side concatenations of the whole tables
    #   blocks = [Haa(FCAP) | Hbb(FCAP) | Hoff(FCAP) | Wprior(FPOS) | 0]
    #   bvecs  = [ga(FCAP)  | gb(FCAP)  | gprior(FPOS) | 0]
    # where a factor's index within its type is its table order
    is_xyt = ftypes == FACTOR_XYT
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
    src = np.concatenate([ix, FCAP + ix, 2 * FCAP + ix, 3 * FCAP + ip])
    vi = np.nonzero(dest >= 0)[0]
    if len(vi) > nfac3:
        return None
    sort = np.argsort(dest[vi], kind="stable")
    perm = _pad(src[vi][sort], nfac3, 3 * FCAP + FPOS)
    astart, acount = _segments(dest[vi][sort], kexta)

    bdest = np.concatenate([np.where(is_xyt, pa, -1),
                            np.where(is_xyt, pb, -1),
                            np.where(~is_xyt, pa, -1)])
    bsrc = np.concatenate([ix, FCAP + ix, 2 * FCAP + ip])
    bi = np.nonzero(bdest >= 0)[0]
    bsort = np.argsort(bdest[bi], kind="stable")
    bperm = _pad(bsrc[bi][bsort], nfac3, 2 * FCAP + FPOS)
    bstart, bcount = _segments(bdest[bi][bsort], NCAP)
    if max(int(acount.max(initial=1)), int(bcount.max(initial=1))) \
            > mult_cap:
        return None

    # ---- the panel loop's index tables ---------------------------------
    # target columns of panel k: its own PANEL columns, then its union
    # tail (ukey order); column c lands at t = c - k*PANEL inside the
    # panel, else at PANEL + its rank in the tail
    ustart = np.concatenate([[0], np.cumsum(nu)])

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
    c_off = np.searchsorted(ck[hit], np.arange(n_act + 1))

    R_nnz = np.zeros(NCAP, dtype=np.int64)
    R_nnz[:nnodes] = nnz

    return PanelEpochPlan(
        npanb=npanb, kexta=kexta, mult=mult_cap, ladder=ladder, grade=gm,
        perm=perm, astart=astart, acount=acount, bperm=bperm,
        bstart=bstart, bcount=bcount, row_ptr=row_ptr,
        ent_row=_pad(rows_i, kexta, NCAP), ent_slot=_pad(slots_i, kexta, 0),
        ent_col=_pad(cols_i, kexta, 0), a_off=a_off,
        a_row=rows_i - pan_of_row * PANEL, a_t=t_a, c_off=c_off,
        c_src=(row_ptr[prow_c[cent]] + cslot)[hit], c_m=m_loc[hit],
        c_t=t_c[hit], cr_off=pstart[:n_act + 1], crow=prow_c,
        R_idx=pad_idx, R_nnz=R_nnz, pos=pos, order=order)


def panel_inputs(plan: PanelEpochPlan, k: int, PANEL: int, BCAP: int,
                 NCAP: int) -> Tuple[Tuple[int, int], dict]:
    """Panel k's tables padded to its grade (MC, NU): its compact entries
    (a_src, a_dst: their place in the panel's [PANEL, TT] rows, TT = PANEL
    + NU), its contributor entries (c_src, c_dst: their place in the
    [MC, TT] contributor rows) and rows (crow), and its first position.
    Padding reads the zero entry `kexta` and writes the dump slot past the
    rows.  Returns ((MC, NU), ints)."""
    MC, NU = plan.ladder[plan.grade[k]]
    TT = PANEL + NU
    ea, eb = plan.a_off[k], plan.a_off[k + 1]
    ca, cb = plan.c_off[k], plan.c_off[k + 1]
    CCAP = MC * min(BCAP, TT)
    rows = plan.crow[plan.cr_off[k]:plan.cr_off[k + 1]]
    if eb - ea > PANEL * BCAP or cb - ca > CCAP or len(rows) > MC:
        raise RuntimeError("panel tables exceed their grade")
    kx = plan.kexta
    return (MC, NU), dict(
        p0=np.asarray([k * PANEL], dtype=np.int64),
        a_src=_pad(np.arange(ea, eb), PANEL * BCAP, kx),
        a_dst=_pad(plan.a_row[ea:eb] * TT + plan.a_t[ea:eb], PANEL * BCAP,
                   PANEL * TT),
        c_src=_pad(plan.c_src[ca:cb], CCAP, kx),
        c_dst=_pad(plan.c_m[ca:cb] * TT + plan.c_t[ca:cb], CCAP, MC * TT),
        crow=_pad(rows, MC, NCAP))


def _segment_sum(vals, start, count, width: int):
    """out[i] = sum of vals[start[i] : start[i] + count[i]] (in order);
    width is the largest count allowed (the mult cap)."""
    ar = torch.arange(width, device=vals.device)
    tab = (start[:, None] + ar[None, :]).clamp(max=vals.shape[0] - 1)
    mask = ar[None, :] < count[:, None]
    g = torch.where(mask.view(mask.shape + (1,) * (vals.dim() - 1)),
                    vals[tab], 0.0)
    return g.sum(dim=1)


class _Workspace:
    """What the epoch's graphs hand each other: equilibrated A and the
    factor in compact pattern order (one zero entry past kexta: padding
    reads it), y (one zero row past NCAP), the equilibration, the
    diagonal and right-hand side, the linearization points and the SPD
    flag."""

    def __init__(self, ds: DeviceState, kexta: int):
        NCAP = ds.state.shape[0]
        dt, dev = ds.state.dtype, ds.device
        self.A_eq = torch.zeros((kexta + 1, 3, 3), dtype=dt, device=dev)
        self.Rc = torch.zeros_like(self.A_eq)
        self.yv = torch.zeros((NCAP + 1, 3), dtype=dt, device=dev)
        self.dvec = torch.ones((NCAP + 1, 3), dtype=dt, device=dev)
        self.wdiag = torch.ones(3 * NCAP, dtype=dt, device=dev)
        self.bvec = torch.zeros(3 * NCAP, dtype=dt, device=dev)
        self.act3 = torch.zeros(3 * NCAP, dtype=torch.bool, device=dev)
        self.l_point = torch.zeros((NCAP, 3), dtype=dt, device=dev)
        self.spd = torch.ones((), dtype=torch.bool, device=dev)


def _panel_head(ds: DeviceState, T: dict, ws: _Workspace, tikhonov: float,
                mult: int) -> torch.Tensor:
    """Relinearize all, evaluate every factor, assemble A compact on the
    pattern and B by rows (a gather and an in-order segment sum per entry,
    deterministic on the card), and equilibrate, into the workspace."""
    NCAP = ds.state.shape[0]
    dtype, dev = ds.state.dtype, ds.device
    ctl = T["ctl"]
    n = ctl[0]
    pos_new = T["pos"]
    mx = torch.arange(ds.xyt_a.shape[0], device=dev) < ctl[1]
    mp = torch.arange(ds.pos_node.shape[0], device=dev) < ctl[2]
    xa = torch.where(mx, ds.xyt_a, 0)
    xb = torch.where(mx, ds.xyt_b, 0)
    W = torch.where(mx[:, None, None], ds.xyt_W, 0.0)
    pn = torch.where(mp, ds.pos_node, 0)
    pW = torch.where(mp[:, None, None], ds.pos_W, 0.0)
    # ---- relinearize all + batched factor evaluation (aprilsam.c:131-195)
    ws.l_point.copy_(ds.state)
    ev = eval_xyt(ws.l_point, xa, xb, ds.xyt_z, W)
    Haa, Hab, Hba, Hbb, ga, gb = gn_blocks_xyt(ev, W)
    evp = eval_xytpos(ws.l_point, pn, ds.pos_z, pW)
    gp = torch.einsum("fij,fj->fi", pW, evp.r)
    Hoff = torch.where((pos_new[xa] < pos_new[xb])[:, None, None], Hab, Hba)
    z33 = torch.zeros((1, 3, 3), dtype=dtype, device=dev)
    blocks = torch.cat([Haa, Hbb, Hoff, pW, z33])
    bvecs = torch.cat([ga, gb, gp, z33[:, 0]])
    A_comp = _segment_sum(blocks[T["perm"]], T["astart"], T["acount"], mult)
    B_full = _segment_sum(bvecs[T["bperm"]], T["bstart"], T["bcount"], mult)

    # ---- Jacobi equilibration (the dense epoch's D^-1/2 A D^-1/2): the
    # factorization runs on R~ = R D^-1/2 (column scaling), recovered once
    # at the end; y~ equals the true y
    tik = float(tikhonov)
    live = (torch.arange(NCAP, device=dev) < n)[:, None]
    dscal = torch.diagonal(A_comp[T["row_ptr"]], dim1=1, dim2=2) + tik
    ws.dvec[:NCAP] = torch.where(
        live, torch.rsqrt(torch.clamp(dscal, min=1e-30)), 1.0)
    ent_row, ent_col = T["ent_row"], T["ent_col"]
    ws.A_eq[:-1] = (A_comp * ws.dvec[ent_row][:, :, None]) \
        * ws.dvec[ent_col][:, None, :]
    ws.act3.copy_(live.expand(NCAP, 3).reshape(-1))
    # tikhonov in equilibrated units on active rows, 1.0 on padding rows
    ws.wdiag.copy_(torch.where(ws.act3, tik * ws.dvec[:NCAP].reshape(-1) ** 2,
                               1.0))
    ws.bvec.copy_((B_full * ws.dvec[:NCAP]).reshape(-1))
    ws.Rc.zero_()
    ws.yv.zero_()
    ws.spd.fill_(True)
    return ws.spd.reshape(1)


def _panel_step(ws: _Workspace, P: dict, PANEL: int, MC: int,
                NU: int) -> torch.Tensor:
    """One panel of the left-looking factorization and forward solve: the
    dense S = Sd - W^T W of the panel from its contributors' finished rows,
    a Cholesky, two triangular solves (the panel's R rows and its y),
    written back on the pattern, in the workspace."""
    dtype, dev = ws.A_eq.dtype, ws.A_eq.device
    TT = PANEL + NU
    P3 = 3 * PANEL
    r = 3 * P["p0"] + torch.arange(P3, device=dev)
    # the panel's rows of A over its target columns, [P3, 3 TT]
    X = torch.zeros((PANEL * TT + 1, 3, 3), dtype=dtype, device=dev)
    X[P["a_dst"]] = ws.A_eq[P["a_src"]]
    Acomb = X[:-1].view(PANEL, TT, 3, 3).permute(0, 2, 1, 3).reshape(
        P3, 3 * TT)
    Xd = Acomb[:, :P3]
    # the reference's upper-triangle rule at scalar level (aprilsam.c:216-225)
    Sd = torch.triu(Xd) + torch.triu(Xd, 1).T + torch.diag(ws.wdiag[r])
    # the contributors' finished rows over the same columns, [3 MC, 3 TT]
    Wc = torch.zeros((MC * TT + 1, 3, 3), dtype=dtype, device=dev)
    Wc[P["c_dst"]] = ws.Rc[P["c_src"]]
    V = Wc[:-1].view(MC, TT, 3, 3).permute(0, 2, 1, 3).reshape(3 * MC,
                                                               3 * TT)
    Vp = V[:, :P3]
    G = Vp.T @ V
    gy = Vp.T @ ws.yv[P["crow"]].reshape(-1)
    S = Sd - G[:, :P3]
    Su = Acomb[:, P3:] - G[:, P3:]
    by = ws.bvec[r] - gy

    Ls = cholesky_nan(S)
    diag = torch.diagonal(Ls)
    ws.spd &= torch.all(torch.where(ws.act3[r],
                                    torch.isfinite(diag) & (diag > 0), True))
    Rpu = torch.linalg.solve_triangular(Ls, Su, upper=False)
    yP = torch.linalg.solve_triangular(Ls, by[:, None], upper=False)
    Rcomb = torch.cat([torch.triu(Ls.T), Rpu], dim=1)
    R4 = Rcomb.view(PANEL, 3, TT, 3).permute(0, 2, 1, 3).reshape(
        PANEL * TT, 3, 3)
    R4 = torch.cat([R4, torch.zeros((1, 3, 3), dtype=dtype, device=dev)])
    ws.Rc[P["a_src"]] = R4[P["a_dst"]]
    ws.yv[P["p0"] + torch.arange(PANEL, device=dev)] = yP.view(PANEL, 3)
    return ws.spd.reshape(1)


def _panel_tail(ds: DeviceState, T: dict, ws: _Workspace, PANEL: int,
                NPANB: int) -> torch.Tensor:
    """Un-equilibrate onto the block rows, back-substitute (K1), update the
    states; nothing changes where the epoch is dead.  Returns [chi2,
    spd]."""
    NCAP = ds.state.shape[0]
    dev = ds.device
    ctl = T["ctl"]
    n = ctl[0]
    live = n > 0
    # ---- un-equilibrate (R = R~ D^1/2, by columns), onto the block rows
    ds.R_blocks.masked_fill_(live, 0.0)
    full(ds.R_blocks)[T["ent_row"], T["ent_slot"]] = \
        ws.Rc[:-1] / ws.dvec[T["ent_col"]][:, None, :]
    keep_live(live, ws.yv[:NCAP], ds.y)
    # ---- back-substitution (K1) + state update (aprilsam.c:298-315)
    x_pos = panel_backsub(ds.R_blocks, T["R_idx"], ws.yv[:NCAP], n, PANEL,
                          NPANB)
    refresh_states(ds, ws.l_point, x_pos[T["pos"]],
                   torch.arange(NCAP, device=dev) < n)
    keep_live(live, ws.l_point, ds.l_point)
    chi2 = finish_epoch(ds, T)
    return torch.stack([chi2, ws.spd.to(chi2.dtype)])


def _epoch(ds: DeviceState, plan: PanelEpochPlan, ctl: np.ndarray,
           tikhonov: float, PANEL: int, graphs: GraphCache) -> torch.Tensor:
    """The epoch's dispatches: head, one per active panel (at the panel's
    grade), tail; each a graph of `graphs` (eager when disabled)."""
    NCAP, BCAP = ds.R_idx.shape
    npanb = plan.npanb
    ws = graphs.workspace(("panel", npanb),
                          lambda: _Workspace(ds, plan.kexta))
    head = dict(ctl=ctl, perm=plan.perm, astart=plan.astart,
                acount=plan.acount, bperm=plan.bperm, bstart=plan.bstart,
                bcount=plan.bcount, row_ptr=plan.row_ptr,
                ent_row=plan.ent_row, ent_col=plan.ent_col, pos=plan.pos)
    tik, mult = float(tikhonov), plan.mult
    graphs.run(("panel-head", npanb, mult), ds, head, {},
               lambda T: _panel_head(ds, T, ws, tik, mult))
    for k in range(len(plan.grade)):
        (MC, NU), ints = panel_inputs(plan, k, PANEL, BCAP, NCAP)
        graphs.run(("panel", npanb, MC, NU), ds, ints, {},
                   lambda P, MC=MC, NU=NU: _panel_step(ws, P, PANEL, MC, NU))
    tail = dict(ctl=ctl, ent_row=plan.ent_row, ent_slot=plan.ent_slot,
                ent_col=plan.ent_col, R_idx=plan.R_idx, R_nnz=plan.R_nnz,
                pos=plan.pos, order=plan.order)
    out = graphs.run(("panel-tail", npanb), ds, tail, {},
                     lambda T: _panel_tail(ds, T, ws, PANEL, npanb))
    return out.clone()


def panel_epoch_step(ds: DeviceState, plan: PanelEpochPlan, tikhonov: float,
                     PANEL: int, log_mode: int, graphs: GraphCache):
    """The panel epoch on the device, in place: a head (assembly and
    equilibration), one dispatch per active panel, a tail (back-
    substitution through K1, state update); each a replay of its graph in
    `graphs` (eager when disabled).  Returns (chi2, spd) as 0-d
    tensors; no synchronizing call."""
    ctl, ptr_after = epoch_ctl(ds, ds.nnodes, ds.n_xyt, ds.n_pos, log_mode)
    out = _epoch(ds, plan, ctl, tikhonov, PANEL, graphs)
    ds.log_ptr = ptr_after
    return out[0], out[1] > 0.5


def precompile_panel_epoch(ds: DeviceState, cfg: SolverConfig,
                           nnodes_max: int, graphs: GraphCache) -> int:
    """Run the panel epoch's ladder with dead inputs (n = 0), as the JAX
    package compiles it: one head and tail per power-of-two active panel
    count up to nnodes_max's, and one panel step per grade-0 seg_ladder
    grade at each; on the card each captured into `graphs` on `ds`, which the dead epochs leave as it was (the grade-1 caps are
    captured on first use).  Returns the number of panel counts."""
    NCAP = cfg.node_capacity
    BCAP = cfg.row_block_capacity
    PANEL = cfg.panel_nodes
    FCAP = cfg.factor_capacity
    FPOS = max(256, FCAP // 8)
    target = min(_bucket_pow2(max(1, -(-nnodes_max // PANEL)), 1),
                 NCAP // PANEL)
    ar = np.arange(NCAP, dtype=np.int64)
    z = np.zeros(0, dtype=np.int64)
    ctl = np.asarray([0, 0, 0, ds.chi2_log.shape[0]], dtype=np.int64)
    count = 0
    npanb = 1
    while True:
        mc, nu, mult, kexta, nfac3 = panel_caps(npanb, PANEL)
        ladder = seg_ladder(mc, nu)
        plan = PanelEpochPlan(
            npanb=npanb, kexta=kexta, mult=mult, ladder=ladder,
            grade=np.arange(len(ladder)),
            perm=np.full(nfac3, 3 * FCAP + FPOS, dtype=np.int64),
            astart=np.zeros(kexta, dtype=np.int64),
            acount=np.zeros(kexta, dtype=np.int64),
            bperm=np.full(nfac3, 2 * FCAP + FPOS, dtype=np.int64),
            bstart=np.zeros(NCAP, dtype=np.int64),
            bcount=np.zeros(NCAP, dtype=np.int64),
            row_ptr=np.zeros(NCAP, dtype=np.int64),
            ent_row=np.full(kexta, NCAP, dtype=np.int64),
            ent_slot=np.zeros(kexta, dtype=np.int64),
            ent_col=np.zeros(kexta, dtype=np.int64),
            a_off=np.zeros(len(ladder) + 1, dtype=np.int64), a_row=z, a_t=z,
            c_off=np.zeros(len(ladder) + 1, dtype=np.int64), c_src=z,
            c_m=z, c_t=z, cr_off=np.zeros(len(ladder) + 1, dtype=np.int64),
            crow=z, R_idx=np.full((NCAP, BCAP), NCAP, dtype=np.int64),
            R_nnz=np.zeros(NCAP, dtype=np.int64), pos=ar, order=ar)
        _epoch(ds, plan, ctl, cfg.tikhonov, PANEL, graphs)
        count += 1
        if npanb >= target:
            break
        npanb *= 2
    if ds.device.type == "cuda":
        torch.cuda.synchronize(ds.device)
    return count
