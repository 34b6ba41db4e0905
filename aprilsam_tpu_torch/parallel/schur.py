"""Distributed batch solve by keyframe-block domain decomposition.

Counterpart of ``aprilsam_tpu/parallel/schur.py``, the SLAM analogue of
sequence/context parallelism (SURVEY.md section 2.7): the trajectory is
split into B contiguous keyframe blocks, B/D per rank; each block
eliminates its interior unknowns and contributes a Schur complement on the
separator (the nodes of cross-block factors); the separator system is
reduced over the ranks and solved, and the interiors back-substitute
locally.  An exact decomposition of the Gauss-Newton normal equations:

    [A_II  A_IS] [x_I]   [b_I]         S = sum_b (A_SS_b - A_SI A_II^-1 A_IS)
    [A_SI  A_SS] [x_S] = [b_S]   =>    S x_S = sum_b (b_S_b - A_SI A_II^-1 b_I)
                                       x_I = A_II^-1 (b_I - A_IS x_S)

Each block works in a LOCAL index space of [interior | its own separator
neighborhood], so its dense matrices stay small when the separator is
large.  Rank r takes blocks [r B/D, (r+1) B/D), as the JAX package's
P(axis) split of the block axis does, and runs them in batches of at most
`block_chunk` (the JAX package's lax.map batch size), which bounds the
transient memory of the dense assembly.

Each Gauss-Newton step runs under the torch.profiler range
"schur.gn_step", its parts under "schur.eliminate" (with "schur.assemble"
inside), "schur.separator" and "schur.backsub": schur_stages.py sums the
profiled device time by them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..factors import eval_xyt, eval_xytpos, gn_blocks_xyt, gn_blocks_xytpos
from ..geometry import mod2pi, np_mod2pi
from ..graph import FactorGraph, FACTOR_XYT
from ..solver.batch import cholesky_nan
from ..utils import torch_dtype
from .dist import Mesh
from .pchol import layout_rows, pchol_geom, pchol_solve

@dataclass
class Partition:
    """Host-side partition of a FactorGraph into B trajectory blocks."""

    B: int
    ni_max: int                 # padded interior nodes per block
    ns: int                     # global separator nodes
    nsl: int                    # padded per-block local separator size
    fmax: int
    pmax: int
    sep_nodes: np.ndarray       # [ns] node ids
    interiors: List[np.ndarray] # per-block node ids
    sep_map: np.ndarray         # [B, nsl] global separator slot (pad = ns)
    # padded per-block factor tables in LOCAL index space
    # (interior i -> i, local separator j -> ni_max + j)
    fa: np.ndarray              # [B, fmax]
    fb: np.ndarray
    fz: np.ndarray              # [B, fmax, 3]
    fW: np.ndarray              # [B, fmax, 3, 3]
    fvalid: np.ndarray          # [B, fmax]
    pn: np.ndarray              # [B, pmax]
    pz: np.ndarray
    pW: np.ndarray
    pvalid: np.ndarray

    @property
    def D(self) -> int:
        return self.B


def partition_graph(g: FactorGraph, B: int) -> Partition:
    """Contiguous keyframe-block partition; separator = endpoints of
    cross-block factors; each block sees only its own separator slice."""
    n = g.nnodes
    block_of = np.minimum(np.arange(n) * B // n, B - 1)

    is_sep = np.zeros(n, dtype=bool)
    for f in range(g.nfactors):
        a, b = g.fnodes[f]
        if b >= 0 and block_of[a] != block_of[b]:
            is_sep[a] = True
            is_sep[b] = True

    sep_nodes = np.where(is_sep)[0].astype(np.int32)
    ns = len(sep_nodes)
    sep_slot = np.full(n, -1, dtype=np.int32)
    sep_slot[sep_nodes] = np.arange(ns, dtype=np.int32)

    interiors = [
        np.where((block_of == d) & ~is_sep)[0].astype(np.int32)
        for d in range(B)
    ]
    ni_max = max(1, max((len(i) for i in interiors), default=0))
    int_local = np.full(n, -1, dtype=np.int32)
    for ids in interiors:
        int_local[ids] = np.arange(len(ids), dtype=np.int32)

    # assign factors to the block of their first endpoint; collect each
    # block's separator neighborhood
    per_b_xyt: List[List[int]] = [[] for _ in range(B)]
    per_b_pos: List[List[int]] = [[] for _ in range(B)]
    sep_local_sets: List[dict] = [dict() for _ in range(B)]

    def local_sep(d: int, node: int) -> int:
        m = sep_local_sets[d]
        s = int(sep_slot[node])
        if s not in m:
            m[s] = len(m)
        return m[s]

    for f in range(g.nfactors):
        a, b = (int(v) for v in g.fnodes[f])
        d = int(block_of[a])
        if g.ftype[f] == FACTOR_XYT:
            per_b_xyt[d].append(f)
        else:
            per_b_pos[d].append(f)
        for e in (a, b):
            if e >= 0 and is_sep[e]:
                local_sep(d, e)

    nsl = max(1, max(len(m) for m in sep_local_sets))
    fmax = max(1, max(len(v) for v in per_b_xyt))
    pmax = max(1, max(len(v) for v in per_b_pos))

    sep_map = np.full((B, nsl), ns, dtype=np.int32)
    for d, m in enumerate(sep_local_sets):
        for gs, ls in m.items():
            sep_map[d, ls] = gs

    def loc_of(d: int, node: int) -> int:
        if is_sep[node]:
            return ni_max + sep_local_sets[d][int(sep_slot[node])]
        return int(int_local[node])

    fa = np.zeros((B, fmax), dtype=np.int32)
    fb = np.zeros((B, fmax), dtype=np.int32)
    fz = np.zeros((B, fmax, 3))
    fW = np.zeros((B, fmax, 3, 3))
    fvalid = np.zeros((B, fmax), dtype=bool)
    pn = np.zeros((B, pmax), dtype=np.int32)
    pz = np.zeros((B, pmax, 3))
    pW = np.zeros((B, pmax, 3, 3))
    pvalid = np.zeros((B, pmax), dtype=bool)
    for d in range(B):
        for i, f in enumerate(per_b_xyt[d]):
            a, b = (int(v) for v in g.fnodes[f])
            fa[d, i] = loc_of(d, a)
            fb[d, i] = loc_of(d, b)
            fz[d, i] = g.fz[f]
            fW[d, i] = g.fW[f]
            fvalid[d, i] = True
        for i, f in enumerate(per_b_pos[d]):
            a = int(g.fnodes[f][0])
            pn[d, i] = loc_of(d, a)
            pz[d, i] = g.fz[f]
            pW[d, i] = g.fW[f]
            pvalid[d, i] = True

    return Partition(
        B=B, ni_max=ni_max, ns=ns, nsl=nsl, fmax=fmax, pmax=pmax,
        sep_nodes=sep_nodes, interiors=interiors, sep_map=sep_map,
        fa=fa, fb=fb, fz=fz, fW=fW, fvalid=fvalid,
        pn=pn, pz=pz, pW=pW, pvalid=pvalid,
    )


def _local_states(part: Partition, states: np.ndarray, dtype) -> np.ndarray:
    """[B, ni_max + nsl, 3] per-block local state tables."""
    B, ni = part.B, part.ni_max
    out = np.zeros((B, ni + part.nsl, 3), dtype=dtype)
    if part.ns:
        sep_states = states[part.sep_nodes]
    for d, ids in enumerate(part.interiors):
        out[d, : len(ids)] = states[ids]
        if part.ns:
            valid = part.sep_map[d] < part.ns
            k = int(np.sum(valid))
            out[d, ni : ni + k] = sep_states[part.sep_map[d][valid]]
    return out


def _assemble(st, a, b, z, W, valid, pn, pz, pW):
    """The dense local normal equations of a batch of c blocks: A [c, 3NL,
    3NL] by the reference's upper-mirror rule and Bv [c, 3NL].  Invalid
    xyt rows add into a sentinel node NL that is cut off; padded priors
    carry W = 0 (as in the JAX package)."""
    c, NL = st.shape[0], st.shape[1]
    dev, dt = st.device, st.dtype
    N1 = 3 * (NL + 1)
    off = (torch.arange(c, device=dev) * NL)[:, None]
    pts = st.reshape(c * NL, 3)
    Wf = W.reshape(-1, 3, 3)
    ev = eval_xyt(pts, (a + off).reshape(-1), (b + off).reshape(-1),
                  z.reshape(-1, 3), Wf)
    Haa, Hab, Hba, Hbb, ga, gb = gn_blocks_xyt(ev, Wf)
    sa = torch.where(valid, a, NL)
    sb = torch.where(valid, b, NL)
    Hp, gp = gn_blocks_xytpos(
        eval_xytpos(pts, (pn + off).reshape(-1), pz.reshape(-1, 3),
                    pW.reshape(-1, 3, 3)), pW.reshape(-1, 3, 3))

    dense = torch.zeros((c, N1, N1), dtype=dt, device=dev)
    Bv = torch.zeros((c, N1), dtype=dt, device=dev)
    i3 = torch.arange(3, device=dev)
    blk = torch.arange(c, device=dev)[:, None, None, None]
    for pr, pc, H in ((sa, sa, Haa), (sa, sb, Hab), (sb, sa, Hba),
                      (sb, sb, Hbb), (pn, pn, Hp)):
        rows = (3 * pr)[:, :, None, None] + i3[:, None]
        cols = (3 * pc)[:, :, None, None] + i3
        dense.view(-1).index_add_(0, ((blk * N1 + rows) * N1 + cols)
                                  .reshape(-1), H.reshape(-1))
    for pr, gv in ((sa, ga), (sb, gb), (pn, gp)):
        idx = torch.arange(c, device=dev)[:, None, None] * N1 \
            + (3 * pr)[:, :, None] + i3
        Bv.view(-1).index_add_(0, idx.reshape(-1), gv.reshape(-1))

    A = dense[:, :3 * NL, :3 * NL]
    A.triu_()
    A += A.mT.tril(-1)
    return A, Bv[:, :3 * NL]


def default_sep_dist(part: Partition, D: int, sep_block: int = 128) -> bool:
    """The separator mode schur_solve picks on D ranks (sep_dist=None):
    block-cyclic once 3 ns reaches 4 block rows per rank."""
    return part.ns > 0 and 3 * part.ns >= 4 * sep_block * D


def schur_solve(
    mesh: Mesh,
    g: FactorGraph,
    part: Partition,
    gn_iters: int = 2,
    tikhonov: float = 1e-4,
    dtype=np.float32,
    sep_dist: bool | None = None,
    sep_block: int = 128,
    block_chunk: int = 8,
    eq_jitter: float | None = None,
) -> np.ndarray:
    """Distributed Gauss-Newton: returns the optimized states [n, 3]
    (float64), the same on every rank.

    `sep_dist` selects how the separator system is solved: False =
    replicated dense Cholesky on every rank; True = block-cyclic
    distributed Cholesky (parallel/pchol); None = distributed once 3*ns
    reaches 4 block rows per rank.  `eq_jitter` is a relative
    (equilibrated-space) damping added to every Cholesky: interior blocks
    are long odometry chains anchored only through the separator, marginal
    for float32 at thousands of poses.  Default 1e-5 for float32, 0 for
    float64.  `block_chunk` bounds how many blocks assemble and eliminate
    at once; the interior factors (Ls, Wm, u_I) of all of this rank's
    blocks are kept for back-substitution.
    """
    B = part.B
    ni = part.ni_max
    ns = max(part.ns, 1)
    nsl = part.nsl
    nI, nS = 3 * ni, 3 * nsl
    dt = torch_dtype(dtype)
    dev = mesh.device
    D = mesh.size
    if B % D:
        raise ValueError(f"block count {B} is not a multiple of the {D} "
                         "ranks")
    Bl = B // D
    mine = slice(mesh.rank * Bl, (mesh.rank + 1) * Bl)

    if eq_jitter is None:
        eq_jitter = 1e-5 if dt == torch.float32 else 0.0
    if sep_dist is None:
        sep_dist = default_sep_dist(part, D, sep_block)
    geom = pchol_geom(3 * part.ns, D, block=sep_block) if sep_dist else None
    nsys = geom.n if sep_dist else 3 * ns

    def up(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a[mine]), device=dev,
                               dtype=dtype)

    fa, fb = up(part.fa, torch.int64), up(part.fb, torch.int64)
    fz, fW = up(part.fz, dt), up(part.fW, dt)
    fv = up(part.fvalid)
    pn = up(part.pn, torch.int64)
    pz, pW = up(part.pz, dt), up(part.pW, dt)
    smap = up(part.sep_map, torch.int64)
    i3 = torch.arange(3, device=dev)
    sep_ok = (smap < ns)[:, :, None].expand(Bl, nsl, 3).reshape(Bl, nS)
    if sep_dist:
        # padded block-cyclic layout: scalar columns, permuted rows
        gcol = torch.where(sep_ok, (3 * torch.where(smap < ns, smap, 0)
                                    [:, :, None] + i3).reshape(Bl, nS),
                           geom.n)
        grow = layout_rows(geom, gcol)
        sys_ok = grow < geom.n        # (no live rows at all when ns == 0)
    else:
        gcol = grow = (3 * torch.where(smap < ns, smap, ns)[:, :, None]
                       + i3).reshape(Bl, nS)
        sys_ok = sep_ok
    # destinations in the flat system; a sentinel slot past the end takes
    # the padding
    s_dst = torch.where(sys_ok[:, :, None] & sys_ok[:, None, :],
                        grow[:, :, None] * nsys + gcol[:, None, :],
                        nsys * nsys)
    c_dst = torch.where(sys_ok, gcol, nsys)
    gix = (3 * torch.clamp(smap, 0, ns - 1)[:, :, None] + i3).reshape(Bl, nS)

    def gn_step(loc):
        Ls = torch.empty((Bl, nI, nI), dtype=dt, device=dev)
        Wm = torch.empty((Bl, nI, nS), dtype=dt, device=dev)
        u_I = torch.empty((Bl, nI), dtype=dt, device=dev)
        dvec = torch.empty((Bl, nI), dtype=dt, device=dev)
        S_flat = torch.zeros(nsys * nsys + 1, dtype=dt, device=dev)
        c_flat = torch.zeros(nsys + 1, dtype=dt, device=dev)
        with record_function("schur.eliminate"):
            for c0 in range(0, Bl, block_chunk):
                k = slice(c0, min(c0 + block_chunk, Bl))
                with record_function("schur.assemble"):
                    A, Bv = _assemble(loc[k], fa[k], fb[k], fz[k], fW[k],
                                      fv[k], pn[k], pz[k], pW[k])
                A_II = A[:, :nI, :nI]
                A_II.diagonal(dim1=1, dim2=2).add_(tikhonov)
                dv = torch.rsqrt(torch.clamp(
                    torch.diagonal(A_II, dim1=1, dim2=2), min=1e-30))
                A_II.mul_(dv[:, :, None]).mul_(dv[:, None, :])
                A_II.diagonal(dim1=1, dim2=2).add_(eq_jitter)
                L = cholesky_nan(A_II)
                W_c = torch.linalg.solve_triangular(
                    L, dv[:, :, None] * A[:, :nI, nI:], upper=False)
                u_c = torch.linalg.solve_triangular(
                    L, (dv * Bv[:, :nI])[:, :, None], upper=False)
                S_loc = A[:, nI:, nI:] - W_c.mT @ W_c
                c_loc = Bv[:, nI:] - (W_c.mT @ u_c)[:, :, 0]
                S_flat.index_add_(0, s_dst[k].reshape(-1),
                                  S_loc.reshape(-1))
                c_flat.index_add_(0, c_dst[k].reshape(-1),
                                  c_loc.reshape(-1))
                Ls[k], Wm[k], u_I[k], dvec[k] = L, W_c, u_c[:, :, 0], dv
                del A, Bv, L, W_c, S_loc

        with record_function("schur.separator"):
            if sep_dist:
                # reduce-scatter the padded separator system into
                # block-cyclic row strips, then factor and solve it
                # distributed
                S_strip = torch.empty((geom.m * geom.b, geom.n), dtype=dt,
                                      device=dev)
                dist.reduce_scatter_tensor(
                    S_strip, S_flat[:nsys * nsys].view(nsys, nsys),
                    group=mesh.group)
                del S_flat
                dist.all_reduce(c_flat, group=mesh.group)
                x = pchol_solve(geom, mesh, S_strip, c_flat[:nsys],
                                tikhonov=tikhonov, eq_jitter=eq_jitter)
                x_S = x[:3 * ns]
            else:
                dist.all_reduce(S_flat, group=mesh.group)
                dist.all_reduce(c_flat, group=mesh.group)
                S = S_flat[:nsys * nsys].view(nsys, nsys)
                S.diagonal().add_(tikhonov)
                ds2 = torch.rsqrt(torch.clamp(torch.diagonal(S),
                                              min=1e-30))
                S.mul_(ds2[:, None]).mul_(ds2[None, :])
                S.diagonal().add_(eq_jitter)
                Lsep = cholesky_nan(S)
                ysep = torch.linalg.solve_triangular(
                    Lsep, (ds2 * c_flat[:nsys])[:, None], upper=False)
                x_S = ds2 * torch.linalg.solve_triangular(
                    Lsep.T, ysep, upper=True)[:, 0]

        # back-substitution of this rank's interiors
        with record_function("schur.backsub"):
            xs_loc = torch.where(sep_ok, x_S[gix], 0.0)
            new_int = torch.empty((Bl, ni, 3), dtype=dt, device=dev)
            for c0 in range(0, Bl, block_chunk):
                k = slice(c0, min(c0 + block_chunk, Bl))
                rhs = u_I[k] - (Wm[k] @ xs_loc[k][:, :, None])[:, :, 0]
                x_I = dvec[k] * torch.linalg.solve_triangular(
                    Ls[k].mT, rhs[:, :, None], upper=True)[:, :, 0]
                new = loc[k, :ni] + x_I.view(-1, ni, 3)
                new[:, :, 2] = mod2pi(new[:, :, 2])
                new_int[k] = new
            everyone = torch.empty((B, ni, 3), dtype=dt, device=dev)
            dist.all_gather_into_tensor(everyone, new_int, group=mesh.group)
        return everyone.cpu().numpy(), x_S.cpu().numpy()

    states = g.state[: g.nnodes].astype(np.float64).copy()
    for _ in range(gn_iters):
        loc = torch.as_tensor(_local_states(part, states, dtype)[mine],
                              device=dev)
        with record_function("schur.gn_step"):
            new_int, x_S = gn_step(loc)
        for d, ids in enumerate(part.interiors):
            states[ids] = new_int[d, : len(ids)].astype(np.float64)
        if part.ns:
            sep = states[part.sep_nodes] + np.asarray(
                x_S, dtype=np.float64).reshape(ns, 3)[: part.ns]
            sep[:, 2] = np_mod2pi(sep[:, 2])
            states[part.sep_nodes] = sep
    return states
