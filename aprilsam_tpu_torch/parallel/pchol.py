"""Distributed dense Cholesky for the separator system.

Counterpart of ``aprilsam_tpu/parallel/pchol.py``: the separator normal
equations of the Schur domain decomposition (parallel/schur.py), factored
and solved over the ranks with a block-cyclic right-looking algorithm
instead of replicated on each:

  * the padded system (n = nb*b scalars, nb = D*m block rows of width b) is
    reduced with a reduce-scatter over its rows, so each rank holds only
    its m cyclic block rows g = d (mod D), which spreads the late pivots
    (where the trailing update concentrates) over all ranks;
  * per pivot k: the owner's diagonal block is all-reduced, every rank
    computes the b x b Cholesky, solves its own rows' column-k blocks,
    all-gathers the finished column panel and applies the rank-b update to
    its strip's trailing columns;
  * the triangular solves either all-gather the factor once and solve
    replicated ("gathered") or walk the nb pivots with one all-reduce each
    way ("looped").

Conditioning matches the replicated path: Jacobi equilibration
(D^-1/2 A D^-1/2) from an all-gather of the local diagonals.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..solver.batch import cholesky_nan
from .dist import Mesh


@dataclass(frozen=True)
class PCholGeom:
    """Static geometry of the distributed system (host-side)."""

    n_live: int   # meaningful scalars (3 * separator nodes)
    D: int        # ranks
    b: int        # block width (scalars)
    m: int        # block rows per rank
    nb: int       # total block rows = D * m
    n: int        # padded scalar dimension = nb * b


def pchol_geom(n_live: int, D: int, block: int = 128) -> PCholGeom:
    b = int(block)
    m = max(1, -(-n_live // (b * D)))
    nb = D * m
    return PCholGeom(n_live=n_live, D=D, b=b, m=m, nb=nb, n=nb * b)


def layout_rows(geom: PCholGeom, idx: torch.Tensor) -> torch.Tensor:
    """Map global scalar row indices to block-cyclic layout rows.

    Rank d's contiguous reduce-scatter chunk [d*m*b, (d+1)*m*b) holds the
    cyclic block rows {g : g % D == d}, block g at local slot g // D.
    Indices past the live rows map to the sentinel n."""
    g = idx // geom.b
    off = idx % geom.b
    lr = ((g % geom.D) * geom.m + g // geom.D) * geom.b + off
    return torch.where(idx < geom.n_live, lr, geom.n)


def _finalize_strip(geom: PCholGeom, mesh: Mesh, S_strip, tikhonov,
                    eq_jitter=0.0):
    """Add tikhonov on this rank's live diagonal entries and 1 on the
    padding's, and equilibrate.  Returns (strip, dvec, rows_g) with dvec
    the replicated scaling and rows_g the global row of each local row."""
    D, b, m, n = geom.D, geom.b, geom.m, geom.n
    dev = S_strip.device
    gblk = torch.arange(m, device=dev) * D + mesh.rank       # global blocks
    rows_g = (gblk[:, None] * b + torch.arange(b, device=dev)).reshape(-1)
    local = torch.arange(m * b, device=dev)
    diag_add = torch.ones(m * b, dtype=S_strip.dtype, device=dev)
    S_strip[local, rows_g] += diag_add.masked_fill_(rows_g < geom.n_live,
                                                    tikhonov)
    # Jacobi equilibration: local diagonal -> replicated dvec
    dall = torch.empty(D * m * b, dtype=S_strip.dtype, device=dev)
    dist.all_gather_into_tensor(dall, S_strip[local, rows_g].contiguous(),
                                group=mesh.group)
    # global block g = slot * D + rank
    dfull = dall.view(D, m, b).transpose(0, 1).reshape(n)
    dvec = torch.rsqrt(torch.clamp(dfull, min=1e-30))
    S_strip.mul_(dvec[rows_g][:, None]).mul_(dvec[None, :])
    # relative (equilibrated-space) damping: caps the condition number so
    # float32 factorization stays SPD on weakly-anchored separators
    S_strip[local, rows_g] += eq_jitter
    return S_strip, dvec, rows_g


def pchol_solve(
    geom: PCholGeom,
    mesh: Mesh,
    S_strip: torch.Tensor,
    c: torch.Tensor,
    tikhonov=0.0,
    solve_mode: str = "auto",
    gather_limit: int = None,
    eq_jitter: float = 0.0,
) -> torch.Tensor:
    """Solve the reduce-scattered system on every rank: returns x [n].

    `S_strip` is this rank's [m*b, n] block-cyclic row strip of the
    symmetric system (rows placed by `layout_rows`), overwritten by the
    factor; `c` the replicated [n] right-hand side (zeros in the padded
    tail).  solve_mode: "gathered" (one all-gather of the factor, then
    replicated triangular solves; an [n, n] buffer per rank), "looped" (one
    all-reduce per pivot each way; O(n*b) memory), or "auto": gathered up
    to n = gather_limit scalars (default 16384), looped beyond.
    """
    if gather_limit is None:
        gather_limit = 16384
    D, b, m, nb, n = geom.D, geom.b, geom.m, geom.nb, geom.n
    dt, dev = S_strip.dtype, S_strip.device
    d = mesh.rank

    X, dvec, _rows_g = _finalize_strip(geom, mesh, S_strip, tikhonov,
                                       eq_jitter)
    gblk = torch.arange(m, device=dev) * D + d

    # ---- factorization: block-cyclic right-looking ----
    Dblocks = torch.empty((nb, b, b), dtype=dt, device=dev)
    gath = torch.empty((D * m * b, b), dtype=dt, device=dev)
    for k in range(nb):
        owner, slot = k % D, k // D
        cols = slice(k * b, (k + 1) * b)
        if d == owner:
            Akk = X[slot * b:(slot + 1) * b, cols].clone()
        else:
            Akk = torch.zeros((b, b), dtype=dt, device=dev)
        dist.all_reduce(Akk, group=mesh.group)
        Lkk = cholesky_nan(Akk)
        colk = X[:, cols].reshape(m, b, b)
        # L_ik = A_ik Lkk^-T: solve Lkk Y = A_ik^T, transpose
        Lik = torch.linalg.solve_triangular(
            Lkk, colk.transpose(1, 2), upper=False).transpose(1, 2)
        below = (gblk > k)[:, None, None]
        at = (gblk == k)[:, None, None]
        colU = torch.where(below, Lik, 0.0)               # update panel
        X[:, cols] = torch.where(below, Lik, torch.where(at, Lkk, colk)
                                 ).reshape(m * b, b)
        # the finished column panel (blocks > k) from every rank
        dist.all_gather_into_tensor(gath, colU.reshape(m * b, b),
                                    group=mesh.group)
        Lfull = gath.view(D, m, b, b).transpose(0, 1).reshape(n, b)
        # rank-b update of the trailing columns (the panel's rows of
        # blocks <= k are zero, so the columns before them do not change)
        X[:, (k + 1) * b:] -= colU.reshape(m * b, b) @ Lfull[(k + 1) * b:].T
        Dblocks[k] = Lkk

    c = c * dvec

    if solve_mode == "auto":
        solve_mode = "gathered" if n <= gather_limit else "looped"
    if solve_mode == "gathered":
        # one collective: the global factor from the cyclic strips (global
        # block g lives on rank g % D at slot g // D); tril() discards the
        # stale above-diagonal entries the right-looking sweep leaves
        full = torch.empty((D * m * b, n), dtype=dt, device=dev)
        dist.all_gather_into_tensor(full, X, group=mesh.group)
        Lg = torch.tril(full.view(D, m, b, n).transpose(0, 1).reshape(n, n))
        del full
        yg = torch.linalg.solve_triangular(Lg, c[:, None], upper=False)
        xg = torch.linalg.solve_triangular(Lg.T, yg, upper=True)
        return xg[:, 0] * dvec
    if solve_mode != "looped":
        raise ValueError(f"unknown solve_mode {solve_mode!r}")

    # ---- forward solve L y = c (y beyond block k is still zero) ----
    y = torch.zeros(n, dtype=dt, device=dev)
    for k in range(nb):
        owner, slot = k % D, k // D
        if d == owner:
            s = X[slot * b:(slot + 1) * b] @ y
        else:
            s = torch.zeros(b, dtype=dt, device=dev)
        dist.all_reduce(s, group=mesh.group)
        rhs = (c[k * b:(k + 1) * b] - s)[:, None]
        y[k * b:(k + 1) * b] = torch.linalg.solve_triangular(
            Dblocks[k], rhs, upper=False)[:, 0]

    # ---- back solve L^T x = y ----
    x = torch.zeros(n, dtype=dt, device=dev)
    for k in range(nb - 1, -1, -1):
        colk = X[:, k * b:(k + 1) * b].reshape(m, b, b)
        xi = torch.where((gblk > k)[:, None], x.view(nb, b)[gblk], 0.0)
        s = torch.einsum("mij,mi->j", colk, xi)
        dist.all_reduce(s, group=mesh.group)
        rhs = (y[k * b:(k + 1) * b] - s)[:, None]
        x[k * b:(k + 1) * b] = torch.linalg.solve_triangular(
            Dblocks[k].T, rhs, upper=True)[:, 0]
    return x * dvec
