"""Whole-graph panel back-substitution x = R^{-1} y.

Counterpart of ``aprilsam_tpu/kernels/sweep.py:panel_backsub`` (reference:
smatd_utriangle_solve, smatd.c:1075-1097, recast as a reverse panel scan):
the panel diagonal triangles of all active panels are extracted at once and
inverted batched through ``tri_inv`` (kernel K1 on the card); the scan over
panels, last to first, is a sparse gather + one [3P, 3P] matvec per panel.
The JAX package's one-hot einsums become index ops here.
"""

from __future__ import annotations

import torch

from .tri_inv import tri_inv


def panel_backsub(R_blocks, R_idx, y, n: int, PANEL: int,
                  NPANB: int) -> torch.Tensor:
    """Solve R x = y over the first NPANB*PANEL block rows.

    R_blocks [NCAP, BCAP, 3, 3], R_idx [NCAP, BCAP] (sorted, pad NCAP),
    y [NCAP, 3]; n = active block count.  Returns x [NCAP, 3] in POSITION
    space (zeros beyond the active panels)."""
    NCAP = R_blocks.shape[0]
    BCAP = R_idx.shape[1]
    dtype, dev = R_blocks.dtype, R_blocks.device
    NP3 = 3 * PANEL
    NR = NPANB * PANEL

    # T[j, p, c] = block of row p0+p at column p0+c (p0 = j*PANEL); columns
    # outside the panel go to a dump column PANEL
    act_rows = R_blocks[:NR].reshape(NPANB, PANEL, BCAP, 3, 3)
    p0s = torch.arange(NPANB, device=dev).mul_(PANEL).view(NPANB, 1, 1)
    loc = R_idx[:NR].reshape(NPANB, PANEL, BCAP) - p0s
    loc = torch.where((loc >= 0) & (loc < PANEL), loc, PANEL)
    T = torch.zeros(NPANB, PANEL, PANEL + 1, 3, 3, dtype=dtype, device=dev)
    jj = torch.arange(NPANB, device=dev).view(NPANB, 1, 1)
    pp = torch.arange(PANEL, device=dev).view(1, PANEL, 1)
    T[jj, pp, loc] = act_rows
    Td = T[:, :, :PANEL].permute(0, 1, 3, 2, 4).reshape(NPANB, NP3, NP3)
    # identity on inactive rows (positions >= n) keeps every T[j]
    # invertible
    inactive = (torch.arange(NR, device=dev) >= n).repeat_interleave(3)
    Td = Td + torch.diag_embed(inactive.to(dtype).view(NPANB, NP3))

    Tinv = tri_inv(Td.contiguous())

    xb = torch.zeros(NCAP + 1, 3, dtype=dtype, device=dev)
    for j in range(NPANB - 1, -1, -1):
        p0 = j * PANEL
        p1 = p0 + PANEL
        rows = R_blocks[p0:p1]
        idx = R_idx[p0:p1]
        xg = torch.where((idx >= p1)[..., None], xb[idx.clamp(0, NCAP)], 0.0)
        acc = torch.einsum("pbij,pbj->pi", rows, xg)
        rhs = (y[p0:p1] - acc).reshape(NP3)
        rhs = torch.where(inactive[3 * p0:3 * p1], 0.0, rhs)
        xb[p0:p1] = (Tinv[j] @ rhs).reshape(PANEL, 3)
    return xb[:NCAP]
