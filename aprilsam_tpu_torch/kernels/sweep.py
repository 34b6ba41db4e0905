"""Panel back-substitution x = R^{-1} y: over the whole graph, or over a
window of panels.

Counterpart of ``aprilsam_tpu/kernels/sweep.py`` (reference:
smatd_utriangle_solve, smatd.c:1075-1097, recast as a reverse panel scan):
the panel diagonal triangles are extracted at once and inverted batched
through ``tri_inv`` (kernel K1 on the card); the scan over panels, last to
first, is a sparse gather + one [3P, 3P] matvec per panel.  The JAX
package's one-hot einsums become index ops here.  Where the JAX package's
windowed sweep solves each window panel's triangle inside its scan, the
port inverts the window's triangles in one ``tri_inv`` call before the
loop: a triangle depends on R only, not on x.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .tri_inv import tri_inv


def _panel_triangles(rows, idx, p0s, inactive) -> torch.Tensor:
    """Td [B, 3P, 3P]: the diagonal triangle of each of B panels, from the
    panel's block rows rows [B, P, BCAP, 3, 3] and their columns
    idx [B, P, BCAP] (the panel starts at position p0s [B, 1, 1]), with
    identity on the inactive scalar rows inactive [B, 3P] (which keeps
    every triangle invertible)."""
    B, PANEL = rows.shape[:2]
    NP3 = 3 * PANEL
    dtype, dev = rows.dtype, rows.device
    # T[j, p, c] = block of row p0+p at column p0+c; columns outside the
    # panel go to a dump column PANEL
    loc = idx - p0s
    loc = torch.where((loc >= 0) & (loc < PANEL), loc, PANEL)
    T = torch.zeros(B, PANEL, PANEL + 1, 3, 3, dtype=dtype, device=dev)
    jj = torch.arange(B, device=dev).view(B, 1, 1)
    pp = torch.arange(PANEL, device=dev).view(1, PANEL, 1)
    T[jj, pp, loc] = rows
    Td = T[:, :, :PANEL].permute(0, 1, 3, 2, 4).reshape(B, NP3, NP3)
    return Td + torch.diag_embed(inactive.to(dtype))


def _panel_rhs(R_blocks, R_idx, y, xb, p0: int, p1: int) -> torch.Tensor:
    """y - (the panel's products with x beyond the panel), [3P]."""
    NCAP = R_blocks.shape[0]
    rows = R_blocks[p0:p1]
    idx = R_idx[p0:p1]
    xg = torch.where((idx >= p1)[..., None], xb[idx.clamp(0, NCAP)], 0.0)
    acc = torch.einsum("pbij,pbj->pi", rows, xg)
    return (y[p0:p1] - acc).reshape(-1)


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

    p0s = torch.arange(NPANB, device=dev).mul_(PANEL).view(NPANB, 1, 1)
    # rows at positions >= n are inactive
    inactive = (torch.arange(NR, device=dev) >= n).repeat_interleave(3)
    Td = _panel_triangles(
        R_blocks[:NR].reshape(NPANB, PANEL, BCAP, 3, 3),
        R_idx[:NR].reshape(NPANB, PANEL, BCAP), p0s,
        inactive.view(NPANB, NP3))

    Tinv = tri_inv(Td.contiguous())

    xb = torch.zeros(NCAP + 1, 3, dtype=dtype, device=dev)
    for j in range(NPANB - 1, -1, -1):
        p0 = j * PANEL
        p1 = p0 + PANEL
        rhs = _panel_rhs(R_blocks, R_idx, y, xb, p0, p1)
        rhs = torch.where(inactive[3 * p0:3 * p1], 0.0, rhs)
        xb[p0:p1] = (Tinv[j] @ rhs).reshape(PANEL, 3)
    return xb[:NCAP]


def panel_backsub_windowed(R_blocks, R_idx, y, x_prev, panels,
                           live: Sequence[int], n: int,
                           PANEL: int) -> torch.Tensor:
    """Back-substitution restricted to a WINDOW of panels — the analogue of
    the reference's pruned tree-gated descent (solve_node,
    aprilsam.c:721-779): only the listed panels' x is recomputed; pattern
    columns landing outside the window read the previous solution x_prev.

    `panels` [PW] (int64 tensor) holds DESCENDING panel indices, padded at
    the end with -1; `live` holds the same indices without the padding, on
    the host
    (the loop runs over them).  x_prev [NCAP, 3] is the previous solution
    in POSITION space.  Because affected sets are ancestor-closed and R-row
    patterns only reference etree ancestors, the recomputed x is exact for
    every affected position when the window covers the affected panels;
    positions outside the window, and inactive rows (>= n) inside it, keep
    x_prev.  The PW window triangles (identity for padding) are inverted in
    one ``tri_inv`` call [PW, 3P, 3P].  Returns x [NCAP, 3]."""
    NCAP = R_blocks.shape[0]
    PW = panels.shape[0]
    dtype, dev = R_blocks.dtype, R_blocks.device

    pad = panels < 0
    p0s = panels.clamp(min=0) * PANEL
    prow = p0s[:, None] + torch.arange(PANEL, device=dev)          # [PW, P]
    keep = (~pad).to(dtype).view(PW, 1, 1, 1, 1)
    inactive = ((prow >= n) | pad[:, None]).repeat_interleave(3, dim=1)
    Td = _panel_triangles(R_blocks[prow] * keep, R_idx[prow],
                          p0s.view(PW, 1, 1), inactive)
    Tinv = tri_inv(Td.contiguous())

    xb = torch.cat([x_prev, torch.zeros(1, 3, dtype=dtype, device=dev)])
    for i, j in enumerate(live):
        p0 = int(j) * PANEL
        p1 = p0 + PANEL
        n_act = min(max(n - p0, 0), PANEL)      # active rows: a prefix
        rhs = _panel_rhs(R_blocks, R_idx, y, xb, p0, p1)
        rhs = torch.where(inactive[i], 0.0, rhs)
        xp = (Tinv[i] @ rhs).reshape(PANEL, 3)
        xb[p0:p0 + n_act] = xp[:n_act]
    return xb[:NCAP]
