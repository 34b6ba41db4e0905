"""Batched factor evaluation — the linearization code of the port.

PyTorch counterpart of ``aprilsam_tpu/factors.py`` (reference:
xyt_factor_eval, april_graph_xyt.c:62-124; xytpos_factor_eval,
april_graph_xytpos.c:63-102): all factors of a type are evaluated in one
pass over [F, ...] tables.

Conventions (as in the JAX package):
  * residual r = z - zhat, with mod2pi on the theta component;
  * chi2 = r^T W r with W used exactly as stored (no symmetrization);
  * xyt Jacobians J_a = d zhat / d pose_a, J_b = d zhat / d pose_b
    (april_graph_xyt.c:90-100);
  * xytpos: J = I3, residual z - state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import mod2pi


class XytEval(NamedTuple):
    r: torch.Tensor      # [F, 3] residuals
    Ja: torch.Tensor     # [F, 3, 3] d zhat / d pose_a
    Jb: torch.Tensor     # [F, 3, 3] d zhat / d pose_b
    chi2: torch.Tensor   # [F]


def eval_xyt(points, a_idx, b_idx, z, W) -> XytEval:
    """Linearize xyt (relative SE(2)) factors at `points` [N, 3]; a_idx,
    b_idx [F] endpoint indices, z [F, 3], W [F, 3, 3]."""
    pa = points[a_idx]
    pb = points[b_idx]
    ta = pa[:, 2]
    ca, sa = torch.cos(ta), torch.sin(ta)
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]

    zhat = torch.stack([ca * dx + sa * dy, -sa * dx + ca * dy, pb[:, 2] - ta],
                       dim=-1)
    r = z - zhat
    r = torch.cat([r[:, :2], mod2pi(r[:, 2:3])], dim=1)

    zeros = torch.zeros_like(ca)
    ones = torch.ones_like(ca)
    Ja = torch.stack(
        [
            torch.stack([-ca, -sa, -sa * dx + ca * dy], dim=-1),
            torch.stack([sa, -ca, -ca * dx - sa * dy], dim=-1),
            torch.stack([zeros, zeros, -ones], dim=-1),
        ],
        dim=-2,
    )
    Jb = torch.stack(
        [
            torch.stack([ca, sa, zeros], dim=-1),
            torch.stack([-sa, ca, zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    Wr = torch.einsum("fij,fj->fi", W, r)
    chi2 = torch.einsum("fi,fi->f", r, Wr)
    return XytEval(r=r, Ja=Ja, Jb=Jb, chi2=chi2)


class XytposEval(NamedTuple):
    r: torch.Tensor      # [F, 3]
    chi2: torch.Tensor   # [F]


def eval_xytpos(states, idx, z, W) -> XytposEval:
    """Absolute-pose prior factors at `states` (J = I3, never formed)."""
    r = z - states[idx]
    r = torch.cat([r[:, :2], mod2pi(r[:, 2:3])], dim=1)
    Wr = torch.einsum("fij,fj->fi", W, r)
    chi2 = torch.einsum("fi,fi->f", r, Wr)
    return XytposEval(r=r, chi2=chi2)


def gn_blocks_xyt(ev: XytEval, W):
    """Gauss-Newton blocks (Haa, Hab, Hba, Hbb, ga, gb) of xyt factors:
    H.. = J_.^T W J_. [F, 3, 3], g. = J_.^T W r [F, 3]."""
    JaW = torch.einsum("fki,fkl->fil", ev.Ja, W)
    JbW = torch.einsum("fki,fkl->fil", ev.Jb, W)
    Haa = torch.einsum("fil,flj->fij", JaW, ev.Ja)
    Hab = torch.einsum("fil,flj->fij", JaW, ev.Jb)
    Hba = torch.einsum("fil,flj->fij", JbW, ev.Ja)
    Hbb = torch.einsum("fil,flj->fij", JbW, ev.Jb)
    ga = torch.einsum("fil,fl->fi", JaW, ev.r)
    gb = torch.einsum("fil,fl->fi", JbW, ev.r)
    return Haa, Hab, Hba, Hbb, ga, gb


def gn_blocks_xytpos(ev: XytposEval, W):
    """Gauss-Newton blocks of prior factors: H = W (J = I), g = W r."""
    return W, torch.einsum("fij,fj->fi", W, ev.r)


def _quad_form(W, r0, r1, r2):
    """sum_ij W_ij r_i r_j with W used exactly as stored."""
    return (W[:, 0, 0] * r0 * r0 + W[:, 1, 1] * r1 * r1
            + W[:, 2, 2] * r2 * r2
            + (W[:, 0, 1] + W[:, 1, 0]) * r0 * r1
            + (W[:, 0, 2] + W[:, 2, 0]) * r0 * r2
            + (W[:, 1, 2] + W[:, 2, 1]) * r1 * r2)


def graph_chi2(states, xyt_a, xyt_b, xyt_z, xyt_W, pos_idx, pos_z, pos_W,
               xyt_mask=None, pos_mask=None):
    """Total graph chi2 at `states` with the reference's 0.5x (xyt) / 1.0x
    (xytpos) convention (april_graph_chi2, april_graph.c:79-98).  The
    tables are the live factors, or whole tables with the boolean row
    masks xyt_mask / pos_mask of their live rows (the JAX package's form,
    which captured code takes: its shapes cannot follow the counts)."""
    pa = states[xyt_a]
    pb = states[xyt_b]
    ta = pa[:, 2]
    ca, sa = torch.cos(ta), torch.sin(ta)
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    r0 = xyt_z[:, 0] - (ca * dx + sa * dy)
    r1 = xyt_z[:, 1] - (-sa * dx + ca * dy)
    r2 = mod2pi(xyt_z[:, 2] - (pb[:, 2] - ta))
    qx = _quad_form(xyt_W, r0, r1, r2)
    s = states[pos_idx]
    r0 = pos_z[:, 0] - s[:, 0]
    r1 = pos_z[:, 1] - s[:, 1]
    r2 = mod2pi(pos_z[:, 2] - s[:, 2])
    qp = _quad_form(pos_W, r0, r1, r2)
    if xyt_mask is not None:
        qx = torch.where(xyt_mask, qx, 0.0)
        qp = torch.where(pos_mask, qp, 0.0)
    return 0.5 * torch.sum(qx) + torch.sum(qp)
