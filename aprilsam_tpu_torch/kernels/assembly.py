"""Normal-equation assembly: batched factor evaluation, then a block
scatter-add into the dense normal equations.

Counterpart of ``aprilsam_tpu/kernels/assembly.py`` (reference: the
per-factor assembly loop, aprilsam.c:152-195).  All factors of a type are
linearized in one pass (factors.py) and their 3x3 Gauss-Newton blocks are
added into the dense [3MB, 3MB] matrix with one ``index_add_`` over the
flattened scalar indices; the JAX package's windowed ``lax.scatter`` forms
are a TPU workaround and are not copied.  The reference's upper-triangle
rule is kept exactly: only scalar entries with row <= col survive and are
mirrored (aprilsam.c:169-178, 216-225), so with an upper-triangular W (as
the M3500 loader fills it) the lower J^T W J contribution is discarded, not
symmetrized.
"""

from __future__ import annotations

import torch

from ..factors import eval_xyt, eval_xytpos, gn_blocks_xyt, gn_blocks_xytpos


def _add_blocks(dense, n3: int, pr, pc, H) -> None:
    """dense[3 pr + i, 3 pc + j] += H[f, i, j] for every factor f."""
    i3 = torch.arange(3, device=dense.device)
    rows = (3 * pr)[:, None, None] + i3[None, :, None]
    cols = (3 * pc)[:, None, None] + i3[None, None, :]
    dense.view(-1).index_add_(0, (rows * n3 + cols).reshape(-1),
                              H.reshape(-1))


def assemble_block_dense(l_points, states, pos, xyt_a, xyt_b, xyt_z, xyt_W,
                         pos_node, pos_z, pos_W, MB: int, tikhonov: float):
    """The dense normal equations in position space, at block dimension MB.

    l_points/states [NCAP, 3] (xytpos priors read the states), pos [NCAP]
    node id -> position; the factor tables hold the live factors only (the
    JAX package masks padded tables instead).  Returns A [3MB, 3MB],
    symmetric by the upper mirror with tikhonov on the whole diagonal
    (padding rows included, so they stay SPD), and B [3MB]."""
    n3 = 3 * MB
    dtype, dev = l_points.dtype, l_points.device
    dense = torch.zeros((n3, n3), dtype=dtype, device=dev)
    B = torch.zeros((MB, 3), dtype=dtype, device=dev)

    if xyt_a.shape[0]:
        ev = eval_xyt(l_points, xyt_a, xyt_b, xyt_z, xyt_W)
        Haa, Hab, Hba, Hbb, ga, gb = gn_blocks_xyt(ev, xyt_W)
        pa, pb = pos[xyt_a], pos[xyt_b]
        _add_blocks(dense, n3, pa, pa, Haa)
        _add_blocks(dense, n3, pa, pb, Hab)
        _add_blocks(dense, n3, pb, pa, Hba)
        _add_blocks(dense, n3, pb, pb, Hbb)
        B.index_add_(0, pa, ga)
        B.index_add_(0, pb, gb)

    if pos_node.shape[0]:
        H, g = gn_blocks_xytpos(eval_xytpos(states, pos_node, pos_z, pos_W),
                                pos_W)
        pp = pos[pos_node]
        _add_blocks(dense, n3, pp, pp, H)
        B.index_add_(0, pp, g)

    # the upper mirror in place (one temporary of the matrix's size)
    dense.triu_()
    dense.add_(torch.tril(dense.T, -1))
    dense.diagonal().add_(tikhonov)
    return dense, B.reshape(n3)
