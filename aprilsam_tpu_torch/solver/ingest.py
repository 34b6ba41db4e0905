"""Host graph -> device table ingestion (outside the hot path).

Counterpart of ``aprilsam_tpu/solver/ingest.py``: copies the [from_node:)
and [from_factor:) tails of a FactorGraph into the device tables, in place.
The incremental step ingests its own new nodes and factors; this path serves
batch epochs and solver (re)initialization.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import FactorGraph, FACTOR_XYT, FACTOR_XYTPOS
from .config import SolverConfig
from .state import DeviceState


def _t(a, ds: DeviceState, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), device=ds.device,
                           dtype=dtype)


def ingest_graph(
    ds: DeviceState,
    g: FactorGraph,
    cfg: SolverConfig,
    from_node: int,
    from_factor: int,
    to_node: int = None,
    to_factor: int = None,
) -> DeviceState:
    """to_node/to_factor bound the ingested span (default: the whole
    graph)."""
    dt = ds.state.dtype
    n_end = g.nnodes if to_node is None else to_node
    f_end = g.nfactors if to_factor is None else to_factor
    if n_end > cfg.node_capacity:
        raise OverflowError(
            f"{n_end} nodes exceed node_capacity {cfg.node_capacity}")

    if n_end > from_node:
        sl = slice(from_node, n_end)
        ds.state[sl] = _t(g.state[sl], ds, dt)
        ds.l_point[sl] = _t(g.l_point[sl], ds, dt)
        ds.delta_X[sl] = 0.0
        ds.nnodes = n_end

    if f_end > from_factor:
        types = g.ftype[from_factor:f_end]
        nodes = g.fnodes[from_factor:f_end]
        z = g.fz[from_factor:f_end]
        W = g.fW[from_factor:f_end]

        m_xyt = types == FACTOR_XYT
        k = int(np.sum(m_xyt))
        if k:
            n0 = ds.n_xyt
            if n0 + k > ds.xyt_a.shape[0]:
                raise OverflowError("xyt factor capacity exceeded")
            sl = slice(n0, n0 + k)
            ds.xyt_a[sl] = _t(nodes[m_xyt, 0], ds, torch.int64)
            ds.xyt_b[sl] = _t(nodes[m_xyt, 1], ds, torch.int64)
            ds.xyt_z[sl] = _t(z[m_xyt], ds, dt)
            ds.xyt_W[sl] = _t(W[m_xyt], ds, dt)
            ds.n_xyt = n0 + k

        m_pos = types == FACTOR_XYTPOS
        k = int(np.sum(m_pos))
        if k:
            n0 = ds.n_pos
            if n0 + k > ds.pos_node.shape[0]:
                raise OverflowError("xytpos factor capacity exceeded")
            sl = slice(n0, n0 + k)
            ds.pos_node[sl] = _t(nodes[m_pos, 0], ds, torch.int64)
            ds.pos_z[sl] = _t(z[m_pos], ds, dt)
            ds.pos_W[sl] = _t(W[m_pos], ds, dt)
            ds.n_pos = n0 + k

    return ds
