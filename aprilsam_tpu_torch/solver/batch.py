"""Batch Gauss-Newton solver on the host backend.

Counterpart of the host-backend part of ``aprilsam_tpu/solver/batch.py``
(april_graph_cholesky, reference aprilsam.c:87-375): the epoch itself runs
in native float64 (host_batch.py).  The JAX package's device epochs (dense
and panel) are not ported yet; selecting them raises NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..graph import FactorGraph
from ..utils import resolve_device, setup_precision
from .config import SolverConfig
from .state import init_device_state, state_chi2
from .symbolic import SymbolicState


class PanelFallbackError(RuntimeError):
    """Panel epoch plan exceeded its derived capacities AND the dense
    bucketed fallback would not fit device memory — the caller should use
    the float64 host epoch for this round."""


class BatchInfo(NamedTuple):
    chi2: float
    spd: bool
    n: int


class BatchSolver:
    """One-shot batch Gauss-Newton solver over a FactorGraph — the
    counterpart of calling april_graph_cholesky directly (batch-only mode,
    examples/aprilsam_demo.c:224-228)."""

    def __init__(self, cfg: Optional[SolverConfig] = None, device="cuda"):
        self.cfg = cfg or SolverConfig()
        self.cfg.check_ported()
        self.device = resolve_device(device)
        setup_precision()
        self.ds = init_device_state(self.cfg, self.device)
        self.sym: Optional[SymbolicState] = None
        self._ingested_nodes = 0
        self._ingested_factors = 0

    def _ingest(self, g: FactorGraph):
        """Copy new nodes/factors from the host graph into device tables."""
        from .ingest import ingest_graph

        self.ds = ingest_graph(
            self.ds, g, self.cfg, self._ingested_nodes, self._ingested_factors)
        self._ingested_nodes = g.nnodes
        self._ingested_factors = g.nfactors

    def solve(self, g: FactorGraph) -> BatchInfo:
        if g.nnodes == 0 or g.nfactors == 0:
            return BatchInfo(chi2=0.0, spd=True, n=0)  # aprilsam.c:90-91
        self._ingest(g)
        from .host_batch import host_batch_epoch

        nf = g.nfactors
        self.ds, self.sym, info = host_batch_epoch(
            self.ds, self.cfg, g.nnodes, g.ftype[:nf], g.fnodes[:nf],
            g.fz[:nf], g.fW[:nf])
        return info

    def chi2(self) -> float:
        return float(state_chi2(self.ds))

    def sync_states(self, g: FactorGraph) -> None:
        n = g.nnodes
        g.state[:n] = self.ds.state[:n].cpu().numpy().astype(np.float64)
        g.l_point[:n] = self.ds.l_point[:n].cpu().numpy().astype(np.float64)
        g.delta_X[:n] = self.ds.delta_X[:n].cpu().numpy().astype(np.float64)


__all__ = ["BatchInfo", "BatchSolver", "PanelFallbackError"]
