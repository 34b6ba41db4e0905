"""Batch Gauss-Newton epochs: the host epoch, the dense device epoch and the
panel device epoch, and BatchSolver.

Counterpart of ``aprilsam_tpu/solver/batch.py`` (april_graph_cholesky,
reference aprilsam.c:87-375):

  host:   symbolic adjacency -> fill-reducing ordering -> block symbolic
          factorization (patterns + etree), in native C;
  device: relinearize all nodes -> batched factor evaluation -> block
          scatter-add of A, B -> + tikhonov -> Jacobi equilibration ->
          dense (bucketed) Cholesky -> forward solve (y is kept, as the
          reference keeps param->y, aprilsam.c:293-298) -> back solve ->
          update every state -> the block-sparse R rows gathered out of the
          dense factor on the symbolic pattern.

``batch_backend`` picks the epoch: "host" and "auto" run the native float64
host epoch (host_batch.py), "device" the dense epoch here, "panel" the
left-looking panel epoch (panel_epoch.py), which falls back to the dense one
when the graph exceeds its capacities, and raises PanelFallbackError when
the dense one would not fit either.  The port passes the epoch's integer
tables to the device in one pinned copy; the JAX package's int16-packed
upload vector is not copied.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import mod2pi
from ..graph import FactorGraph
from ..kernels.assembly import assemble_block_dense
from ..utils import resolve_device, setup_precision
from .config import SolverConfig
from .state import DeviceState, init_device_state, state_chi2, upload
from .symbolic import SymbolicState


class PanelFallbackError(RuntimeError):
    """Panel epoch plan exceeded its derived capacities AND the dense
    bucketed fallback would not fit device memory — the caller should use
    the float64 host epoch for this round."""


class BatchInfo(NamedTuple):
    chi2: float
    spd: bool
    n: int


def node_bucket(n: int, cap: int) -> int:
    b = 256
    while b < n:
        b *= 2
    return min(b, cap)


def cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.cholesky's contract on top of torch.linalg.cholesky_ex
    (which raises where jnp returns NaN): each factor of the batch is
    wholly NaN where its matrix was not SPD (info > 0), so a partial factor
    cannot leak past the NaN guards.  No synchronization."""
    L, info = torch.linalg.cholesky_ex(A)
    return L.masked_fill_((info > 0)[..., None, None], float("nan"))


def refresh_states(ds: DeviceState, l_point: torch.Tensor,
                   dx: torch.Tensor) -> None:
    """state = l_point + dx (theta wrapped) and delta_X = dx for the live
    nodes whose dx [n, 3] has no NaN; the others keep theirs
    (xyt_node_update, april_graph_xyt.c:302-314)."""
    n = dx.shape[0]
    ok = ~torch.any(torch.isnan(dx), dim=1, keepdim=True)
    new = l_point[:n] + dx
    new = torch.cat([new[:, :2], mod2pi(new[:, 2:])], dim=1)
    ds.state[:n] = torch.where(ok, new, ds.state[:n])
    ds.delta_X[:n] = torch.where(ok, dx, ds.delta_X[:n])


def finish_epoch(ds: DeviceState, T: Dict[str, torch.Tensor],
                 log_mode: int) -> torch.Tensor:
    """The tail every device epoch shares: the new pattern, ordering and
    zeroed counters; the chi2 (zero with log_mode 2, where nobody reads
    it); the metric ring: 0 appends, 1 overwrites the newest entry (a
    fallback epoch replaces the chi2 of its triggering step), 2 leaves it
    alone."""
    ds.R_idx.copy_(T["R_idx"])
    ds.R_nnz.copy_(T["R_nnz"])
    ds.pos.copy_(T["pos"])
    ds.order.copy_(T["order"])
    ds.relinearized.zero_()
    ds.start_over.zero_()
    ds.spd_ok.fill_(True)
    if log_mode == 2:
        return torch.zeros((), dtype=ds.state.dtype, device=ds.device)
    chi2 = state_chi2(ds)
    ptr = max(ds.log_ptr - (log_mode == 1), 0)
    if ptr < ds.chi2_log.shape[0]:
        ds.chi2_log[ptr] = chi2
    ds.log_ptr = ptr + 1
    return chi2


def _batch_step(ds: DeviceState, T: Dict[str, torch.Tensor], tikhonov: float,
                MB: int, gn_iters: int, log_mode: int):
    """The dense epoch on the device, in place.  T holds the uploaded
    tables: the new pattern R_idx/R_nnz, pos/order, and the extraction map
    (ext_p, ext_slot, ext_c) of every pattern entry.  Returns (chi2, spd)
    as 0-d tensors."""
    n = ds.nnodes
    nx, npo = ds.n_xyt, ds.n_pos
    pos = T["pos"]
    # gn_iters > 1 re-relinearizes and re-solves (float32 recovers what
    # the reduced-precision solve loses); float64 runs use one iteration
    for _ in range(gn_iters):
        # relinearize all (aprilsam.c:131-135)
        l_point = ds.state.clone()
        A, B = assemble_block_dense(
            l_point, l_point, pos, ds.xyt_a[:nx], ds.xyt_b[:nx],
            ds.xyt_z[:nx], ds.xyt_W[:nx], ds.pos_node[:npo], ds.pos_z[:npo],
            ds.pos_W[:npo], MB, tikhonov)
        # Jacobi equilibration: factor D^-1/2 A D^-1/2, then unscale, so
        # the stored factor satisfies L L^T = A
        dvec = torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-30))
        A.mul_(dvec[:, None]).mul_(dvec[None, :])
        Ls = cholesky_nan(A)
        del A
        # y: L y = B; x: L^T x = y (smatd_chol_solve_full, smatd.c:1100-1114)
        y = torch.linalg.solve_triangular(Ls, (dvec * B)[:, None],
                                          upper=False)
        x = dvec * torch.linalg.solve_triangular(Ls.T, y, upper=True)[:, 0]
        refresh_states(ds, l_point, x.view(MB, 3)[pos[:n]])
    ds.l_point.copy_(l_point)

    # R[p, slot] = L[3c:3c+3, 3p:3p+3]^T for each pattern entry (p, slot, c)
    # (the reference copies CSparse L columns into smatd rows,
    # aprilsam.c:237-249); L = Ls / dvec by rows, gathered block-wise only
    rinv = (1.0 / dvec).view(MB, 3)
    ext_p, ext_c = T["ext_p"], T["ext_c"]
    L4 = Ls.view(MB, 3, MB, 3)
    blocks = L4[ext_c, :, ext_p, :] * rinv[ext_c][:, :, None]
    ds.R_blocks.zero_()
    ds.R_blocks[ext_p, T["ext_slot"]] = blocks.transpose(1, 2)
    ds.y.zero_()
    ds.y[:MB] = y.view(MB, 3)
    # full-diagonal SPD check: a non-SPD pivot anywhere NaNs the factor
    # (padding rows carry tikhonov on the diagonal, so they stay finite)
    spd = torch.all(torch.isfinite(torch.diagonal(Ls) * rinv.reshape(-1)))
    chi2 = finish_epoch(ds, T, log_mode)
    return chi2, spd


def epoch_symbolic(cfg: SolverConfig, nnodes: int, ftypes, fnodes):
    """The native symbolic phase and the SymbolicState it leaves for the
    incremental engine: the padded planner mirror (pad_idx/pad_nnz) only;
    sym_patterns_list materializes the per-row list if it is asked for.
    Returns (sym, patterns, valid)."""
    from .host_batch import native_symbolic

    NCAP, BCAP = cfg.node_capacity, cfg.row_block_capacity
    order, patterns, nnz, parents = native_symbolic(cfg, nnodes, ftypes,
                                                    fnodes)
    pos = np.empty(nnodes, dtype=np.int32)
    pos[order] = np.arange(nnodes, dtype=np.int32)
    sym = SymbolicState(order=order, pos=pos, patterns=[],
                        parents=parents.copy())
    valid = np.arange(BCAP, dtype=np.int32)[None, :] < nnz[:, None]
    sym.pad_idx = np.full((NCAP, BCAP), NCAP, dtype=np.int32)
    sym.pad_idx[:nnodes][valid] = patterns[valid]
    sym.pad_nnz = np.zeros(NCAP, dtype=np.int32)
    sym.pad_nnz[:nnodes] = nnz
    sym.patterns_stale = True
    return sym, patterns, valid


def full_maps(NCAP: int, sym: SymbolicState) -> Tuple[np.ndarray, np.ndarray]:
    """pos and order over the whole capacity: the identity beyond the live
    nodes (nodes appended between epochs take position == node id,
    aprilsam.c:392-397)."""
    n = sym.nnodes
    pos = np.arange(NCAP, dtype=np.int64)
    pos[:n] = sym.pos
    order = np.arange(NCAP, dtype=np.int64)
    order[:n] = sym.order
    return pos, order


def _info(chi2, spd, n: int, lazy: bool) -> BatchInfo:
    if lazy:
        return BatchInfo(chi2=chi2, spd=spd, n=n)
    return BatchInfo(chi2=float(chi2), spd=bool(spd), n=n)


def run_batch_epoch(ds: DeviceState, cfg: SolverConfig, nnodes: int,
                    ftypes: np.ndarray, fnodes: np.ndarray,
                    log_mode: int = 0, lazy: bool = False):
    """A device batch epoch: native symbolic phase on the host, numeric
    epoch on the device (panel when cfg.batch_backend == "panel" and a
    panel plan fits, else dense).  `ftypes`/`fnodes` are the host factor
    table, read for structure only.  With `lazy`, BatchInfo carries the
    0-d device tensors of chi2/spd and the epoch makes no synchronizing
    call.  Returns (ds, sym, info, backend) with backend "panel" or
    "dense"."""
    NCAP = cfg.node_capacity
    sym, patterns, valid = epoch_symbolic(cfg, nnodes, ftypes, fnodes)

    if cfg.batch_backend == "panel" and cfg.effective_gn_iters == 1:
        from .panel_epoch import build_panel_plan, panel_epoch_step

        plan = build_panel_plan(cfg, nnodes, sym, sym.pad_idx, sym.pad_nnz,
                                ftypes, fnodes)
        if plan is None:
            # escalate to the roomy grade-1 caps before giving up
            plan = build_panel_plan(cfg, nnodes, sym, sym.pad_idx,
                                    sym.pad_nnz, ftypes, fnodes, grade=1)
        if plan is not None:
            chi2, spd = panel_epoch_step(ds, plan, cfg.tikhonov,
                                         cfg.panel_nodes, log_mode)
            return ds, sym, _info(chi2, spd, nnodes, lazy), "panel"
        if 3 * node_bucket(nnodes, NCAP) > 16384:
            # the dense [3MB, 3MB] epoch would not fit either
            raise PanelFallbackError(
                f"panel plan overflow at n={nnodes}; dense infeasible")

    ext_p, ext_slot = np.nonzero(valid)
    pos, order = full_maps(NCAP, sym)
    T = upload(ds, dict(R_idx=sym.pad_idx, R_nnz=sym.pad_nnz, pos=pos,
                        order=order, ext_p=ext_p, ext_slot=ext_slot,
                        ext_c=patterns[valid]), {})
    chi2, spd = _batch_step(ds, T, cfg.tikhonov, node_bucket(nnodes, NCAP),
                            cfg.effective_gn_iters, log_mode)
    return ds, sym, _info(chi2, spd, nnodes, lazy), "dense"


class BatchSolver:
    """One-shot batch Gauss-Newton solver over a FactorGraph — the
    counterpart of calling april_graph_cholesky directly (batch-only mode,
    examples/aprilsam_demo.c:224-228)."""

    def __init__(self, cfg: Optional[SolverConfig] = None, device="cuda"):
        self.cfg = cfg or SolverConfig()
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

    def _use_host(self) -> bool:
        return self.cfg.batch_backend not in ("device", "panel")

    def solve(self, g: FactorGraph) -> BatchInfo:
        if g.nnodes == 0 or g.nfactors == 0:
            return BatchInfo(chi2=0.0, spd=True, n=0)  # aprilsam.c:90-91
        self._ingest(g)
        nf = g.nfactors
        if self._use_host():
            from .host_batch import host_batch_epoch

            self.ds, self.sym, info = host_batch_epoch(
                self.ds, self.cfg, g.nnodes, g.ftype[:nf], g.fnodes[:nf],
                g.fz[:nf], g.fW[:nf])
        else:
            self.ds, self.sym, info, _backend = run_batch_epoch(
                self.ds, self.cfg, g.nnodes, g.ftype[:nf], g.fnodes[:nf])
        return info

    def chi2(self) -> float:
        return float(state_chi2(self.ds))

    def sync_states(self, g: FactorGraph) -> None:
        n = g.nnodes
        g.state[:n] = self.ds.state[:n].cpu().numpy().astype(np.float64)
        g.l_point[:n] = self.ds.l_point[:n].cpu().numpy().astype(np.float64)
        g.delta_X[:n] = self.ds.delta_X[:n].cpu().numpy().astype(np.float64)


__all__ = ["BatchInfo", "BatchSolver", "PanelFallbackError",
           "run_batch_epoch"]
