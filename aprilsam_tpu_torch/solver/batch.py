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

The dense epoch runs on the JAX package's signature (MB, KEXT): its tables
padded to the node bucket MB and the extraction-map bucket KEXT, the factor
tables read whole and masked to their live rows, the counts it needs in
T["ctl"] = [n, n_xyt, n_pos, log_idx].  So on the card it replays as one
CUDA graph per signature (utils/cache.py).  Every write of the epoch is
gated on n > 0: a dead epoch (n = 0, precompile_device_batch) leaves the
state as it was, which lets the ladder be captured on the solver's own
state.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import mod2pi
from ..graph import FactorGraph
from ..kernels.assembly import assemble_block_dense
from ..utils import GraphCache, resolve_device, setup_precision, trace
from .config import SolverConfig
from .state import DeviceState, full, init_device_state, state_chi2
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
                   dx: torch.Tensor, member=None) -> None:
    """state = l_point + dx (theta wrapped) and delta_X = dx for the first
    n nodes whose dx [n, 3] has no NaN (and, where `member` [n] is given,
    that it marks); the others keep theirs (xyt_node_update,
    april_graph_xyt.c:302-314)."""
    n = dx.shape[0]
    ok = ~torch.any(torch.isnan(dx), dim=1, keepdim=True)
    if member is not None:
        ok = ok & member[:, None]
    new = l_point[:n] + dx
    new = torch.cat([new[:, :2], mod2pi(new[:, 2:])], dim=1)
    ds.state[:n] = torch.where(ok, new, ds.state[:n])
    ds.delta_X[:n] = torch.where(ok, dx, ds.delta_X[:n])


def epoch_ctl(ds: DeviceState, nnodes: int, nx: int, npo: int,
              log_mode: int) -> Tuple[np.ndarray, int]:
    """T["ctl"] of an epoch, [n, n_xyt, n_pos, log_idx], and the ring
    pointer after it.  The metric ring: log_mode 0 appends, 1 overwrites
    the newest entry (a fallback epoch replaces the chi2 of its triggering
    step), 2 leaves it alone; log_idx is the ring's dump row where nothing
    is written."""
    LOG = ds.chi2_log.shape[0]
    ptr_after, log_idx = ds.log_ptr, LOG
    if log_mode != 2:
        ptr = max(ds.log_ptr - (log_mode == 1), 0)
        log_idx = ptr if ptr < LOG else LOG
        ptr_after = ptr + 1
    return np.asarray([nnodes, nx, npo, log_idx], dtype=np.int64), ptr_after


def keep_live(live, new: torch.Tensor, old: torch.Tensor) -> None:
    """old = new where the epoch is live (0-d bool), in place."""
    old.copy_(torch.where(live, new, old))


def finish_epoch(ds: DeviceState, T: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tail every device epoch shares: the new pattern, ordering and
    zeroed counters, the chi2 and its metric-ring entry (T["ctl"], see
    epoch_ctl); nothing changes where the epoch is dead."""
    ctl = T["ctl"]
    live = ctl[0] > 0
    for name in ("R_idx", "R_nnz", "pos", "order"):
        keep_live(live, T[name], getattr(ds, name))
    ds.relinearized.masked_fill_(live, False)
    ds.start_over.masked_fill_(live, 0)
    ds.spd_ok.masked_fill_(live, True)
    chi2 = state_chi2(ds, (ctl[1], ctl[2]))
    full(ds.chi2_log).index_copy_(0, ctl[3:4], chi2.reshape(1))
    return chi2


def _batch_step(ds: DeviceState, T: Dict[str, torch.Tensor], tikhonov: float,
                MB: int, gn_iters: int) -> torch.Tensor:
    """The dense epoch on the device, in place.  T holds the uploaded
    tables: the new pattern R_idx/R_nnz, pos/order, the extraction map
    (ext_p, ext_slot, ext_c) of every pattern entry, padded to KEXT with
    ext_p = NCAP (the dump row), and ctl.  Returns [chi2, spd]."""
    ctl = T["ctl"]
    n = ctl[0]
    live = n > 0
    dev = ds.device
    dtype = ds.state.dtype
    pos = T["pos"]
    mx = torch.arange(ds.xyt_a.shape[0], device=dev) < ctl[1]
    mp = torch.arange(ds.pos_node.shape[0], device=dev) < ctl[2]
    xa = torch.where(mx, ds.xyt_a, 0)
    xb = torch.where(mx, ds.xyt_b, 0)
    xW = torch.where(mx[:, None, None], ds.xyt_W, 0.0)
    pn = torch.where(mp, ds.pos_node, 0)
    pW = torch.where(mp[:, None, None], ds.pos_W, 0.0)
    member = torch.arange(MB, device=dev) < n
    # gn_iters > 1 re-relinearizes and re-solves (float32 recovers what
    # the reduced-precision solve loses); float64 runs use one iteration
    for _ in range(gn_iters):
        # relinearize all (aprilsam.c:131-135)
        l_point = ds.state.clone()
        A, B = assemble_block_dense(
            l_point, l_point, pos, xa, xb, ds.xyt_z, xW, pn, ds.pos_z, pW,
            MB, tikhonov)
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
        refresh_states(ds, l_point, x.view(MB, 3)[pos[:MB]], member)
    keep_live(live, l_point, ds.l_point)

    # R[p, slot] = L[3c:3c+3, 3p:3p+3]^T for each pattern entry (p, slot, c)
    # (the reference copies CSparse L columns into smatd rows,
    # aprilsam.c:237-249); L = Ls / dvec by rows, gathered block-wise only
    rinv = (1.0 / dvec).view(MB, 3)
    ext_p, ext_c = T["ext_p"], T["ext_c"]
    L4 = Ls.view(MB, 3, MB, 3)
    blocks = L4[ext_c, :, ext_p.clamp(max=MB - 1), :] * rinv[ext_c][:, :, None]
    ds.R_blocks.masked_fill_(live, 0.0)
    full(ds.R_blocks)[ext_p, T["ext_slot"]] = blocks.transpose(1, 2)
    ynew = torch.zeros_like(ds.y)
    ynew[:MB] = y.view(MB, 3)
    keep_live(live, ynew, ds.y)
    # full-diagonal SPD check: a non-SPD pivot anywhere NaNs the factor
    # (padding rows carry tikhonov on the diagonal, so they stay finite)
    spd = torch.all(torch.isfinite(torch.diagonal(Ls) * rinv.reshape(-1)))
    chi2 = finish_epoch(ds, T)
    return torch.stack([chi2, spd.to(dtype)])


def _ext_bucket(k: int) -> int:
    b = 1024
    while b < k:
        b *= 2
    return b


def dense_epoch(ds: DeviceState, cfg: SolverConfig, nnodes: int,
                tables: Dict[str, np.ndarray], log_mode: int,
                graphs: GraphCache) -> torch.Tensor:
    """The dense epoch at its signature (MB, KEXT): the node bucket MB and
    the extraction map padded to KEXT (the JAX package's ladder: KEXT
    rides with MB, max(ext bucket, 8 MB)).  `tables` holds R_idx, R_nnz,
    pos, order (NCAP-long) and the live extraction map ext_p, ext_slot,
    ext_c.  `graphs` replays the signature's graph (eager when
    disabled).  Returns [chi2, spd] (a tensor of its own)."""
    NCAP = cfg.node_capacity
    MB = node_bucket(nnodes, NCAP)
    k = len(tables["ext_p"])
    KEXT = max(_ext_bucket(k), 8 * MB)
    ctl, ptr_after = epoch_ctl(ds, nnodes, ds.n_xyt, ds.n_pos, log_mode)
    ints = dict(tables, ctl=ctl)
    for name, fill in (("ext_p", NCAP), ("ext_slot", 0), ("ext_c", 0)):
        pad = np.full(KEXT, fill, dtype=np.int64)
        pad[:k] = tables[name]
        ints[name] = pad
    gn = cfg.effective_gn_iters
    tik = float(cfg.tikhonov)
    body = lambda T: _batch_step(ds, T, tik, MB, gn)
    out = graphs.run(("dense", MB, KEXT, gn), ds, ints, {}, body).clone()
    ds.log_ptr = ptr_after
    return out


def precompile_device_batch(ds: DeviceState, cfg: SolverConfig,
                            nnodes_max: int, graphs: GraphCache) -> int:
    """Run the (MB, KEXT) ladder of the dense epoch a replay of nnodes_max
    poses crosses, with dead inputs (n = 0), as the JAX package compiles
    it: on the card each rung's graph is captured into `graphs` on `ds`,
    which the dead epochs leave as it was.  Returns the
    number of rungs."""
    NCAP = cfg.node_capacity
    BCAP = cfg.row_block_capacity
    ar = np.arange(NCAP, dtype=np.int64)
    dead = dict(R_idx=np.full((NCAP, BCAP), NCAP, dtype=np.int64),
                R_nnz=np.zeros(NCAP, dtype=np.int64), pos=ar, order=ar,
                ext_p=np.zeros(0, dtype=np.int64),
                ext_slot=np.zeros(0, dtype=np.int64),
                ext_c=np.zeros(0, dtype=np.int64))
    ptr = ds.log_ptr
    count = 0
    mb = 256
    while True:
        mb = min(mb, NCAP)
        # a dead epoch at node bucket mb: nnodes selects the rung, ctl's
        # n = 0 keeps the state
        MB = node_bucket(mb, NCAP)
        KEXT = 8 * MB
        ints = dict(dead, ctl=np.asarray([0, 0, 0, ds.chi2_log.shape[0]],
                                         dtype=np.int64))
        for name in ("ext_p", "ext_slot", "ext_c"):
            ints[name] = np.full(KEXT, NCAP if name == "ext_p" else 0,
                                 dtype=np.int64)
        gn = cfg.effective_gn_iters
        tik = float(cfg.tikhonov)
        graphs.run(("dense", MB, KEXT, gn), ds, ints, {},
                   lambda T, MB=MB: _batch_step(ds, T, tik, MB, gn))
        count += 1
        if mb >= min(node_bucket(nnodes_max, NCAP), NCAP):
            break
        mb *= 2
    ds.log_ptr = ptr
    if ds.device.type == "cuda":
        torch.cuda.synchronize(ds.device)
    return count


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
                    log_mode: int = 0, lazy: bool = False, *,
                    graphs: GraphCache):
    """A device batch epoch: native symbolic phase on the host, numeric
    epoch on the device (panel when cfg.batch_backend == "panel" and a
    panel plan fits, else dense).  `ftypes`/`fnodes` are the host factor
    table, read for structure only.  With `lazy`, BatchInfo carries the
    0-d device tensors of chi2/spd and the epoch makes no synchronizing
    call.  `graphs` replays the epoch's graphs (eager when disabled).
    Returns (ds, sym, info, backend) with backend "panel" or "dense"."""
    NCAP = cfg.node_capacity
    with trace.span("epoch.symbolic"):
        sym, patterns, valid = epoch_symbolic(cfg, nnodes, ftypes, fnodes)

    if cfg.batch_backend == "panel" and cfg.effective_gn_iters == 1:
        from .panel_epoch import build_panel_plan, panel_epoch_step

        with trace.span("epoch.plan"):
            plan = build_panel_plan(cfg, nnodes, sym, sym.pad_idx,
                                    sym.pad_nnz, ftypes, fnodes)
            if plan is None:
                # escalate to the roomy grade-1 caps before giving up
                plan = build_panel_plan(cfg, nnodes, sym, sym.pad_idx,
                                        sym.pad_nnz, ftypes, fnodes, grade=1)
        if plan is not None:
            with trace.span("epoch.solve"):
                chi2, spd = panel_epoch_step(ds, plan, cfg.tikhonov,
                                             cfg.panel_nodes, log_mode,
                                             graphs)
                info = _info(chi2, spd, nnodes, lazy)
            return ds, sym, info, "panel"
        if 3 * node_bucket(nnodes, NCAP) > 16384:
            # the dense [3MB, 3MB] epoch would not fit either
            raise PanelFallbackError(
                f"panel plan overflow at n={nnodes}; dense infeasible")

    with trace.span("epoch.solve"):
        ext_p, ext_slot = np.nonzero(valid)
        pos, order = full_maps(NCAP, sym)
        out = dense_epoch(ds, cfg, nnodes, dict(
            R_idx=sym.pad_idx, R_nnz=sym.pad_nnz, pos=pos, order=order,
            ext_p=ext_p, ext_slot=ext_slot, ext_c=patterns[valid]), log_mode,
            graphs)
        info = _info(out[0], out[1] > 0.5, nnodes, lazy)
    return ds, sym, info, "dense"


class BatchSolver:
    """One-shot batch Gauss-Newton solver over a FactorGraph — the
    counterpart of calling april_graph_cholesky directly (batch-only mode,
    examples/aprilsam_demo.c:224-228)."""

    def __init__(self, cfg: Optional[SolverConfig] = None, device="cuda"):
        self.cfg = cfg or SolverConfig()
        self.device = resolve_device(device)
        setup_precision()
        self.ds = init_device_state(self.cfg, self.device)
        # each epoch signature a CUDA graph on the card (utils/cache.py)
        self.graphs = GraphCache(self.device)
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
                g.fz[:nf], g.fW[:nf], graphs=self.graphs)
        else:
            self.ds, self.sym, info, _backend = run_batch_epoch(
                self.ds, self.cfg, g.nnodes, g.ftype[:nf], g.fnodes[:nf],
                graphs=self.graphs)
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
