"""Solver state on one device: a mutable dataclass of tensors.

Counterpart of ``aprilsam_tpu/solver/state.py`` (the reference's
april_graph_cholesky_param_t plus the per-node fields of april_graph_node_t,
aprilsam.h:151-269).  Where the JAX package threads an immutable pytree
through donated jit calls, the port updates these tensors in place.

Layout conventions (the same as the JAX package):
  * "position space": elimination-order index p.  R rows, y and the etree
    live here; `pos` maps node id -> position, `order` the inverse.
  * R is the upper-triangular factor stored as block rows: R_blocks[p, s] is
    the 3x3 block at block-row p, block-column R_idx[p, s] (ascending,
    R_idx[p, 0] == p, padding = node_capacity).
  * node-space tensors (state, l_point, delta_X, relinearized) are indexed
    by node id.

Index tensors are int64 (PyTorch's index type); the counts the host owns
(n_xyt, n_pos, nnodes, log_ptr) are Python ints, so slicing to the live
rows needs no device read.  start_over and spd_ok are computed on the device
and stay 0-d tensors.  ``state_to_numpy``/``state_from_numpy`` convert to
and from the JAX package's field names and dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .config import SolverConfig
from .symbolic import SymbolicState

# the JAX package's DeviceState._fields, in order
FIELDS = (
    "R_blocks", "R_idx", "R_nnz", "y",
    "state", "l_point", "delta_X", "relinearized", "pos", "order",
    "xyt_a", "xyt_b", "xyt_z", "xyt_W", "n_xyt",
    "pos_node", "pos_z", "pos_W", "n_pos",
    "start_over", "spd_ok", "nnodes",
    "chi2_log", "log_ptr",
)
_HOST_INTS = ("n_xyt", "n_pos", "nnodes", "log_ptr")
_INDEX = ("R_idx", "R_nnz", "pos", "order", "xyt_a", "xyt_b", "pos_node",
          "start_over")


@dataclasses.dataclass
class DeviceState:
    # --- Cholesky factor R (position space) ---
    R_blocks: torch.Tensor      # [NCAP, BCAP, 3, 3]
    R_idx: torch.Tensor         # [NCAP, BCAP] int64, padding = NCAP
    R_nnz: torch.Tensor         # [NCAP] int64
    y: torch.Tensor             # [NCAP, 3] forward-solve intermediate
    # --- node state (node-id space) ---
    state: torch.Tensor         # [NCAP, 3]
    l_point: torch.Tensor       # [NCAP, 3]
    delta_X: torch.Tensor       # [NCAP, 3]
    relinearized: torch.Tensor  # [NCAP] bool, since the last batch
    pos: torch.Tensor           # [NCAP] int64 node id -> position
    order: torch.Tensor         # [NCAP] int64 position -> node id
    # --- factor tables (live rows [:n_xyt] / [:n_pos]) ---
    xyt_a: torch.Tensor         # [FCAP] int64
    xyt_b: torch.Tensor         # [FCAP] int64
    xyt_z: torch.Tensor         # [FCAP, 3]
    xyt_W: torch.Tensor         # [FCAP, 3, 3]
    n_xyt: int
    pos_node: torch.Tensor      # [FPOS] int64
    pos_z: torch.Tensor         # [FPOS, 3]
    pos_W: torch.Tensor         # [FPOS, 3, 3]
    n_pos: int
    # --- counters / policy state ---
    start_over: torch.Tensor    # 0-d int64 (tr->start_over)
    spd_ok: torch.Tensor        # 0-d bool, AND of every frontal SPD check
                                # since the last batch epoch
    nnodes: int
    # --- per-step metric ring ---
    chi2_log: torch.Tensor      # [LOGCAP]
    log_ptr: int

    @property
    def device(self) -> torch.device:
        return self.state.device


def init_device_state(cfg: SolverConfig, device) -> DeviceState:
    NCAP = cfg.node_capacity
    FCAP = cfg.factor_capacity
    FPOS = max(256, cfg.factor_capacity // 8)
    BCAP = cfg.row_block_capacity
    dt = cfg.torch_dtype
    f = lambda *s: torch.zeros(s, dtype=dt, device=device)
    i = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)
    return DeviceState(
        R_blocks=f(NCAP, BCAP, 3, 3),
        R_idx=torch.full((NCAP, BCAP), NCAP, dtype=torch.int64,
                         device=device),
        R_nnz=i(NCAP),
        y=f(NCAP, 3),
        state=f(NCAP, 3),
        l_point=f(NCAP, 3),
        delta_X=f(NCAP, 3),
        relinearized=torch.zeros(NCAP, dtype=torch.bool, device=device),
        pos=i(NCAP),
        order=i(NCAP),
        xyt_a=i(FCAP),
        xyt_b=i(FCAP),
        xyt_z=f(FCAP, 3),
        xyt_W=f(FCAP, 3, 3),
        n_xyt=0,
        pos_node=i(FPOS),
        pos_z=f(FPOS, 3),
        pos_W=f(FPOS, 3, 3),
        n_pos=0,
        start_over=torch.zeros((), dtype=torch.int64, device=device),
        spd_ok=torch.ones((), dtype=torch.bool, device=device),
        nnodes=0,
        chi2_log=f(cfg.effective_log_capacity),
        log_ptr=0,
    )


def state_chi2(ds: DeviceState) -> torch.Tensor:
    """Graph chi2 at the current states with the reference's 0.5x/1.0x
    convention (april_graph.c:79-98), over the live factor rows."""
    from ..factors import graph_chi2

    nx, npo = ds.n_xyt, ds.n_pos
    return graph_chi2(ds.state, ds.xyt_a[:nx], ds.xyt_b[:nx], ds.xyt_z[:nx],
                      ds.xyt_W[:nx], ds.pos_node[:npo], ds.pos_z[:npo],
                      ds.pos_W[:npo])


def upload(ds: DeviceState, ints: Dict[str, np.ndarray],
           floats: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The host arrays of one dispatch on the device, in one copy per
    dtype: index arrays as int64, float arrays in the state's dtype.  On
    the card the copy leaves pinned host memory asynchronously (PyTorch's
    caching host allocator keeps the buffer until the copy is done), so
    the host does not wait for earlier device work, as a pageable upload
    would.  Returns views into the copies, shaped as the arrays."""
    out = {}
    cuda = ds.device.type == "cuda"
    for arrays, dtype in ((ints, torch.int64), (floats, ds.state.dtype)):
        if not arrays:
            continue
        flat = [np.asarray(a).reshape(-1) for a in arrays.values()]
        host = torch.empty(sum(len(f) for f in flat), dtype=dtype,
                           pin_memory=cuda)
        h = host.numpy()
        offs, o = [], 0
        for f in flat:
            h[o:o + len(f)] = f
            offs.append(o)
            o += len(f)
        dev = host.to(ds.device, non_blocking=True) if cuda else host
        for (name, a), o, f in zip(arrays.items(), offs, flat):
            out[name] = dev[o:o + len(f)].view(np.shape(a))
    return out


# ------------------------------------------------------------ carry-across

def state_to_numpy(ds: DeviceState) -> Dict[str, np.ndarray]:
    """The state as numpy arrays keyed and typed like the JAX package's
    DeviceState fields (index tensors as int32, counts as 0-d int32)."""
    out = {}
    for name in FIELDS:
        v = getattr(ds, name)
        if name in _HOST_INTS:
            out[name] = np.asarray(v, dtype=np.int32)
        elif name in _INDEX:
            out[name] = v.cpu().numpy().astype(np.int32)
        else:
            out[name] = v.cpu().numpy()
    return out


def state_from_numpy(fields: Dict[str, np.ndarray], device,
                     dtype: torch.dtype = None) -> DeviceState:
    """Load a state keyed by the JAX package's DeviceState fields (e.g.
    ``{k: np.asarray(v) for k, v in jax_ds._asdict().items()}``) onto
    `device`.  `dtype` overrides the float dtype of the arrays."""
    kw = {}
    for name in FIELDS:
        a = np.asarray(fields[name])
        if name in _HOST_INTS:
            kw[name] = int(a)
        elif name in _INDEX:
            kw[name] = torch.as_tensor(a.astype(np.int64), device=device)
        elif a.dtype == np.bool_:
            kw[name] = torch.as_tensor(a, device=device)
        else:
            t = torch.as_tensor(a, device=device)
            kw[name] = t if dtype is None else t.to(dtype)
    return DeviceState(**kw)


_SYM_ARRAYS = ("order", "pos", "parents", "pad_idx", "pad_nnz", "mark",
               "token", "kid_head", "kid_next", "kid_prev")


def symbolic_to_numpy(sym) -> Dict[str, object]:
    """Host symbolic state (of either package) as plain numpy: the ordering,
    etree and per-row patterns, plus the native planner's mirror (padded
    patterns, visit stamps, child lists) when it has been attached."""
    out: Dict[str, object] = {}
    for name in _SYM_ARRAYS:
        v = getattr(sym, name, None)
        if v is not None:
            out[name] = np.array(v, dtype=np.int32, copy=True)
    stale = bool(getattr(sym, "patterns_stale", False))
    out["patterns_stale"] = stale
    out["patterns"] = [np.array(p, dtype=np.int32, copy=True)
                       for p in sym.patterns]
    return out


def symbolic_from_numpy(d: Dict[str, object]) -> SymbolicState:
    """Rebuild a SymbolicState from ``symbolic_to_numpy`` output."""
    sym = SymbolicState(
        order=np.array(d["order"], dtype=np.int32),
        pos=np.array(d["pos"], dtype=np.int32),
        patterns=[np.array(p, dtype=np.int32) for p in d["patterns"]],
        parents=np.array(d["parents"], dtype=np.int32),
    )
    sym.rebuild_children()
    for name in _SYM_ARRAYS[3:]:
        if name in d:
            setattr(sym, name, np.array(d[name], dtype=np.int32))
    sym.patterns_stale = bool(d.get("patterns_stale", False))
    return sym
