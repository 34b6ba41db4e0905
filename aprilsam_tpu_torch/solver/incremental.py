"""Hybrid incremental/batch solver — the AprilSAM algorithm, per step or in
supersteps, with a synchronous or a lagged batch-fallback policy.

Counterpart of ``aprilsam_tpu/solver/incremental.py`` (reference:
april_graph_cholesky_inc, aprilsam.c:377-576).
The algebra is the JAX package's.  Two structural facts make the affected
submatrix self-contained: row p of R has nonzeros only at etree ancestors of
p, and the affected set F (paths from the touched nodes to the root,
aprilsam.c:482-498) is ancestor-closed.  The reference's reconstruct ->
add -> refactor cycle therefore collapses into one dense frontal QR:

      qr([R_F ; W^{1/2} J_new])  ->  R_F',   y_F' = Q^T [y_F ; W^{1/2} r]

Then either the fast path (naffected <= small_path_max: x_F = R_F'^{-1}
y_F', plus relinearization bookkeeping on the fringe, the reference's pruned
descent) or the full path (a panel-blocked back-substitution over the whole
block-sparse R through kernels/sweep.py:panel_backsub, whose panel
inverses run in the CUDA kernel K1 on the card).  Then the batch-fallback
policy (aprilsam.c:557-575).

Throughput modes (as in the JAX package):
  * policy_lag > 0: the policy stats of each dispatch are copied to pinned
    host memory behind a CUDA event and read policy_lag dispatches later,
    so the host never waits for the device to decide on a batch epoch;
  * superstep_size > 1: a buffer of steps is planned as ONE union front and
    dispatched as one joint frontal update plus one sweep (whole-graph, or
    windowed to the panels the union front touches);
  * bundle_size > 1: consecutive steps queue and dispatch together, one
    bundle per signature (mixed bundles: fast and full steps share one),
    with the stats of all slots in one copy; with coalesce_full_solves a
    bundle's full steps share one whole-graph sweep at its end;
  * the policy's wall-clock gate then reads dispatch-to-dispatch intervals.

Signatures and CUDA graphs (the JAX package's static shapes and jit
executables): every dispatch is padded to its signature, as in the JAX
package, with dead slots writing to the state's dump rows (state.py):
  ("fast", M), ("full", M, NPANB)   a step at affected-set bucket M;
  ("sup", M, NPANB), ("supns", M), ("win", M, PW)
                                    a superstep (swept, unswept, windowed);
  ("sweep", NPANB)                  flush()'s or a bundle's lone sweep;
  ("ingest", knode, kseed, K)       the plan-overflow path's ingestion.
On the card each signature runs as a CUDA graph captured on its first
dispatch (or by precompile) and replayed after (utils/cache.py); K1 is
replayed inside the full-step, superstep and sweep graphs.  graphs=False
runs every dispatch eagerly (for timing the two against each other); on
the CPU every dispatch runs eagerly.  default_signatures and precompile
are the JAX package's.

How the port differs from the JAX package, with the algebra unchanged:
  * the host plan (StepPlan) carries numpy arrays, padded to the signature
    as each dispatch uploads them, in one copy per dtype (pinned,
    asynchronous on the card); there is no packed int32 plan vector and no
    front gather/scatter tables;
  * the JAX package's one-hot einsums are index ops;
  * the solver state is updated in place;
  * a bundle of k live slots is k replays of its slots' single-step
    graphs (no host read between them), where the JAX package scans over a
    padded, packed slot array.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry import mod2pi, xyt_inv, xyt_mul
from ..graph import FactorGraph, FACTOR_XYT
from ..factors import eval_xyt, eval_xytpos
from ..kernels.linalg3 import chol3, solve_upper3
from ..kernels.sweep import panel_backsub, panel_backsub_windowed
from ..utils import GraphCache, resolve_device, setup_precision, trace
from .batch import BatchInfo, PanelFallbackError, run_batch_epoch
from .config import SolverConfig
from .ingest import ingest_graph
from .state import (DeviceState, full, init_device_state, state_chi2,
                    state_from_numpy, state_to_numpy, with_dump_row)
from . import symbolic as sym_mod
from .symbolic import SymbolicState

INT_MAX = np.iinfo(np.int32).max

KNODE = 4   # max new nodes per step
KSEED = 4   # max odometry seedings per step
# Fringe width of a fast step: a larger fringe takes the full path instead
# (an exact, un-pruned solve), as in the JAX package.
MIXED_FR = 32
FRCAP = 128  # fringe capacity handed to the native planner
# Mixed bundles (as in the JAX package): the affected-set buckets whose
# full steps share a bundle with fast steps (a fast step must fit the
# first), and the word budget of one dispatch of the JAX package's packed
# slot layout, beyond which a bundle is split (see _mixed_chunks).
MIXED_BUCKETS = (16, 64, 256, 1024)
MIXED_FLAT_BUCKETS = (131072, 262144)


@dataclass
class SeedSpec:
    """Odometry seeding of a new node's state: dst = src (+) z, or
    dst = src (+) inv(z) when invert (aprilsam_demo.c:180-191)."""

    src: int
    dst: int
    z: np.ndarray
    invert: bool


# ======================================================================
# host step planning
# ======================================================================

@dataclass
class StepTail:
    """A step's new nodes, odometry seeds and factors (host arrays)."""

    node_ids: np.ndarray      # [k] new node ids
    node_states: np.ndarray   # [k, 3] their initial states
    seed_src: np.ndarray      # [s] (deduplicated, last wins per dst)
    seed_dst: np.ndarray      # [s]
    seed_inv: np.ndarray      # [s] bool
    seed_z: np.ndarray        # [s, 3]
    nf_a: np.ndarray          # [kx] new xyt factors
    nf_b: np.ndarray
    nf_z: np.ndarray          # [kx, 3]
    nf_W: np.ndarray          # [kx, 3, 3]
    np_node: np.ndarray       # [kp] new xytpos factors
    np_z: np.ndarray
    np_W: np.ndarray


@dataclass
class StepPlan:
    m: int                    # affected rows (incl. new nodes)
    naffected: int            # affected rows excluding new nodes
    maxaff: int               # the affected-set bucket of m
    max_rnnz: int             # widest new pattern row (mixed bundles)
    fringe_overflow: bool
    tail: StepTail
    F_pos: np.ndarray         # [m] affected positions, ascending
    F_node: np.ndarray        # [m] their node ids
    new_ridx: np.ndarray      # [m, BCAP] new pattern rows (pad = NCAP)
    new_nnz: np.ndarray       # [m]
    nf_a_slot: np.ndarray     # [kx] front slot of each xyt endpoint
    nf_b_slot: np.ndarray
    np_slot: np.ndarray       # [kp]
    fringe_pos: np.ndarray    # [nfr] fast steps only (empty on full)
    fringe_node: np.ndarray


def _bucket(n: int, buckets) -> Optional[int]:
    for b in buckets:
        if n <= b:
            return b
    return None


def _padded_rows(patterns: List[np.ndarray], rows: np.ndarray, BCAP: int,
                 sentinel: int):
    out = np.full((len(rows), BCAP), sentinel, dtype=np.int32)
    nnz = np.zeros(len(rows), dtype=np.int32)
    for i, p in enumerate(rows):
        pat = patterns[p]
        if len(pat) > BCAP:
            raise OverflowError("row_block_capacity exceeded")
        out[i, : len(pat)] = pat
        nnz[i] = len(pat)
    return out, nnz


def _dedup_seeds(seeds: Sequence[SeedSpec]) -> List[SeedSpec]:
    """Last wins per destination (the reference applies seeds in factor
    order, aprilsam_demo.c:180-191; the device applies them as one
    vectorized scatter)."""
    by_dst = {}
    for s in seeds:
        by_dst[s.dst] = s
    return list(by_dst.values())


def step_tail(g: FactorGraph, f0: int, f1: int, new_ids: Sequence[int],
              seeds: Sequence[SeedSpec]) -> StepTail:
    """The step's ingestion payload: nodes [new_ids], factors [f0, f1) split
    by type in table order, and deduplicated seeds."""
    fn = g.fnodes[f0:f1]
    mx = g.ftype[f0:f1] == FACTOR_XYT
    fz, fW = g.fz[f0:f1], g.fW[f0:f1]
    ids = np.asarray(new_ids, dtype=np.int64)
    return StepTail(
        node_ids=ids,
        node_states=g.state[ids].copy(),
        seed_src=np.asarray([s.src for s in seeds], dtype=np.int64),
        seed_dst=np.asarray([s.dst for s in seeds], dtype=np.int64),
        seed_inv=np.asarray([bool(s.invert) for s in seeds], dtype=bool),
        seed_z=np.asarray([s.z for s in seeds],
                          dtype=np.float64).reshape(-1, 3),
        nf_a=fn[mx, 0].astype(np.int64), nf_b=fn[mx, 1].astype(np.int64),
        nf_z=fz[mx].copy(), nf_W=fW[mx].copy(),
        np_node=fn[~mx, 0].astype(np.int64),
        np_z=fz[~mx].copy(), np_W=fW[~mx].copy(),
    )


def _ensure_native_sym(sym: SymbolicState, NCAP: int, BCAP: int) -> None:
    """Attach the padded planner mirror (pad_idx/pad_nnz, visit stamps and
    child lists of the parent array) to a fresh post-batch SymbolicState."""
    if getattr(sym, "pad_idx", None) is None:
        idx, nnz = sym_mod.padded_pattern_arrays(sym, NCAP, BCAP, NCAP)
        sym.pad_idx = idx
        sym.pad_nnz = nnz
        sym.patterns_stale = False
    if getattr(sym, "mark", None) is None or sym.mark.shape[0] != NCAP:
        sym.mark = np.zeros(NCAP, dtype=np.int32)
        sym.token = np.zeros(1, dtype=np.int32)
        kid_head = np.full(NCAP, -1, dtype=np.int32)
        kid_next = np.full(NCAP, -1, dtype=np.int32)
        kid_prev = np.full(NCAP, -1, dtype=np.int32)
        for c in range(sym.nnodes):
            p = int(sym.parents[c])
            if p < 0:
                continue
            h = kid_head[p]
            kid_next[c] = h
            if h >= 0:
                kid_prev[h] = c
            kid_head[p] = c
        sym.kid_head = kid_head
        sym.kid_next = kid_next
        sym.kid_prev = kid_prev


def sym_patterns_list(sym: SymbolicState) -> List[np.ndarray]:
    """Per-row patterns, read from the native pad arrays when the python
    list has gone stale (the native planner mutates only the pads)."""
    if getattr(sym, "patterns_stale", False):
        return [sym.pad_idx[p, : sym.pad_nnz[p]].copy()
                for p in range(sym.nnodes)]
    return sym.patterns


def plan_step(
    sym: SymbolicState,
    cfg: SolverConfig,
    g: FactorGraph,
    f0: int,
    f1: int,
    n_old: int,
    seeds: Sequence[SeedSpec],
    python_planner: bool = False,
    knode: int = KNODE,
    kseed: int = KSEED,
    kfac: Optional[int] = None,
    buckets: Optional[tuple] = None,
    n_end: Optional[int] = None,
) -> Optional[StepPlan]:
    """Host symbolic work for one incremental step: extend the ordering,
    find the affected set, merge the new factor edges into its row
    patterns, and find the fringe.  Returns None when the affected set
    exceeds the largest frontal bucket (the caller falls back to a batch
    epoch).  `python_planner` runs the pure-python planner instead of the
    native one (the two give identical plans).

    knode/kseed/kfac/buckets default to the per-step capacities; a
    superstep plans the union of a whole buffer of steps in ONE call with
    buffer-sized ones.  n_end bounds the span of new nodes (a superstep
    flushed for capacity dispatches a buffer whose last step predates the
    graph's current tail)."""
    NCAP = cfg.node_capacity
    BCAP = cfg.row_block_capacity
    K = kfac if kfac is not None else cfg.new_factor_capacity
    if buckets is None:
        buckets = cfg.frontal_buckets

    # 1. extend ordering with new nodes (aprilsam.c:392-397)
    new_ids = list(range(n_old, g.nnodes if n_end is None else n_end))
    seeds = _dedup_seeds(seeds)
    # seeds apply in ONE vectorized hop (gather src after node ingestion,
    # scatter dst): a src that is itself seeded would read its pre-seed
    # state.  Per-step seeds always come from pre-existing nodes; superstep
    # plans pass chains pre-composed on the host.
    dsts = {s.dst for s in seeds}
    if any(s.src in dsts for s in seeds):
        raise ValueError("seed chains: a seed source is also seeded")
    if len(new_ids) > knode or len(seeds) > kseed:
        raise OverflowError("too many new nodes/seeds in one step")
    sym_mod.append_nodes(sym, new_ids)

    if not python_planner:
        # ---- native planner: one C call does the affected walk, pattern
        # merge, parent re-derivation and fringe scan on the padded arrays
        from .. import native

        _ensure_native_sym(sym, NCAP, BCAP)
        for i in new_ids:
            p = int(sym.pos[i])
            sym.pad_idx[p, 0] = p
            sym.pad_nnz[p] = 1
        fn = g.fnodes[f0:f1]
        ea_pos = sym.pos[fn[:, 0]].astype(np.int32)
        has_b = fn[:, 1] >= 0
        eb_pos = np.where(
            has_b, sym.pos[np.clip(fn[:, 1], 0, None)], -1).astype(np.int32)
        new_pos = sym.pos[new_ids].astype(np.int32) if new_ids else \
            np.zeros(0, dtype=np.int32)
        touched_pos = np.ascontiguousarray(np.concatenate(
            [ea_pos, eb_pos[has_b], new_pos]))
        MAXCAP = buckets[-1]
        F = np.empty(MAXCAP, dtype=np.int32)
        fringe = np.empty(FRCAP, dtype=np.int32)
        mbuf = np.zeros(1, dtype=np.int32)
        nfrbuf = np.zeros(1, dtype=np.int32)
        old_idx = np.empty((MAXCAP, BCAP), dtype=np.int32)
        old_nnz = np.empty(MAXCAP, dtype=np.int32)
        rc = native.plan_step_native(
            sym.nnodes, NCAP, BCAP, sym.parents, sym.pad_idx, sym.pad_nnz,
            sym.mark, sym.token,
            sym.kid_head, sym.kid_next, sym.kid_prev, touched_pos,
            np.ascontiguousarray(ea_pos), np.ascontiguousarray(eb_pos),
            MAXCAP, FRCAP, F, fringe, mbuf, nfrbuf, old_idx, old_nnz)
        if rc == 1:
            return None                       # affected set > largest bucket
        if rc == 2:
            raise OverflowError("row_block_capacity exceeded")
        if rc == 3:
            raise RuntimeError("planner invariant violation")
        sym.patterns_stale = True
        m = int(mbuf[0])
        naffected = m - len(new_ids)
        F = F[:m].copy()
        nfr = int(nfrbuf[0])
        fringe_overflow = _bucket(nfr, (MIXED_FR,)) is None
        fringe = fringe[:0] if fringe_overflow else fringe[:nfr].copy()
        new_rows = sym.pad_idx[F]
        new_nnz = sym.pad_nnz[F]
    else:
        # 2. mark affected (walk to root with OLD parents; new nodes
        #    isolated)
        touched = []
        for f in range(f0, f1):
            a, b = g.fnodes[f]
            touched.append(int(a))
            if b >= 0:
                touched.append(int(b))
        F = sym_mod.mark_affected(sym, touched)
        naffected = len(F)
        new_pos = np.asarray([int(sym.pos[i]) for i in new_ids],
                             dtype=np.int32)
        F = np.unique(np.concatenate([F, new_pos])) if len(new_pos) else F
        m = len(F)
        if _bucket(m, buckets) is None:
            return None
        # 3. symbolic update: pattern growth + new parents (the structural
        #    equivalent of search_tree_append, aprilsam.c:958-987)
        edges = [(int(g.fnodes[f][0]), int(g.fnodes[f][1]))
                 for f in range(f0, f1)]
        sym_mod.update_patterns_incremental(sym, F, edges)
        new_rows, new_nnz = _padded_rows(sym.patterns, F, BCAP, NCAP)
        # 4. fringe (children of F outside F, in the NEW tree)
        fringe = sym_mod.fringe_of(sym, F)
        fringe_overflow = _bucket(len(fringe), (MIXED_FR,)) is None
        if fringe_overflow:
            fringe = fringe[:0]

    # full-path steps never read the fringe (the sweep updates every node)
    if naffected > cfg.small_path_max or fringe_overflow:
        fringe = fringe[:0]

    tail = step_tail(g, f0, f1, new_ids, seeds)
    if len(tail.nf_a) > K or len(tail.np_node) > K:
        raise OverflowError("new_factor_capacity exceeded; raise it in config")

    def slots_of(nodes):
        p = sym.pos[nodes]
        s = np.searchsorted(F, p)
        if len(p) and (np.any(s >= m) or np.any(F[np.minimum(s, m - 1)] != p)):
            raise RuntimeError("factor endpoint outside the affected set")
        return s.astype(np.int64)

    F64 = F.astype(np.int64)
    return StepPlan(
        m=m, naffected=naffected, maxaff=_bucket(m, buckets),
        max_rnnz=int(new_nnz.max()) if m else 0,
        fringe_overflow=fringe_overflow,
        tail=tail,
        F_pos=F64,
        F_node=sym.order[F].astype(np.int64),
        new_ridx=new_rows.astype(np.int64),
        new_nnz=new_nnz.astype(np.int64),
        nf_a_slot=slots_of(tail.nf_a), nf_b_slot=slots_of(tail.nf_b),
        np_slot=slots_of(tail.np_node),
        fringe_pos=fringe.astype(np.int64),
        fringe_node=sym.order[fringe].astype(np.int64),
    )


# ======================================================================
# device step
# ======================================================================
#
# A dispatch runs on tensors padded to its signature, as in the JAX
# package: M = plan.maxaff front slots, K new factors of each type, knode
# new nodes, kseed seeds and MIXED_FR fringe slots.  Dead slots read
# harmless rows and write to the dump rows of the state's tables
# (state.py); a dead front slot gets identity on R_F's diagonal and zero y
# (the JAX package's incremental.py:750), so the QR leaves +1 on its
# diagonal.  P["ctl"] holds the counts the body reads:
#   [m, kx, kp, nfr, nnodes, n_xyt, n_pos, log_idx]
# the step's live front rows, new xyt and xytpos factors and fringe rows;
# the node and factor counts after the step; and the metric-ring row its
# chi2 goes to (the ring's dump row when it is not logged).  A dead
# dispatch (precompile) has zeros there and changes nothing.  So the
# launch sequence of a body depends on its signature only, which is what
# a CUDA graph captures (utils/cache.py); the host counts of DeviceState
# advance outside the bodies (advance_counts).

def _pad(a, n: int, fill, dtype=np.int64) -> np.ndarray:
    a = np.asarray(a)
    out = np.full((n,) + a.shape[1:], fill, dtype=dtype)
    out[:len(a)] = a
    return out


def tail_inputs(ds: DeviceState, tail: StepTail, K: int, knode: int,
                kseed: int) -> Tuple[Dict[str, np.ndarray],
                                     Dict[str, np.ndarray]]:
    """A step tail padded to (knode, kseed, K): the ingestion arrays of a
    dispatch (ints, floats), with the table rows its factors append to."""
    NCAP = ds.state.shape[0]
    FCAP, FPOS = ds.xyt_a.shape[0], ds.pos_node.shape[0]
    kx, kp = len(tail.nf_a), len(tail.np_node)
    if ds.n_xyt + kx > FCAP:
        raise OverflowError("xyt factor capacity exceeded")
    if ds.n_pos + kp > FPOS:
        raise OverflowError("xytpos factor capacity exceeded")
    f64 = np.float64
    ints = dict(
        node_ids=_pad(tail.node_ids, knode, NCAP),
        seed_src=_pad(tail.seed_src, kseed, 0),
        seed_dst=_pad(tail.seed_dst, kseed, NCAP),
        seed_inv=_pad(tail.seed_inv, kseed, 0),
        nf_a=_pad(tail.nf_a, K, 0), nf_b=_pad(tail.nf_b, K, 0),
        nf_row=_pad(np.arange(ds.n_xyt, ds.n_xyt + kx), K, FCAP),
        np_node=_pad(tail.np_node, K, 0),
        np_row=_pad(np.arange(ds.n_pos, ds.n_pos + kp), K, FPOS))
    floats = dict(
        node_states=_pad(tail.node_states, knode, 0.0, f64),
        seed_z=_pad(tail.seed_z, kseed, 0.0, f64),
        nf_z=_pad(tail.nf_z, K, 0.0, f64), nf_W=_pad(tail.nf_W, K, 0.0, f64),
        np_z=_pad(tail.np_z, K, 0.0, f64), np_W=_pad(tail.np_W, K, 0.0, f64))
    return ints, floats


def step_inputs(ds: DeviceState, plan: StepPlan, K: int, knode: int,
                kseed: int, log_chi2: bool, **extra: np.ndarray):
    """The arrays of one step dispatch padded to its signature (front
    slots plan.maxaff, K, knode, kseed, MIXED_FR fringe slots), with
    P["ctl"]; `extra` adds further index arrays.  Returns (ints,
    floats)."""
    NCAP = ds.state.shape[0]
    M = plan.maxaff
    ints, floats = tail_inputs(ds, plan.tail, K, knode, kseed)
    t = plan.tail
    LOG = ds.chi2_log.shape[0]
    if plan.m > 0:
        kx, kp = len(t.nf_a), len(t.np_node)
        log_idx = ds.log_ptr if log_chi2 and ds.log_ptr < LOG else LOG
        ctl = [plan.m, kx, kp, len(plan.fringe_pos),
               ds.nnodes + len(t.node_ids), ds.n_xyt + kx, ds.n_pos + kp,
               log_idx]
    else:
        ctl = [0] * 7 + [LOG]
    ints.update(
        ctl=np.asarray(ctl, dtype=np.int64),
        F_pos=_pad(plan.F_pos, M, NCAP), F_node=_pad(plan.F_node, M, NCAP),
        new_ridx=_pad(plan.new_ridx, M, NCAP),
        new_nnz=_pad(plan.new_nnz, M, 0),
        nf_a_slot=_pad(plan.nf_a_slot, K, M),
        nf_b_slot=_pad(plan.nf_b_slot, K, M),
        np_slot=_pad(plan.np_slot, K, M),
        fringe_pos=_pad(plan.fringe_pos, MIXED_FR, NCAP),
        fringe_node=_pad(plan.fringe_node, MIXED_FR, NCAP), **extra)
    return ints, floats


def advance_counts(ds: DeviceState, tail: StepTail, logged: bool) -> None:
    """The host counts after a dispatch of `tail` (logged: it wrote one
    metric-ring entry)."""
    ds.nnodes += len(tail.node_ids)
    ds.n_xyt += len(tail.nf_a)
    ds.n_pos += len(tail.np_node)
    ds.log_ptr += int(logged)


def empty_tail() -> StepTail:
    z = np.zeros(0, dtype=np.int64)
    f3, f33 = np.zeros((0, 3)), np.zeros((0, 3, 3))
    return StepTail(node_ids=z, node_states=f3, seed_src=z, seed_dst=z,
                    seed_inv=np.zeros(0, dtype=bool), seed_z=f3, nf_a=z,
                    nf_b=z, nf_z=f3, nf_W=f33, np_node=z, np_z=f3, np_W=f33)


def dead_plan(M: int, BCAP: int) -> StepPlan:
    """A plan with no live slot at bucket M (precompile's input): its
    dispatch leaves the solver state as it was."""
    z = np.zeros(0, dtype=np.int64)
    return StepPlan(m=0, naffected=0, maxaff=M, max_rnnz=0,
                    fringe_overflow=False, tail=empty_tail(), F_pos=z,
                    F_node=z, new_ridx=np.zeros((0, BCAP), dtype=np.int64),
                    new_nnz=z, nf_a_slot=z, nf_b_slot=z, np_slot=z,
                    fringe_pos=z, fringe_node=z)


def inc_ingest_tail(ds: DeviceState,
                    P: Dict[str, torch.Tensor]) -> torch.Tensor:
    """New nodes + odometry seeding + factor-table appends, in place (the
    first part of every step, and the whole of the plan-overflow path).
    P holds a padded tail (tail_inputs).  Returns a placeholder stats
    vector."""
    state, l_point = full(ds.state), full(ds.l_point)
    ids, st = P["node_ids"], P["node_states"]
    state[ids] = st
    l_point[ids] = st
    # index_fill_ takes the scalar on the host; an indexed assignment
    # of 0.0 would copy it to the card and wait for the copy
    full(ds.delta_X).index_fill_(0, ids, 0.0)
    # dst = src (+) z, or src (+) inv(z) (aprilsam_demo.c:180-191)
    z = P["seed_z"]
    z_eff = torch.where(P["seed_inv"][:, None] != 0, xyt_inv(z), z)
    seeded = xyt_mul(state[P["seed_src"]], z_eff)
    state[P["seed_dst"]] = seeded
    l_point[P["seed_dst"]] = seeded
    rows = P["nf_row"]
    full(ds.xyt_a)[rows] = P["nf_a"]
    full(ds.xyt_b)[rows] = P["nf_b"]
    full(ds.xyt_z)[rows] = P["nf_z"]
    full(ds.xyt_W)[rows] = P["nf_W"]
    rows = P["np_row"]
    full(ds.pos_node)[rows] = P["np_node"]
    full(ds.pos_z)[rows] = P["np_z"]
    full(ds.pos_W)[rows] = P["np_W"]
    return torch.zeros(1, dtype=ds.chi2_log.dtype, device=ds.device)


def _psd_ok(Wh, W, valid):
    """The QR update is a Cholesky UPdate: an indefinite W cannot be
    represented (the reference NaNs on it, smatd.c:669-699, and ignores its
    own is_spd flag — this escalates to a batch instead).  Rows where
    `valid` is False pass."""
    Wsym = torch.triu(W) + torch.triu(W, 1).transpose(1, 2)
    err = torch.abs(torch.einsum("fki,fkj->fij", Wh, Wh) - Wsym)
    scale = 1e-3 * (1.0 + torch.abs(Wsym).amax(dim=(1, 2)))
    return torch.all(torch.where(valid, err.amax(dim=(1, 2)) <= scale, True))


def _measurement_rows(Wh, J_slots, M: int):
    """Stack W^{1/2} J for factors whose Jacobian blocks land at front
    slots: J_slots is a list of (slot [F], block [F, 3, 3]); slot M is a
    dump column (dead factors).  Returns [3F, 3M]."""
    F = Wh.shape[0]
    rows = torch.zeros(F, M + 1, 9, dtype=Wh.dtype, device=Wh.device)
    for slot, blk in J_slots:
        rows.scatter_add_(1, slot.view(F, 1, 1).expand(F, 1, 9),
                          blk.reshape(F, 1, 9))
    rows = rows[:, :M].reshape(F, M, 3, 3)
    return rows.permute(0, 2, 1, 3).reshape(3 * F, 3 * M)


def _frontal_core(ds: DeviceState, P: Dict[str, torch.Tensor], M: int):
    """Ingest the step, then the dense frontal QR update of the affected
    rows; writes R' and y' back on the new pattern.  P holds the padded
    plan (step_inputs).  Returns (R_up [3M, 3M], y_new [3M], spd (0-d
    bool), pos2f, row_valid [M])."""
    NCAP = ds.state.shape[0]
    dtype, dev = ds.R_blocks.dtype, ds.device
    K3 = 3 * M
    inc_ingest_tail(ds, P)
    ctl = P["ctl"]
    R_blocks, R_idx, y = full(ds.R_blocks), full(ds.R_idx), full(ds.y)

    # ---------------- frontal gather: RF[r, c] = R block of row F[r] at
    # column F[c]; pos2f maps a position to its front slot (else -1).  Dead
    # slots (F_pos = NCAP) map at NCAP + 1: the pattern padding NCAP stays
    # -1.
    F_pos = P["F_pos"]
    ar = torch.arange(M, device=dev)
    row_valid = ar < ctl[0]
    live3 = row_valid.repeat_interleave(3)
    pos2f = torch.full((NCAP + 2,), -1, dtype=torch.int64, device=dev)
    pos2f[F_pos + (~row_valid)] = ar
    rows = torch.where(row_valid[:, None, None, None], R_blocks[F_pos], 0.0)
    gather_fc = pos2f[R_idx[F_pos].clamp(0, NCAP)]           # [M, BCAP]
    RF = torch.zeros(M, M + 1, 3, 3, dtype=dtype, device=dev)
    RF[ar[:, None], torch.where(gather_fc >= 0, gather_fc, M)] = rows
    R_dense = RF[:, :M].permute(0, 2, 1, 3).reshape(K3, K3)
    R_dense = R_dense + torch.diag((~live3).to(dtype))
    y_F = torch.where(row_valid[:, None], y[F_pos], 0.0).reshape(K3)

    # ---------------- stacked square-root measurement rows
    # (aprilsam.c:508-542 as a QR factor update)
    K = P["nf_a"].shape[0]
    xv = torch.arange(K, device=dev) < ctl[1]
    pv = torch.arange(K, device=dev) < ctl[2]
    nf_W, np_W = P["nf_W"], P["np_W"]
    ev = eval_xyt(ds.l_point, P["nf_a"], P["nf_b"], P["nf_z"], nf_W)
    evp = eval_xytpos(ds.state, P["np_node"], P["np_z"], np_W)
    # W^T/2 via the closed-form 3x3 Cholesky (reads the upper triangle
    # only); tiny jitter keeps PSD-singular priors finite; dead factors
    # get zero rows
    Wh_xyt = torch.where(xv[:, None, None], chol3(nf_W, jitter=1e-12), 0.0)
    Wh_pos = torch.where(pv[:, None, None], chol3(np_W, jitter=1e-12), 0.0)
    w_ok = _psd_ok(Wh_xyt, nf_W, xv) & _psd_ok(Wh_pos, np_W, pv)

    xyt_rows = _measurement_rows(
        Wh_xyt, [(P["nf_a_slot"], Wh_xyt @ ev.Ja),
                 (P["nf_b_slot"], Wh_xyt @ ev.Jb)], M)
    xyt_rhs = (Wh_xyt @ ev.r[:, :, None]).reshape(-1)
    pos_rows = _measurement_rows(Wh_pos, [(P["np_slot"], Wh_pos)], M)
    pos_rhs = (Wh_pos @ evp.r[:, :, None]).reshape(-1)

    C = torch.cat([R_dense, xyt_rows, pos_rows], dim=0)
    d_stack = torch.cat([y_F, xyt_rhs, pos_rhs], dim=0)

    # ---------------- thin QR refactor (aprilsam.c:850-906)
    Q, Rq = torch.linalg.qr(C, mode="reduced")
    sgn = torch.where(torch.diagonal(Rq) < 0, -1.0, 1.0).to(dtype)
    R_up = sgn[:, None] * Rq
    diag = torch.diagonal(R_up)
    spd = w_ok & torch.all(torch.where(
        live3, torch.isfinite(diag) & (diag > 0), True))

    # forward solve on y (aprilsam.c:702-719): y' = Q^T d
    y_new = sgn * (Q.T @ d_stack)
    y[F_pos] = y_new.reshape(M, 3)

    # ---------------- R' back on the NEW pattern: newblocks[r, b] =
    # Rt[r, front slot of new_ridx[r, b]], zero where the slot is padding
    Rt = R_up.reshape(M, 3, M, 3).permute(0, 2, 1, 3)
    new_ridx = P["new_ridx"]
    scat_fc = pos2f[new_ridx.clamp(0, NCAP)]
    Rt_p = torch.cat([Rt, torch.zeros(M, 1, 3, 3, dtype=dtype, device=dev)],
                     dim=1)
    R_blocks[F_pos] = Rt_p[ar[:, None], torch.where(scat_fc >= 0, scat_fc, M)]
    R_idx[F_pos] = new_ridx
    full(ds.R_nnz)[F_pos] = P["new_nnz"]
    return R_up, y_new, spd, pos2f, row_valid


def _relin_mask(dx, delta_xy: float, delta_theta: float):
    return ((torch.abs(dx[:, 0]) > delta_xy) | (torch.abs(dx[:, 1]) > delta_xy)
            | (torch.abs(dx[:, 2]) > delta_theta))


def _saturated(start_over):
    # the SPD / wall-clock escalations park start_over near INT_MAX; later
    # steps keep counting without wrapping
    return torch.clamp(start_over, max=1 << 30)


def _log_chi2(ds: DeviceState, ctl, chi2) -> None:
    """Write chi2 at the metric-ring row ctl[7] (the dump row: dropped)."""
    full(ds.chi2_log).index_copy_(0, ctl[7:8], chi2.reshape(1))


def _finish(ds: DeviceState, chi2, spd, ctl, log_chi2: bool) -> torch.Tensor:
    """Write the metric ring; return the policy stats [chi2, start_over,
    spd_ok] (cumulative since the last batch epoch)."""
    ds.spd_ok &= spd | (ctl[0] == 0)
    if log_chi2:
        _log_chi2(ds, ctl, chi2)
    dtype = ds.chi2_log.dtype
    return torch.stack([chi2.to(dtype), ds.start_over.to(dtype),
                        ds.spd_ok.to(dtype)])


def _step_chi2(ds: DeviceState, ctl, log_chi2: bool):
    if log_chi2:
        return state_chi2(ds, (ctl[5], ctl[6]))
    return torch.full((), float("nan"), dtype=ds.chi2_log.dtype,
                      device=ds.device)


def _fast_body(ds: DeviceState, P: Dict[str, torch.Tensor], M: int,
               delta_xy: float, delta_theta: float,
               log_chi2: bool) -> torch.Tensor:
    NCAP = ds.state.shape[0]
    dtype, dev = ds.state.dtype, ds.device
    R_up, y_new, spd, pos2f, row_valid = _frontal_core(ds, P, M)
    ctl = P["ctl"]
    rel, delta_X = full(ds.relinearized), full(ds.delta_X)

    # back-substitution restricted to F (exact: F is ancestor-closed)
    dxF = torch.linalg.solve_triangular(
        R_up, y_new[:, None], upper=True).reshape(M, 3)
    ids_F = P["F_node"]
    relF = _relin_mask(dxF, delta_xy, delta_theta) & row_valid
    newly = (relF & ~rel[ids_F]).sum()
    rel[ids_F] = rel[ids_F] | relF
    delta_X[ids_F] = dxF

    # fringe: children of F — x, delta_X and relinearization only
    # (solve_node visits them once and prunes, aprilsam.c:752-771).  Their
    # resident rows are current; slot 0 is their own diagonal block.
    fr_pos = P["fringe_pos"]
    fr_valid = torch.arange(fr_pos.shape[0], device=dev) < ctl[3]
    fr_rows = torch.where(fr_valid[:, None, None, None],
                          full(ds.R_blocks)[fr_pos], 0.0)   # [FR, BCAP, 3, 3]
    fc = pos2f[full(ds.R_idx)[fr_pos].clamp(0, NCAP)]        # [FR, BCAP]
    xw = torch.where((fc >= 0)[..., None], dxF[fc.clamp(min=0)], 0.0)
    off = torch.einsum("kbij,kbj->ki", fr_rows, xw)
    eye = torch.eye(3, dtype=dtype, device=dev)
    x_fr = solve_upper3(
        torch.where(fr_valid[:, None, None], fr_rows[:, 0], eye),
        torch.where(fr_valid[:, None], full(ds.y)[fr_pos] - off, 0.0))
    ids_fr = P["fringe_node"]
    relfr = _relin_mask(x_fr, delta_xy, delta_theta) & fr_valid
    newly = newly + (relfr & ~rel[ids_fr]).sum()
    rel[ids_fr] = rel[ids_fr] | relfr
    delta_X[ids_fr] = x_fr
    ds.start_over.copy_(_saturated(ds.start_over) + newly)

    state = full(ds.state)
    ok = row_valid & ~torch.any(torch.isnan(dxF), dim=1)
    new_state = full(ds.l_point)[ids_F] + dxF
    new_state = torch.cat([new_state[:, :2], mod2pi(new_state[:, 2:])], dim=1)
    state[ids_F] = torch.where(ok[:, None], new_state, state[ids_F])

    chi2 = _step_chi2(ds, ctl, log_chi2)
    return _finish(ds, chi2, spd, ctl, log_chi2)


def _refresh_nodes(ds: DeviceState, dx, member, delta_xy: float,
                   delta_theta: float) -> None:
    """State update of every node from its solution dx [NCAP, 3] where
    member [NCAP, 1] (solve_node, aprilsam.c:721-779): relinearization
    counting, state = l_point + dx, delta_X = dx."""
    relin = _relin_mask(dx, delta_xy, delta_theta) & member[:, 0]
    newly = (relin & ~ds.relinearized).sum()
    ds.start_over.copy_(_saturated(ds.start_over) + newly)
    ds.relinearized |= relin

    ok = member & ~torch.any(torch.isnan(dx), dim=1, keepdim=True)
    new_state = ds.l_point + dx
    new_state = torch.cat([new_state[:, :2], mod2pi(new_state[:, 2:])], dim=1)
    ds.state.copy_(torch.where(ok, new_state, ds.state))
    ds.delta_X.copy_(torch.where(ok, dx, ds.delta_X))


def _global_sweep(ds: DeviceState, n, PANEL: int, NPANB: int,
                  delta_xy: float, delta_theta: float) -> DeviceState:
    """Whole-graph back-substitution x = R^{-1} y and the update of every
    node (solve_node with pruning disabled, aprilsam.c:721-779) over the
    NPANB active panels; n (0-d tensor) is the node count."""
    NCAP = ds.state.shape[0]
    x_pos = panel_backsub(ds.R_blocks, ds.R_idx, ds.y, n, PANEL, NPANB)
    member = (torch.arange(NCAP, device=ds.device) < n)[:, None]
    _refresh_nodes(ds, x_pos[ds.pos], member, delta_xy, delta_theta)
    return ds


def _windowed_sweep(ds: DeviceState, panels, n, PANEL: int, delta_xy: float,
                    delta_theta: float) -> DeviceState:
    """Back-substitution and state update restricted to a panel WINDOW —
    the reference's pruned tree-gated descent (solve_node,
    aprilsam.c:721-779) at panel granularity.  `panels` [PW] holds
    descending panel indices padded at the end with -1; n (0-d tensor) is
    the node count.  Its cost grows with PW, not with the trajectory.
    Nodes outside the window keep their states and deltas; batch epochs
    and periodic full sweeps re-sync them."""
    NCAP = ds.state.shape[0]
    NPANMAX = NCAP // PANEL
    live = (torch.arange(NCAP, device=ds.device) < n)[:, None]
    # previous solution in POSITION space (delta_X is node-indexed)
    x_prev = torch.where(live, ds.delta_X[ds.order], 0.0)
    x_pos = panel_backsub_windowed(ds.R_blocks, ds.R_idx, ds.y, x_prev,
                                   panels, n, PANEL)
    # window membership per node, by panel
    pan_act = torch.zeros(NPANMAX + 1, dtype=torch.bool, device=ds.device)
    pan_act.index_fill_(0, torch.where(panels >= 0, panels, NPANMAX), True)
    member = pan_act[(ds.pos // PANEL).clamp(0, NPANMAX - 1)][:, None] & live
    dx = torch.where(member, x_pos[ds.pos], 0.0)
    _refresh_nodes(ds, dx, member, delta_xy, delta_theta)
    return ds


def _full_body(ds: DeviceState, P: Dict[str, torch.Tensor], M: int,
               PANEL: int, NPANB: int, delta_xy: float, delta_theta: float,
               log_chi2: bool) -> torch.Tensor:
    _R, _y, spd, _pos2f, _rv = _frontal_core(ds, P, M)
    ctl = P["ctl"]
    _global_sweep(ds, ctl[4], PANEL, NPANB, delta_xy, delta_theta)
    chi2 = _step_chi2(ds, ctl, log_chi2)
    return _finish(ds, chi2, spd, ctl, log_chi2)


def sweep_body(ds: DeviceState, P: Dict[str, torch.Tensor], PANEL: int,
               NPANB: int, delta_xy: float,
               delta_theta: float) -> torch.Tensor:
    """A standalone whole-graph sweep over the P["ctl"][0] nodes (flush's
    staleness clear, a bundle's coalesced sweep); returns [start_over]."""
    _global_sweep(ds, P["ctl"][0], PANEL, NPANB, delta_xy, delta_theta)
    return ds.start_over.reshape(1)


# ----------------------------------------------------------------------
# supersteps: a whole buffer of steps as ONE joint frontal update
# ----------------------------------------------------------------------
#
# B sequential frontal updates with fixed linearization points compose:
# after steps 1..B, R^T R = R_0^T R_0 + sum_i J_i^T W_i J_i whether the QRs
# ran one by one or as ONE joint qr([R_Fu ; W^{1/2} J_all]) on the union
# affected set Fu (a union of ancestor-closed sets is ancestor-closed, so
# the joint front is self-contained like the per-step one).  l_points are
# fixed within a buffer (updates move `state`; only batch epochs
# relinearize), so the equivalence is exact in exact arithmetic.  The one
# drift from per-step execution: a new node's odometry seed composes from
# the PRE-superstep state of its chain's base node (the host pre-composes
# the chains, IncrementalSolver._dispatch_superstep).  A superstep's stats
# carry the post-sweep start_over; its chi2 is logged once, after the
# sweep.


def _sup_caps(cfg: SolverConfig) -> Tuple[int, int, int]:
    """Capacities of a superstep plan: (knode, kseed, kfac)."""
    S = cfg.superstep_size
    return S + KNODE, S + KSEED, max(2 * S, cfg.new_factor_capacity)


def _superstep_stats(ds: DeviceState, stats: torch.Tensor, ctl,
                     log_chi2: bool) -> torch.Tensor:
    """Patch a superstep's stats after its sweep: stats[1] = start_over;
    with log_chi2, log the chi2 once and put it in stats[0]."""
    stats[1] = ds.start_over.to(stats.dtype)
    if log_chi2:
        chi2 = state_chi2(ds, (ctl[5], ctl[6]))
        _log_chi2(ds, ctl, chi2)
        stats[0] = torch.where(ctl[0] > 0, chi2.to(stats.dtype), stats[0])
    return stats


def inc_superstep(ds: DeviceState, P: Dict[str, torch.Tensor], M: int,
                  PANEL: int, NPANB: int, delta_xy: float,
                  delta_theta: float, log_chi2: bool) -> torch.Tensor:
    """One joint frontal update over the union affected set of a buffer of
    steps, then one whole-graph sweep that refreshes every node's state and
    the relinearization counters."""
    stats = _fast_body(ds, P, M, delta_xy, delta_theta, False)
    _global_sweep(ds, P["ctl"][4], PANEL, NPANB, delta_xy, delta_theta)
    return _superstep_stats(ds, stats, P["ctl"], log_chi2)


def inc_superstep_nosweep(ds: DeviceState, P: Dict[str, torch.Tensor],
                          M: int, delta_xy: float,
                          delta_theta: float) -> torch.Tensor:
    """A superstep WITHOUT the trailing sweep: the joint frontal update
    solves the union front + fringe exactly (so the next buffer's odometry
    seeds read post-front states); the refresh of the other nodes waits for
    the next swept superstep (cfg.sweep_every_supersteps), a batch epoch or
    flush()."""
    return _fast_body(ds, P, M, delta_xy, delta_theta, False)


def inc_superstep_win(ds: DeviceState, P: Dict[str, torch.Tensor], M: int,
                      PANEL: int, delta_xy: float, delta_theta: float,
                      log_chi2: bool) -> torch.Tensor:
    """inc_superstep with a WINDOWED sweep over the panels P["panels"]
    ([PW], descending, padded with -1): O(PW) per superstep instead of
    O(N / PANEL).  The large-N throughput mode."""
    stats = _fast_body(ds, P, M, delta_xy, delta_theta, False)
    _windowed_sweep(ds, P["panels"], P["ctl"][4], PANEL, delta_xy,
                    delta_theta)
    return _superstep_stats(ds, stats, P["ctl"], log_chi2)


def packed_words(M: int, K: int, RCAP: int, half: bool, float_words: int,
                 knode: int = KNODE, kseed: int = KSEED) -> int:
    """Length in int32 words of the JAX package's packed plan of one mixed
    slot at affected-set bucket M (incremental.py:packed_layout, with the
    MIXED_FR fringe): control ints, the float payload as raw words, and
    M pattern rows of RCAP columns (int16 pairs when `half`)."""
    ints = 3 * M + 6 * K + 2 * MIXED_FR + knode + 3 * kseed + 8
    floats = (24 * K + 3 * knode + 3 * kseed) * float_words
    return ints + floats + M * (RCAP // 2 if half else RCAP)


# ======================================================================
# solver
# ======================================================================

@dataclass
class _Pending:
    """A dispatch's policy stats on their way to the host."""

    step: int
    stats: torch.Tensor          # [3], or a bundle's [k, 3], on the host
                                 # (pinned, from the card)
    done: Optional["torch.cuda.Event"]  # the copy's event; None = on host
    dispatched_after_batch: int  # batch-epoch serial at dispatch time
    step_ms: float = 0.0         # wall-clock estimate for the deferred gate
                                 # (dispatch-to-dispatch interval / steps;
                                 # 0.0 = unknown, gate inactive)
    row: int = -1                # the step's row in a bundle's stats

    def is_ready(self) -> bool:
        return self.done is None or self.done.query()

    def read(self) -> np.ndarray:
        if self.done is not None:
            if trace.ON and not self.done.query():
                trace.count("stats.waits")
            with trace.span("solver.stats_wait"):
                self.done.synchronize()
        stats = self.stats.numpy()
        return stats[self.row] if self.row >= 0 else stats


def _stats_to_host(stats: torch.Tensor):
    """Start the copy of a dispatch's stats to pinned host memory; returns
    (host tensor, event that completes with the copy).  A CPU tensor is
    already there."""
    if stats.device.type != "cuda":
        return stats, None
    host = torch.empty(stats.shape, dtype=stats.dtype, pin_memory=True)
    host.copy_(stats, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


class IncrementalSolver:
    """Counterpart of the reference's incremental API: solve() runs a batch
    epoch, update() an AprilSAM incremental step with automatic batch
    fallback.  With cfg.policy_lag == 0 and superstep_size == 1 every step
    is synchronous (update() returns its BatchInfo); otherwise the policy
    reads each dispatch's stats policy_lag dispatches later, update() returns
    None, and flush() ends a replay."""

    def __init__(self, cfg: Optional[SolverConfig] = None, device="cuda",
                 graphs: bool = True):
        self.cfg = cfg or SolverConfig()
        self.device = resolve_device(device)
        setup_precision()
        self.ds = init_device_state(self.cfg, self.device)
        # one CUDA graph per signature on the card (graphs=False: every
        # dispatch eager, to time the two; the CPU is always eager)
        self.graphs = GraphCache(self.device, enabled=graphs)
        self.sym: Optional[SymbolicState] = None
        self.factor_num = 0
        self.node_num = 0
        self.batch_time_ms = 0.0
        self._ingested_nodes = 0
        self._ingested_factors = 0
        self.last_path = "none"
        self.last_naffected = 0
        self.steps_done = 0
        # steps by path, batch epochs (and by the backend that ran them);
        # in bundles, the full steps whose sweep was coalesced and the
        # coalesced sweeps; in superstep mode the union front's size, the
        # supersteps without a sweep, the windowed sweeps and the sweeps
        # flush() ran
        self.counters = {"fast": 0, "full": 0, "batch": 0, "epoch_panel": 0,
                         "epoch_dense": 0, "epoch_host": 0,
                         "full_coalesced": 0, "sweep_coalesced": 0,
                         "superstep": 0, "sup_overflow": 0, "sup_m_max": 0,
                         "sup_m_sum": 0, "sup_nosweep": 0, "sweep_win": 0,
                         "sweep_flush": 0}
        # capacity growths: the step that caused each, the capacities after
        # it, its host ms and, on the card, the memory reserved before and
        # after it
        self.growths: list = []
        self._batch_serial = 0
        self._pending: deque = deque()
        self._due_since_poll = 0
        # planned, not yet dispatched bundle slots: (plan, fast)
        self._queue: list = []
        self._queue_sig = None
        # buffered raw steps of a superstep: (f0, f1, n_old, n1, seeds, g)
        self._sbuf: list = []
        self._sbuf_counts = [0, 0, 0, 0]     # nodes, seeds, xyt, pos
        # wall-clock of the previous dispatch: the dispatch-to-dispatch
        # interval per step feeds the deferred batch_time/3 gate
        # (aprilsam.c:557-559)
        self._last_dispatch_t: Optional[float] = None
        self._sweep_stale = False     # nodes outside the last fronts are
        self._sup_since_sweep = 0     # behind (nosweep / windowed modes)
        self._sweep_serial = 0
        # the pure-python planner in place of the native one (tests)
        self.python_planner = False

    # ---------------------------------------------------------------

    def _ingest(self, g: FactorGraph, to_node: int = None,
                to_factor: int = None):
        self.ds = ingest_graph(self.ds, g, self.cfg, self._ingested_nodes,
                               self._ingested_factors, to_node, to_factor)
        self._ingested_nodes = g.nnodes if to_node is None else to_node
        self._ingested_factors = (g.nfactors if to_factor is None
                                  else to_factor)

    def _apply_seeds(self, seeds: Sequence[SeedSpec]):
        """Odometry seeding outside the step (the fallback path for tails
        beyond the step capacities): dst = src (+) z, in order."""
        ds = self.ds
        for s in seeds:
            z = torch.as_tensor(np.asarray(s.z), dtype=ds.state.dtype,
                                device=ds.device)
            if s.invert:
                z = xyt_inv(z)
            seeded = xyt_mul(ds.state[s.src], z)
            ds.state[s.dst] = seeded
            ds.l_point[s.dst] = seeded

    def _ingest_tail_fast(self, g: FactorGraph, seeds: Sequence[SeedSpec],
                          caps: Optional[Tuple[int, int, int]] = None,
                          limits: Optional[Tuple[int, int]] = None) -> bool:
        """Ingest the un-ingested tail + seeds as one step payload, for the
        plan-overflow batch path.  Returns False when the tail exceeds the
        capacities `caps` = (knode, kseed, kfac), default the per-step ones
        (the caller then uses _ingest + _apply_seeds).  `limits` = (n_end,
        f_end) bounds the tail (a superstep's buffered span)."""
        knode, kseed, K = caps or (KNODE, KSEED,
                                   self.cfg.new_factor_capacity)
        n0, f0 = self._ingested_nodes, self._ingested_factors
        n_end, f_end = limits or (g.nnodes, g.nfactors)
        new_ids = list(range(n0, n_end))
        seeds = _dedup_seeds(seeds)
        dsts = {s.dst for s in seeds}
        if (len(new_ids) > knode or len(seeds) > kseed
                or any(s.src in dsts for s in seeds)):
            return False
        tail = step_tail(g, f0, f_end, new_ids, seeds)
        if len(tail.nf_a) > K or len(tail.np_node) > K:
            return False
        self._dispatch_ingest(tail, (knode, kseed, K))
        self._ingested_nodes = n_end
        self._ingested_factors = f_end
        return True

    def _dispatch_ingest(self, tail: StepTail,
                         caps: Tuple[int, int, int]) -> None:
        knode, kseed, K = caps
        ds = self.ds
        with trace.span("solver.inputs"):
            ints, floats = tail_inputs(ds, tail, K, knode, kseed)
        self.graphs.run(("ingest", knode, kseed, K), ds, ints, floats,
                        lambda P: inc_ingest_tail(ds, P))
        advance_counts(ds, tail, False)

    def _grow_row_capacity(self):
        cfg = dataclasses.replace(
            self.cfg,
            row_block_capacity=int(self.cfg.row_block_capacity * 3 // 2))
        NCAP, BCAP = cfg.node_capacity, cfg.row_block_capacity
        ds = self.ds
        with trace.span("solver.grow"):
            ds.R_blocks = with_dump_row(torch.zeros(
                (NCAP, BCAP, 3, 3), dtype=ds.R_blocks.dtype,
                device=ds.device))
            ds.R_idx = with_dump_row(torch.full(
                (NCAP, BCAP), NCAP, dtype=torch.int64, device=ds.device))
            ds.R_nnz = with_dump_row(torch.zeros(NCAP, dtype=torch.int64,
                                                 device=ds.device))
            self.cfg = cfg
            # the graphs read the freed tables
            self.graphs.bump()

    def _maybe_grow_capacity(self, g: FactorGraph) -> None:
        """Double node/factor capacities before the incoming step could
        overflow them (the reference's reallocs, aprilsam.c:411-450)."""
        cfg = self.cfg
        need_nodes = g.nnodes + KNODE + 1
        n_xyt = g.nf_xyt
        n_pos = g.nfactors - n_xyt
        FPOS = max(256, cfg.factor_capacity // 8)
        need_f = n_xyt + cfg.new_factor_capacity + 1
        need_p = n_pos + cfg.new_factor_capacity + 1
        if (need_nodes <= cfg.node_capacity and need_f <= cfg.factor_capacity
                and need_p <= FPOS):
            return
        ncap = cfg.node_capacity
        while need_nodes > ncap:
            ncap *= 2
        fcap = cfg.factor_capacity
        while need_f > fcap or need_p > max(256, fcap // 8):
            fcap *= 2

        # buffered and queued steps land in the old-capacity state first
        self._dispatch_queue()
        with trace.span("solver.grow"):
            t0 = time.perf_counter()
            cuda = self.device.type == "cuda"
            reserved = torch.cuda.memory_reserved(self.device) if cuda else 0
            old = state_to_numpy(self.ds)
            old_ncap = cfg.node_capacity
            self.cfg = dataclasses.replace(cfg, node_capacity=ncap,
                                           factor_capacity=fcap)
            h = state_to_numpy(init_device_state(self.cfg, "cpu"))
            for name, src in old.items():
                if src.ndim == 0:
                    h[name] = src
                    continue
                h[name][tuple(slice(0, s) for s in src.shape)] = src
            # the pattern padding used the OLD capacity
            h["R_idx"][h["R_idx"] >= old_ncap] = ncap
            # identity position map beyond the old capacity
            h["pos"][old_ncap:] = np.arange(old_ncap, ncap, dtype=np.int32)
            h["order"][old_ncap:] = np.arange(old_ncap, ncap, dtype=np.int32)
            # the graphs read the old state's tensors; what the old state and
            # its graphs held is sized for the old capacity: give it back
            self.ds = None
            self.graphs.bump()
            if cuda:
                torch.cuda.empty_cache()
            self.ds = state_from_numpy(h, self.device)
            self.growths.append({
                "step": g.nnodes - 1, "node_capacity": ncap,
                "factor_capacity": fcap,
                "ms": (time.perf_counter() - t0) * 1e3,
                "reserved_before": reserved,
                "reserved_after": (torch.cuda.memory_reserved(self.device)
                                   if cuda else 0)})

            # the native planner mirror is capacity-sized: rebuild it lazily
            sym = self.sym
            if sym is not None and getattr(sym, "pad_idx", None) is not None:
                sym.patterns = sym_patterns_list(sym)
                sym.patterns_stale = False
                sym.pad_idx = None
                sym.pad_nnz = None

    def _run_batch(self, g: FactorGraph, record_time: bool = False,
                   log_mode: int = 0, nnodes: int = None,
                   nfactors: int = None) -> BatchInfo:
        """A batch epoch over the first nnodes/nfactors of g (default all;
        a superstep's union-overflow fallback bounds it to the buffered
        span, because the device tables may not yet hold the caller's
        pending step).  Buffered and queued steps logically precede the
        epoch."""
        self._dispatch_queue()
        nn = g.nnodes if nnodes is None else nnodes
        nf = g.nfactors if nfactors is None else nfactors
        t0 = time.perf_counter()
        while True:
            try:
                info = self._epoch(g, nn, nf, log_mode)
                break
            except OverflowError:
                self._grow_row_capacity()
        if record_time and self.cfg.wallclock_gate \
                and self.device.type == "cuda":
            # the recorded batch time feeds the wall-clock gate
            torch.cuda.synchronize(self.device)
        if record_time:
            # param->batch_time is recorded only when a batch is triggered
            # from the incremental path (aprilsam.c:568-572)
            self.batch_time_ms = (time.perf_counter() - t0) * 1e3
        # the next dispatch interval would include this epoch's time
        self._last_dispatch_t = None
        self.factor_num = max(self.factor_num, nf)
        self.node_num = max(self.node_num, nn)
        self.last_path = "batch"
        self._sweep_stale = False
        self._batch_serial += 1
        self.counters["batch"] += 1
        return info

    def _use_host_batch(self) -> bool:
        return self.cfg.batch_backend not in ("device", "panel")

    def _epoch(self, g: FactorGraph, nn: int, nf: int,
               log_mode: int) -> BatchInfo:
        """One epoch on the configured backend, counted by the backend that
        ran it.  The device epochs are lazy in lagged mode: their BatchInfo
        then holds 0-d device tensors, and the epoch makes no synchronizing
        call."""
        from .host_batch import host_batch_epoch

        head = (self.cfg, nn, g.ftype[:nf], g.fnodes[:nf])
        with trace.span("epoch"):
            if not self._use_host_batch():
                try:
                    self.ds, self.sym, info, backend = run_batch_epoch(
                        self.ds, *head, log_mode=log_mode,
                        lazy=self.cfg.policy_lag > 0, graphs=self.graphs)
                    self.counters["epoch_" + backend] += 1
                    return info
                except PanelFallbackError:
                    # no panel plan at either grade where the dense epoch
                    # would not fit: the float64 host epoch (the JAX
                    # package's rule)
                    pass
            self.ds, self.sym, info = host_batch_epoch(
                self.ds, *head, g.fz[:nf], g.fW[:nf], log_mode=log_mode,
                graphs=self.graphs)
            self.counters["epoch_host"] += 1
            return info

    def solve(self, g: FactorGraph) -> BatchInfo:
        """Full batch solve (april_graph_cholesky)."""
        if g.nnodes == 0 or g.nfactors == 0:
            return BatchInfo(chi2=0.0, spd=True, n=0)
        self._maybe_grow_capacity(g)
        self._ingest(g)
        info = self._run_batch(g)
        self.steps_done += 1
        return BatchInfo(chi2=float(info.chi2), spd=bool(info.spd), n=info.n)

    # ---------------------------------------------------------------

    def _apply_policy(self, stats: np.ndarray, serial: int, step_ms: float,
                      g: FactorGraph) -> Optional[BatchInfo]:
        start_over = int(stats[1])
        spd = bool(stats[2] > 0.5)
        if serial != self._batch_serial:
            return None  # stats predate the last batch epoch
        if (self.cfg.wallclock_gate and step_ms > 0.0
                and self.batch_time_ms > 0.0
                and step_ms > self.batch_time_ms * self.cfg.batch_time_fraction):
            start_over = INT_MAX                       # aprilsam.c:557-559
        if self.cfg.check_spd and not spd:
            start_over = INT_MAX
        if start_over > self.cfg.nthreshold:           # aprilsam.c:566-575
            # synchronous: the epoch's chi2 replaces the triggering step's
            # ring entry; lagged: the ring is left alone
            mode = 1 if self.cfg.policy_lag == 0 else 2
            return self._run_batch(g, record_time=True, log_mode=mode)
        return None

    def _drain_pending(self, g: FactorGraph, block_all: bool = False):
        """Pop the due pending entries and apply the batch-fallback policy.

        The device counters are cumulative (start_over monotone since the
        last batch, spd AND-folded), so only ONE due entry is ever read, and
        cfg.policy_poll rations even those reads: the newest entry whose
        stats have reached the host, else the oldest due entry (the shortest
        wait).  The wall-clock gate (aprilsam.c:557-559) reads no stats: it
        runs on the host-recorded dispatch intervals of every due entry."""
        lag = self.cfg.policy_lag
        due = []
        while self._pending and (block_all or len(self._pending) > lag):
            due.append(self._pending.popleft())
        if not due:
            return
        self._due_since_poll += len(due)
        fresh = [p for p in due
                 if p.dispatched_after_batch == self._batch_serial]
        if not fresh:
            return
        mode = 1 if lag == 0 else 2
        if (self.cfg.wallclock_gate and self.batch_time_ms > 0.0 and
                any(p.step_ms > 0.0 and p.step_ms >
                    self.batch_time_ms * self.cfg.batch_time_fraction
                    for p in fresh)):
            self._due_since_poll = 0
            with trace.span("solver.policy"):
                self._run_batch(g, record_time=True, log_mode=mode)
            return
        if block_all or self._due_since_poll >= self.cfg.policy_poll:
            if block_all:
                p = fresh[-1]
            else:
                ready = [q for q in fresh if q.is_ready()]
                p = ready[-1] if ready else fresh[0]
            self._due_since_poll = 0
            with trace.span("solver.policy"):
                self._apply_policy(p.read(), p.dispatched_after_batch, 0.0,
                                   g)

    def _defer(self, stats: torch.Tensor, k: int) -> None:
        """Queue a dispatch's stats (covering k steps) for the lagged
        policy."""
        host, done = _stats_to_host(stats)
        self._pending.append(_Pending(
            self.steps_done - 1, host, done, self._batch_serial,
            step_ms=self._mark_dispatch(k)))

    def _mark_dispatch(self, k: int) -> float:
        """Advance the dispatch clock; return the per-step wall-clock
        estimate (previous dispatch-to-dispatch interval / k)."""
        now = time.perf_counter()
        step_ms = 0.0
        if self._last_dispatch_t is not None and k > 0:
            step_ms = (now - self._last_dispatch_t) * 1e3 / k
        self._last_dispatch_t = now
        return step_ms

    def update(self, g: FactorGraph,
               seeds: Sequence[SeedSpec] = ()) -> Optional[BatchInfo]:
        """Incremental update (april_graph_cholesky_inc).  Synchronous
        (policy_lag == 0, no supersteps): returns the step's BatchInfo.
        Otherwise returns None, and the policy applies as stats arrive
        (flush() at the end of a replay)."""
        if g.nnodes == 0 or g.nfactors == 0:
            return BatchInfo(chi2=0.0, spd=True, n=0)
        if self.sym is None or self.factor_num == g.nfactors:
            # guards (aprilsam.c:380-385); buffered and queued steps land
            # first
            self._dispatch_queue()
            return BatchInfo(chi2=float(state_chi2(self.ds)), spd=True, n=0)
        self._maybe_grow_capacity(g)

        if self.cfg.superstep_size > 1:
            return self._update_superstep(g, seeds)

        t0 = time.perf_counter()
        try:
            with trace.span("solver.plan"):
                plan = plan_step(self.sym, self.cfg, g, self.factor_num,
                                 g.nfactors, self.node_num, seeds,
                                 python_planner=self.python_planner)
        except OverflowError:
            plan = None
        self.factor_num = g.nfactors
        self.node_num = g.nnodes

        if plan is None:
            # plan overflow -> batch fallback; queued steps land first,
            # then the step's nodes, factors and seeds are ingested
            # (aprilsam_demo.c:180-191)
            self._dispatch_queue()
            if not self._ingest_tail_fast(g, seeds):
                self._ingest(g)
                self._apply_seeds(seeds)
            self.steps_done += 1
            return self._run_batch(g, record_time=True)

        self._ingested_nodes = g.nnodes
        self._ingested_factors = g.nfactors
        self.last_naffected = plan.naffected
        fast = (plan.naffected <= self.cfg.small_path_max
                and not plan.fringe_overflow)
        self.last_path = "fast" if fast else "full"
        self.counters[self.last_path] += 1
        if self.cfg.bundle_size > 1:
            return self._update_bundled(g, plan, fast)
        stats = self._dispatch_one(plan, fast, self._npanb(g.nnodes))
        self.steps_done += 1
        if self.cfg.policy_lag > 0:
            self._defer(stats, 1)
            self._drain_pending(g)
            return None
        if trace.ON and stats.device.type == "cuda" and not \
                torch.cuda.current_stream(stats.device).query():
            trace.count("stats.waits")      # the read below waits
        with trace.span("solver.stats_wait"):
            s = stats.cpu().numpy()
        step_ms = (time.perf_counter() - t0) * 1e3
        with trace.span("solver.policy"):
            info = self._apply_policy(s, self._batch_serial, step_ms, g)
        if info is not None:
            return info
        return BatchInfo(chi2=float(s[0]), spd=bool(s[2] > 0.5), n=g.nnodes)

    def _dispatch_one(self, plan: StepPlan, fast: bool,
                      npanb: int) -> torch.Tensor:
        return self._dispatch_step(plan, "fast" if fast else "full", npanb)

    def _dispatch_step(self, plan: StepPlan, kind: str, npanb: int = 0,
                       panels: Optional[np.ndarray] = None) -> torch.Tensor:
        """One dispatch of a planned step or superstep at its signature:
        kind "fast", "full" (per step), "sup", "supns", "win" (superstep;
        "win" sweeps the window `panels`).  Returns its stats (on the card
        the signature's stats buffer: the caller copies it before the
        signature runs again)."""
        cfg = self.cfg
        ds = self.ds
        M = plan.maxaff
        PANEL = cfg.panel_nodes
        dxy, dth = float(cfg.delta_xy), float(cfg.delta_theta)
        log = cfg.log_chi2 and kind != "supns"
        if kind in ("sup", "supns", "win"):
            knode, kseed, K = _sup_caps(cfg)
        else:
            knode, kseed, K = KNODE, KSEED, cfg.new_factor_capacity
        extra = {} if panels is None else {"panels": panels}
        with trace.span("solver.inputs"):
            ints, floats = step_inputs(ds, plan, K, knode, kseed, log,
                                       **extra)
        if kind == "fast":
            key = ("fast", M)
            body = lambda P: _fast_body(ds, P, M, dxy, dth, log)
        elif kind == "full":
            key = ("full", M, npanb)
            body = lambda P: _full_body(ds, P, M, PANEL, npanb, dxy, dth,
                                        log)
        elif kind == "sup":
            key = ("sup", M, npanb)
            body = lambda P: inc_superstep(ds, P, M, PANEL, npanb, dxy, dth,
                                           log)
        elif kind == "supns":
            key = ("supns", M)
            body = lambda P: inc_superstep_nosweep(ds, P, M, dxy, dth)
        else:
            key = ("win", M, len(panels))
            body = lambda P: inc_superstep_win(ds, P, M, PANEL, dxy, dth, log)
        stats = self.graphs.run(key, ds, ints, floats, body)
        advance_counts(ds, plan.tail, log and plan.m > 0)
        return stats

    def _dispatch_sweep(self, npanb: int, n: int) -> torch.Tensor:
        """A lone whole-graph sweep over n nodes; returns [start_over]."""
        cfg = self.cfg
        ds = self.ds
        dxy, dth = float(cfg.delta_xy), float(cfg.delta_theta)
        return self.graphs.run(
            ("sweep", npanb), ds, {"ctl": np.asarray([n], dtype=np.int64)},
            {}, lambda P: sweep_body(ds, P, cfg.panel_nodes, npanb, dxy,
                                     dth))

    def _npanb(self, nnodes: int) -> int:
        """Number of active sweep panels: the next power of two covering
        ceil(nnodes / PANEL), capped at node_capacity / PANEL."""
        PANEL = self.cfg.panel_nodes
        NPAN = self.cfg.node_capacity // PANEL
        b = 1
        while b * PANEL < nnodes and b < NPAN:
            b *= 2
        return min(b, NPAN)

    # ---------------------------------------------------------- bundles

    def _update_bundled(self, g: FactorGraph, plan: StepPlan,
                        fast: bool) -> None:
        """Queue a planned step; the queue dispatches as one bundle when
        the step's signature differs from the queue's (path, bucket and
        active panels; mixed bundles: the active panels only) and when it
        reaches its cap (bundle_size, or bundle_size_full for a full-path
        signature)."""
        cfg = self.cfg
        B = cfg.bundle_size
        npanb = self._npanb(g.nnodes)
        if self._fits_mixed(plan, fast):
            sig, cap = ("mixed", npanb), B
        elif fast:
            sig, cap = ("fast", plan.maxaff), B
        else:
            sig = ("full", plan.maxaff, npanb)
            cap = max(1, min(B, cfg.bundle_size_full))
        if self._queue and self._queue_sig != sig:
            self._dispatch_queue()
        self._queue_sig = sig
        self._queue.append((plan, fast))
        self.steps_done += 1
        if len(self._queue) >= cap:
            self._dispatch_queue()
        self._drain_pending(g)
        return None

    def _fits_mixed(self, plan: StepPlan, fast: bool) -> bool:
        """Whether the plan fits a mixed bundle (else it takes a bundle of
        its own signature): mixed bundles on, its pattern rows within
        ridx_pack_capacity, and its affected-set bucket a mixed one (the
        first, for a fast step)."""
        cfg = self.cfg
        rpack = cfg.effective_ridx_pack
        if (not cfg.mixed_bundles or plan.max_rnnz > rpack
                or rpack > cfg.row_block_capacity):
            return False
        if fast:
            return plan.maxaff <= MIXED_BUCKETS[0]
        return plan.maxaff in MIXED_BUCKETS

    def _mixed_chunks(self, entries: list) -> List[list]:
        """The chunks a mixed bundle dispatches in: the JAX package splits
        one whose packed slots, plus one dead slot, would exceed
        MIXED_FLAT_BUCKETS[-1] words (incremental.py:2271-2282), and with
        coalesce_full_solves each chunk sweeps on its own.  Only the length
        arithmetic of that layout is kept."""
        cfg = self.cfg
        RCAP = cfg.effective_ridx_pack
        float_words = 2 if self.ds.state.dtype == torch.float64 else 1
        half = cfg.node_capacity <= 32766 and RCAP % 2 == 0

        def length(M):
            return 1 + packed_words(M, cfg.new_factor_capacity, RCAP, half,
                                    float_words)

        dead = length(MIXED_BUCKETS[0])
        chunks, cur, cur_words = [], [], 0
        for entry in entries:
            w = length(entry[0].maxaff)
            if cur and cur_words + w + dead > MIXED_FLAT_BUCKETS[-1]:
                chunks.append(cur)
                cur, cur_words = [], 0
            cur.append(entry)
            cur_words += w
        chunks.append(cur)
        return chunks

    def _dispatch_queue(self) -> None:
        """Make the device state reflect every logical step: dispatch the
        superstep buffer, then the bundle queue (one bundle per chunk; a
        one-slot bundle of a fast or full signature as a single step), and
        queue each slot's stats row for the policy."""
        self._dispatch_superstep()
        if not self._queue:
            return
        cfg = self.cfg
        (entries, sig), self._queue = (self._queue, self._queue_sig), []
        self._queue_sig = None
        k = len(entries)
        npanb = sig[-1] if sig[0] != "fast" else 0
        if k == 1 and sig[0] != "mixed":
            plan, fast = entries[0]
            self._defer(self._dispatch_one(plan, fast, npanb), 1)
            return
        chunks = (self._mixed_chunks(entries) if sig[0] == "mixed"
                  else [entries])
        out = [self._dispatch_bundle(ch, npanb) for ch in chunks]
        if cfg.coalesce_full_solves:
            for ch in chunks:
                full = sum(not f for _p, f in ch)
                self.counters["full_coalesced"] += full
                self.counters["sweep_coalesced"] += full > 0
        step_ms = self._mark_dispatch(k)
        base = self.steps_done - k
        for ch, stats in zip(chunks, out):
            host, done = _stats_to_host(stats)
            for i in range(len(ch)):
                self._pending.append(_Pending(
                    base + i, host, done, self._batch_serial,
                    step_ms=step_ms, row=i))
            base += len(ch)

    def _dispatch_bundle(self, entries: list, npanb: int) -> torch.Tensor:
        """A bundle of consecutive steps, slot by slot with no host read in
        between: the JAX package's inc_bundle_fast (every slot fast),
        inc_bundle_full (every slot full) and inc_bundle_mixed, whose
        padding slots are no-ops and are not run here.  Each slot is one
        dispatch (one replay) of its single-step signature, and its stats
        row is copied out on the device.

        With coalesce_full_solves, a full slot runs its frontal update and
        the exact solve of its affected set (the fast-path algebra at its
        own bucket: F is ancestor-closed), and the whole-graph sweep that
        refreshes the other nodes runs once at the end when any slot was
        full; the last slot's row then carries the post-sweep start_over,
        so the policy sees the sweep's relinearizations.  Returns the stats
        [k, 3]."""
        coalesce = self.cfg.coalesce_full_solves
        ds = self.ds
        rows = torch.empty((len(entries), 3), dtype=ds.chi2_log.dtype,
                           device=ds.device)
        for i, (plan, fast) in enumerate(entries):
            rows[i] = self._dispatch_step(
                plan, "fast" if fast or coalesce else "full", npanb)
        if coalesce and not all(f for _p, f in entries):
            rows[-1, 1] = self._dispatch_sweep(npanb, ds.nnodes)[0]
        return rows

    # ------------------------------------------------------- supersteps

    def _update_superstep(self, g: FactorGraph,
                          seeds: Sequence[SeedSpec]) -> None:
        """Buffer one raw step; dispatch the buffer as ONE joint frontal
        update when it reaches superstep_size (or would overflow a
        capacity)."""
        knode, kseed, kfac = _sup_caps(self.cfg)
        f0, f1 = self.factor_num, g.nfactors
        n_old = self.node_num
        n_new = g.nnodes - n_old
        nx = int(np.sum(g.ftype[f0:f1] == FACTOR_XYT))
        npz = (f1 - f0) - nx
        if n_new > knode or len(seeds) > kseed or nx > kfac or npz > kfac:
            raise OverflowError("single step exceeds superstep capacities")
        c = self._sbuf_counts
        if self._sbuf and (c[0] + n_new > knode or c[1] + len(seeds) > kseed
                           or c[2] + nx > kfac or c[3] + npz > kfac):
            self._dispatch_superstep()
        self._sbuf.append((f0, f1, n_old, g.nnodes, list(seeds), g))
        c = self._sbuf_counts
        c[0] += n_new
        c[1] += len(seeds)
        c[2] += nx
        c[3] += npz
        self.factor_num = f1
        self.node_num = g.nnodes
        self.steps_done += 1
        self.last_path = "super"
        if len(self._sbuf) >= self.cfg.superstep_size:
            self._dispatch_superstep()
        self._drain_pending(g)
        return None

    @staticmethod
    def _compose_seeds(entries) -> List[SeedSpec]:
        """Pre-compose the buffer's seed chains on the host, so that every
        seed is one hop from a node whose state is current when the
        superstep starts (a node from before the buffer, or a new node
        ingested unseeded): state[dst] = state[base] (+) (z_1 (+) ... (+)
        z_j), exact since xyt composition is associative.  Last wins per
        dst.  Scalar float64, the formulas of geometry.np_xyt_mul and
        np_xyt_inv."""
        cur = {}
        for (_f0, _f1, _n0, _n1, seeds, _g) in entries:
            for s in seeds:
                zx, zy, zt = float(s.z[0]), float(s.z[1]), float(s.z[2])
                if s.invert:
                    si, ci = math.sin(zt), math.cos(zt)
                    zx, zy, zt = (-si * zy - ci * zx,
                                  -ci * zy + si * zx, -zt)
                if s.src in cur:
                    base, (ax, ay, at) = cur[s.src]
                    s2, c2 = math.sin(at), math.cos(at)
                    cur[s.dst] = (base, (c2 * zx - s2 * zy + ax,
                                         s2 * zx + c2 * zy + ay, at + zt))
                else:
                    cur[s.dst] = (int(s.src), (zx, zy, zt))
        return [SeedSpec(src=b, dst=int(d),
                         z=np.asarray(zc, dtype=np.float64), invert=False)
                for d, (b, zc) in cur.items()]

    def _dispatch_superstep(self) -> None:
        """Plan + dispatch the buffered steps as one joint frontal update
        on the union affected set; a union beyond the largest bucket falls
        back to a batch epoch (the reference's full-batch branch)."""
        if not self._sbuf:
            return
        entries, self._sbuf = self._sbuf, []
        self._sbuf_counts = [0, 0, 0, 0]
        g = entries[-1][5]
        f0, n_old = entries[0][0], entries[0][2]
        f1, n1 = entries[-1][1], entries[-1][3]
        k = len(entries)
        seeds_u = self._compose_seeds(entries)

        cfg = self.cfg
        knode, kseed, kfac = _sup_caps(cfg)
        try:
            with trace.span("solver.plan"):
                plan = plan_step(self.sym, cfg, g, f0, f1, n_old, seeds_u,
                                 python_planner=self.python_planner,
                                 knode=knode, kseed=kseed, kfac=kfac,
                                 buckets=cfg.effective_superstep_buckets,
                                 n_end=n1)
        except OverflowError:
            plan = None
        if plan is None:
            # union beyond the largest bucket -> batch fallback, bounded to
            # the buffered span (a capacity flush dispatches while the
            # caller's current step is still outside the buffer)
            self.counters["sup_overflow"] += 1
            if not self._ingest_tail_fast(g, seeds_u,
                                          caps=(knode, kseed, kfac),
                                          limits=(n1, f1)):
                self._ingest(g, to_node=n1, to_factor=f1)
                self._apply_seeds(seeds_u)
            self._run_batch(g, record_time=True, nnodes=n1, nfactors=f1)
            return
        self._ingested_nodes = n1
        self._ingested_factors = f1
        self.last_naffected = plan.naffected
        self.counters["superstep"] += 1
        self.counters["sup_m_sum"] += plan.m
        self.counters["sup_m_max"] = max(self.counters["sup_m_max"], plan.m)

        # sweep cadence: only every K-th superstep sweeps
        cadence = max(1, cfg.sweep_every_supersteps)
        if cadence > 1 and self._sup_since_sweep + 1 < cadence:
            self._sup_since_sweep += 1
            self._sweep_stale = True
            self.counters["sup_nosweep"] += 1
            self._defer(self._dispatch_step(plan, "supns"), k)
            return
        self._sup_since_sweep = 0

        # windowed sweep: refresh only the panels the union front + fringe
        # touch, unless the window overflows or a periodic full re-sync is
        # due
        PW = cfg.sweep_window_panels
        win = None
        if PW > 0:
            self._sweep_serial += 1
            periodic = (cfg.sweep_full_every > 0 and
                        self._sweep_serial % cfg.sweep_full_every == 0)
            pans = np.unique(np.concatenate(
                [plan.F_pos, plan.fringe_pos]) // cfg.panel_nodes)
            if not periodic and len(pans) <= PW:
                win = np.full(PW, -1, dtype=np.int64)
                win[:len(pans)] = pans[::-1]               # descending
        if win is not None:
            self._sweep_stale = True
            self.counters["sweep_win"] += 1
            stats = self._dispatch_step(plan, "win", panels=win)
        else:
            self._sweep_stale = False
            stats = self._dispatch_step(plan, "sup", self._npanb(g.nnodes))
        self._defer(stats, k)

    def flush(self, g: FactorGraph) -> None:
        """End of a replay: dispatch the buffered steps, clear any sweep
        staleness with one whole-graph sweep, and apply the policy to
        every pending entry."""
        with trace.span("solver.flush"):
            self._dispatch_queue()
            if self._sweep_stale:
                self.counters["sweep_flush"] += 1
                self._dispatch_sweep(self._npanb(g.nnodes), self.ds.nnodes)
                self._sweep_stale = False
            self._drain_pending(g, block_all=True)

    # ------------------------------------------------- ahead of time

    def default_signatures(self, nnodes: Optional[int] = None):
        """The step-shape signatures of the config and (optionally) the
        expected trajectory length: the JAX package's tuples, line for line
        (aprilsam_tpu/solver/incremental.py:default_signatures).  EVERY
        active-panel count the replay passes through is included (1, 2, 4,
        ... then npanb_max itself, which need not be a power of two): a
        growing trajectory crosses each doubling once.  MIXED_FR is the only
        fringe layout (plan_step sends larger-fringe fast steps to the full
        path), so the list covers every shape a replay dispatches."""
        fr = MIXED_FR
        npanb_max = self._npanb(nnodes if nnodes
                                else self.cfg.node_capacity)
        npanbs = []
        b = 1
        while b < npanb_max:
            npanbs.append(b)
            b *= 2
        # _npanb clamps to NPAN = node_capacity // panel_nodes, which need
        # not be a power of two: the terminal count is appended explicitly
        npanbs.append(npanb_max)
        if self.cfg.superstep_size > 1:
            # superstep mode: one signature per (union bucket, panel count);
            # a bucket is reachable at a panel count only if some
            # m <= npanb*PANEL lands in it
            sigs = []
            buckets = self.cfg.effective_superstep_buckets
            for npanb in npanbs:
                lim = npanb * self.cfg.panel_nodes
                for j, b in enumerate(buckets):
                    prev = buckets[j - 1] if j else 0
                    if prev < lim:
                        sigs.append(("sup", b, npanb))
            return tuple(sigs)
        sigs = [("fast", self.cfg.frontal_buckets[0], fr)]
        if self.cfg.mixed_bundles and self.cfg.bundle_size > 1:
            # mixed mode: one signature per active-panel count covers every
            # fast/full bucket
            sigs += [("mixed", npanb) for npanb in npanbs]
            return tuple(sigs)
        for b in self.cfg.frontal_buckets[:3]:
            for npanb in npanbs:
                sigs.append(("full", b, fr, npanb))
        # the biggest bucket is rare (plan overflow headroom): only the
        # late-trajectory panel counts it could realistically hit
        big = (self.cfg.frontal_buckets[3]
               if len(self.cfg.frontal_buckets) > 3 else None)
        if big is not None:
            sigs.append(("full", big, fr, npanb_max))
            second = npanbs[-2] if len(npanbs) > 1 else None
            if second is not None:
                sigs.append(("full", big, fr, second))
        return tuple(sigs)

    def _graph_signatures(self, sig) -> List[tuple]:
        """The port's dispatch signatures (kind, M, npanb) behind one of
        default_signatures' tuples: every graph a replay of that signature
        can run, in this config."""
        cfg = self.cfg
        coalesce = cfg.bundle_size > 1 and cfg.coalesce_full_solves
        if sig[0] == "sup":
            _s, M, npanb = sig
            out = [("sup", M, npanb)]
            if cfg.sweep_window_panels > 0:
                out.append(("win", M, 0))
            if cfg.sweep_every_supersteps > 1:
                out.append(("supns", M, 0))
            if cfg.sweep_window_panels > 0 or cfg.sweep_every_supersteps > 1:
                out.append(("sweep", 0, npanb))       # flush()'s sweep
            return out
        if sig[0] == "mixed":
            npanb = sig[1]
            if coalesce:
                return [("fast", b, 0) for b in MIXED_BUCKETS] + [
                    ("sweep", 0, npanb)]
            return [("fast", MIXED_BUCKETS[0], 0)] + [
                ("full", b, npanb) for b in MIXED_BUCKETS]
        if sig[0] == "fast":
            return [("fast", sig[1], 0)]
        out = [("full", sig[1], sig[3])]
        if coalesce:
            out += [("fast", sig[1], 0), ("sweep", 0, sig[3])]
        return out

    def precompile(self, signatures=None, nnodes: Optional[int] = None) -> int:
        """Prepare the step, superstep and bundle signatures ahead of time
        by running dead plans (m = 0) through each, as the JAX package
        compiles them: on the card, the first dispatch of each signature
        runs it eagerly and captures its CUDA graph, so no capture lands
        mid-run.  Dead dispatches write only the dump rows: the solver
        state is left as it was, at any point of a replay.  Returns the
        number of signatures (the JAX package's count: each of
        `signatures`, then the plan-overflow ingestion)."""
        cfg = self.cfg
        signatures = signatures or self.default_signatures(nnodes)
        BCAP = cfg.row_block_capacity
        PW = cfg.sweep_window_panels
        count = 0
        for sig in signatures:
            for kind, M, npanb in self._graph_signatures(sig):
                if kind == "sweep":
                    self._dispatch_sweep(npanb, 0)
                else:
                    self._dispatch_step(
                        dead_plan(M, BCAP), kind, npanb,
                        np.full(PW, -1, dtype=np.int64) if kind == "win"
                        else None)
            count += 1
        caps = (_sup_caps(cfg) if cfg.superstep_size > 1
                else (KNODE, KSEED, cfg.new_factor_capacity))
        self._dispatch_ingest(empty_tail(), caps)
        count += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._last_dispatch_t = None   # not part of the gate's clock
        return count

    # ---------------------------------------------------------------

    def chi2(self) -> float:
        self._dispatch_queue()
        return float(state_chi2(self.ds))

    def chi2_history(self) -> np.ndarray:
        """Per-optimize chi2 values from the metric ring."""
        self._dispatch_queue()
        n = self.ds.log_ptr
        LOG = self.ds.chi2_log.shape[0]
        if n > LOG:
            raise RuntimeError(
                f"chi2 metric ring overflowed ({n} entries, capacity {LOG}); "
                "raise SolverConfig.metric_log_capacity for this replay "
                "length")
        return self.ds.chi2_log[:n].cpu().numpy()

    def describe_tree(self, max_nodes: int = 50) -> str:
        """Human-readable elimination-tree dump (search_tree_print parity,
        aprilsam.c:677-690): per node its position, parent, children."""
        if self.sym is None:
            return "<no tree: run solve() first>"
        sym = self.sym
        if getattr(sym, "patterns_stale", False):
            # the native planner maintains parents and pads only
            sym.rebuild_children()
        patterns = sym_patterns_list(sym)
        lines = [f"root position: {sym.nnodes - 1} "
                 f"(node {int(sym.order[sym.nnodes - 1])}), "
                 f"nnodes: {sym.nnodes}"]
        for p in range(min(sym.nnodes, max_nodes)):
            kids = ",".join(str(c) for c in sym.children[p])
            lines.append(
                f" pos {p} (node {int(sym.order[p])}): "
                f"parent={int(sym.parents[p])} children=[{kids}] "
                f"nnz={len(patterns[p])}")
        if sym.nnodes > max_nodes:
            lines.append(f" ... ({sym.nnodes - max_nodes} more)")
        return "\n".join(lines)

    def sync_states(self, g: FactorGraph) -> None:
        self._dispatch_queue()
        n = g.nnodes
        g.state[:n] = self.ds.state[:n].cpu().numpy().astype(np.float64)
        g.l_point[:n] = self.ds.l_point[:n].cpu().numpy().astype(np.float64)
        g.delta_X[:n] = self.ds.delta_X[:n].cpu().numpy().astype(np.float64)
