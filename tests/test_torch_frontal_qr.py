"""Kernel K2, the frontal QR update, restated on the CPU.

The CUDA kernel (csrc/frontal_qr.cu) cannot run here; its algorithm is
restated in Python by ``frontal_qr.sweep`` (groups of ROWS live rows, the
first touched column, the column sweep with the kernel's reflector
formulas, over the live counts ctl gives), and these tests hold that
restatement to the plain version (LAPACK's QR of the stacked matrix, the
sign flip, Q^T d), which the wrapper takes on the CPU and which the port's
CPU tests run.  The shapes are the per-step buckets at the live counts of
an M3500 per-step pass (front nodes, factors), a superstep's, and the
frontal problems of two small replays of the port itself.  The kernel is
held to the plain version on the card by tests/test_torch_kernels_gpu.py
and chip_smoke.py.

Tolerances: relative to the largest entry, 1e-12 in float64 and 1e-5 in
float32; the two are the same Householder algebra in another order of
rounding, on triangles with a dominant diagonal."""

import pytest
import torch

from aprilsam_tpu_torch.datasets import manhattan_world
from aprilsam_tpu_torch.graph import FactorGraph
from aprilsam_tpu_torch.kernels import frontal_qr as K2
from aprilsam_tpu_torch.replay import replay_by_max_endpoint
from aprilsam_tpu_torch.solver import IncrementalSolver, SolverConfig
from aprilsam_tpu_torch.solver import incremental as inc
from aprilsam_tpu_torch.solver.incremental import SeedSpec
from aprilsam_tpu_torch.utils import trace

torch.set_num_threads(1)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def frontal_problem(*args, **kw):
    return K2.example(*args, **kw)[:4]


def _rel(a, b):
    """Largest difference over the largest entry of b (absolute where b is
    zero: a replay's first steps have y = 0)."""
    return ((a - b).abs().max() / b.abs().max().clamp(min=1.0e-300)).item()


def _hold(R, y, A, rhs, m, kx, kp, tol):
    got_R, got_y = K2.sweep(R, y, A, rhs, m, kx, kp)
    ref_R, ref_y = K2.frontal_qr_plain(R, y, A, rhs)
    assert _rel(got_R, ref_R) <= tol
    assert _rel(got_y, ref_y) <= tol
    assert torch.tril(got_R, -1).abs().max().item() == 0.0
    return got_R, ref_R


# (M, live nodes, xyt factors, position factors, K): the per-step buckets
# at the mean live front of each (an M3500 per-step pass: 2, 45, 126 and
# 303-350 nodes, 1-4 factors), position rows live, and a superstep's K
SHAPES = [(16, 2, 1, 0, 16), (64, 45, 2, 0, 16), (256, 126, 3, 0, 16),
          (1024, 350, 4, 0, 16), (256, 126, 2, 2, 16), (64, 45, 0, 3, 16),
          (384, 200, 60, 10, 128)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("M,nodes,nx,npos,K", SHAPES,
                         ids=[f"M{s[0]}-n{s[1]}-x{s[2]}-p{s[3]}-K{s[4]}"
                              for s in SHAPES])
def test_sweep_matches_plain(M, nodes, nx, npos, K, dtype):
    """Dead slots in every case; more than ROWS live rows take several
    sweeps (the superstep's 210)."""
    R, y, A, rhs = frontal_problem(M, nodes, nx, npos, K, seed=M + nodes,
                                   dtype=dtype)
    got, ref = _hold(R, y, A, rhs, nodes, nx, npos, TOL[dtype])
    # the dead slots come out as they went in
    nl = 3 * nodes
    assert torch.equal(got[nl:, nl:], R[nl:, nl:])
    assert torch.all(torch.diagonal(got)[:nl] > 0)


def test_new_node_with_a_zero_row():
    """A live new node's slot has a zero row of R; its factor fills it."""
    R, y, A, rhs = frontal_problem(64, 45, 2, 0, seed=3, zero_rows=(44,))
    A[0:3, 3 * 44:3 * 44 + 3] = torch.eye(3, dtype=R.dtype) * 10.0
    got, _ref = _hold(R, y, A, rhs, 45, 2, 0, TOL[torch.float64])
    assert torch.all(torch.diagonal(got)[:135] > 0)


def test_first_touched_column_past_zero():
    """The factors touch slots from 20 on: the 60 columns before them get
    identity reflectors, and a leading row with a negative diagonal is
    negated (as the plain version's sign flip does)."""
    R, y, A, rhs = frontal_problem(64, 45, 3, 1, seed=5, first=20,
                                   neg_diag=(4,))
    nz = torch.nonzero(A.ne(0).any(dim=0)).flatten()
    assert int(nz[0]) >= 60
    got, _ref = _hold(R, y, A, rhs, 45, 3, 1, TOL[torch.float64])
    assert torch.equal(got[:12], R[:12])              # slots 0-3 copied
    assert torch.equal(got[12, 12:], -R[12, 12:])     # slot 4 negated


def test_singular_column_leaves_a_zero_diagonal():
    """A live slot whose columns are zero in R and A (a node no factor
    reaches): its diagonal comes out 0 in both versions, so the step's spd
    goes false (the _frontal_core test: finite and positive on every live
    slot)."""
    R, y, A, rhs = frontal_problem(64, 45, 2, 0, seed=7, zero_rows=(30,))
    R[:, 90:93] = 0.0
    A[:, 90:93] = 0.0
    got, ref = _hold(R, y, A, rhs, 45, 2, 0, TOL[torch.float64])
    d = torch.diagonal(got)[:135]
    assert torch.equal(d[90:93], torch.zeros(3, dtype=R.dtype))
    assert torch.equal(torch.diagonal(ref)[90:93], d[90:93])
    assert not bool(torch.all(torch.isfinite(d) & (d > 0)))


def test_dead_plan_changes_nothing():
    """ctl = 0 (precompile's dead plans): the triangle and y are left."""
    R, y, A, rhs = frontal_problem(16, 2, 1, 0, seed=1)
    got_R, got_y = K2.sweep(R, y, A, rhs, 0, 0, 0)
    assert torch.equal(got_R, R) and torch.equal(got_y, y)


def test_wrapper_checks_and_cpu_route():
    """On the CPU the wrapper is the plain version; on any other device
    than the CPU and CUDA it raises."""
    R, y, A, rhs = frontal_problem(16, 2, 1, 0, seed=2)
    ctl = torch.tensor([2, 1, 0], dtype=torch.int64)
    got = K2.frontal_qr(R, y, A, rhs, ctl)
    ref = K2.frontal_qr_plain(R, y, A, rhs)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError, match="unsupported device"):
        K2.frontal_qr(R.to("meta"), y.to("meta"), A.to("meta"),
                      rhs.to("meta"), ctl.to("meta"))


def _record_problems(monkeypatch, keep: int):
    """Record up to `keep` frontal problems per (3M, p) as _frontal_core
    hands them to the frontal update, with their live counts."""
    seen = {}
    real = inc.frontal_qr

    def recorder(R, y, A, rhs, ctl):
        key = (R.shape[0], A.shape[0])
        got = seen.setdefault(key, [])
        if len(got) < keep and int(ctl[0]) > 0:
            got.append((R.clone(), y.clone(), A.clone(), rhs.clone(),
                        [int(v) for v in ctl[:3]]))
        return real(R, y, A, rhs, ctl)

    monkeypatch.setattr(inc, "frontal_qr", recorder)
    return seen


def _hold_recorded(seen):
    for (n, p), probs in seen.items():
        for R, y, A, rhs, (m, kx, kp) in probs:
            nl, K = 3 * m, p // 6
            # what the kernel takes for granted: R upper triangular, the
            # identity on dead slots, zero rows of dead factors, nothing
            # live in a dead column
            assert torch.tril(R, -1).abs().max().item() == 0.0
            assert torch.equal(R[nl:, nl:], torch.eye(n - nl,
                                                      dtype=R.dtype))
            assert torch.count_nonzero(R[:nl, nl:]) == 0
            live = list(range(3 * kx)) + list(range(3 * K, 3 * K + 3 * kp))
            dead = [i for i in range(p) if i not in live]
            assert torch.count_nonzero(A[dead]) == 0
            assert torch.count_nonzero(A[:, nl:]) == 0
            _hold(R, y, A, rhs, m, kx, kp, TOL[torch.float64])


def test_replay_problems_per_step(monkeypatch):
    """The frontal problems of a 300-pose per-step replay of the port,
    a few at each bucket, held as the kernel would solve them."""
    seen = _record_problems(monkeypatch, keep=4)
    cfg = SolverConfig(node_capacity=512, factor_capacity=2048,
                       row_block_capacity=64, panel_nodes=32,
                       wallclock_gate=False)
    s = IncrementalSolver(cfg, device="cpu")
    replay_by_max_endpoint(manhattan_world(300, seed=0), s, FactorGraph,
                           SeedSpec)
    assert {n for n, _p in seen} >= {48, 192}
    _hold_recorded(seen)


def test_replay_problems_with_priors_and_supersteps(monkeypatch):
    """Position priors every 25 poses (position rows live) per step, then
    the same graph in supersteps of 8 (K = 16) and 24 (K = 48)."""
    seen = _record_problems(monkeypatch, keep=3)
    g = manhattan_world(200, seed=1, geopin_every=25)
    base = dict(node_capacity=512, factor_capacity=2048,
                row_block_capacity=64, panel_nodes=32, wallclock_gate=False)
    for extra in ({}, {"superstep_size": 8}, {"superstep_size": 24}):
        s = IncrementalSolver(SolverConfig(**base, **extra), device="cpu")
        replay_by_max_endpoint(g, s, FactorGraph, SeedSpec)
    assert any(p == 6 * 48 for _n, p in seen)
    assert any(kp > 0 for probs in seen.values()
               for *_t, (_m, _kx, kp) in probs)
    _hold_recorded(seen)


def test_replay_counts_live_columns():
    """solver.counters["frontal_live_columns"]: 3 m summed over the
    frontal dispatches (a dead plan adds 0); trace.collect(solver) exports
    it beside K2's launches (none on the CPU)."""
    calls = []
    cfg = SolverConfig(node_capacity=512, factor_capacity=2048,
                       row_block_capacity=64, panel_nodes=32,
                       wallclock_gate=False)
    s = IncrementalSolver(cfg, device="cpu")
    real = s._dispatch_step

    def spy(plan, kind, *a, **kw):
        calls.append(3 * plan.m)
        return real(plan, kind, *a, **kw)

    s._dispatch_step = spy
    replay_by_max_endpoint(manhattan_world(60, seed=0), s, FactorGraph,
                           SeedSpec)
    assert calls and s.counters["frontal_live_columns"] == sum(calls)
    K2.reset_launches()
    got = trace.collect(s)["counters"]
    assert got["frontal.live_columns"] == sum(calls)
    assert got["frontal.launches"] == got["frontal.padded_columns"] == 0
