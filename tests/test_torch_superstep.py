"""The port's supersteps (superstep_size > 1) against the JAX package and
against their own algebra, on the CPU in float64.

At policy_lag=0 a superstep replay is deterministic, and the port takes the
JAX package's trajectory: metric-ring entries (one per superstep and per
batch epoch) within relative 1e-9 (values at rounding level of zero held to
an absolute 1e-20), states within 1e-9, the counters equal.  The two
differ only in rounding: both factor the union front padded to the same
bucket, through different LAPACK builds."""

import math

import numpy as np
import pytest
import torch

from aprilsam_tpu.datasets import manhattan_world as j_manhattan
from aprilsam_tpu.graph import FactorGraph as JGraph
from aprilsam_tpu.replay import Replay as JReplay
from aprilsam_tpu.solver import SolverConfig as JConfig
from aprilsam_tpu.solver.incremental import IncrementalSolver as JSolver

from aprilsam_tpu_torch.datasets import manhattan_world as t_manhattan
from aprilsam_tpu_torch.geometry import np_xyt_inv_mul
from aprilsam_tpu_torch.graph import FACTOR_XYT
from aprilsam_tpu_torch.kernels import tri_inv as K
from aprilsam_tpu_torch.replay import Replay as TReplay
from aprilsam_tpu_torch.solver import IncrementalSolver, SolverConfig

from test_torch_incremental import W_ODO, chain_graph, dense_R

torch.set_num_threads(1)

SUP = dict(node_capacity=512, factor_capacity=2048, row_block_capacity=64,
           panel_nodes=16, wallclock_gate=False)
CHI2_ATOL = 1e-20
N_REPLAY = 300
# manhattan_world(300, seed=0) at these capacities, from the JAX package
EXPECT = {8: {"superstep": 38, "batch": 2}, 32: {"superstep": 10,
                                                  "batch": 3}}


@pytest.fixture(scope="module", params=sorted(EXPECT), ids=lambda S: f"S{S}")
def jax_superstep(request):
    S = request.param
    rep = JReplay(j_manhattan(N_REPLAY, seed=0),
                  JConfig(**SUP, superstep_size=S), deferred=True)
    rep.run()
    return S, rep


def test_superstep_replay_matches_jax(jax_superstep):
    S, rep_j = jax_superstep
    rep_t = TReplay(t_manhattan(N_REPLAY, seed=0),
                    SolverConfig(**SUP, superstep_size=S), deferred=True,
                    device="cpu")
    res_t = rep_t.run()
    sj, st = rep_j.solver, rep_t.solver
    # deferred: no step reports its chi2; the ring holds one per superstep
    assert all(math.isnan(r.chi2) for r in res_t[1:])
    assert {r.path for r in res_t[1:]} <= {"super", "batch"}
    assert K.launches == 0            # CPU tensors take the plain version
    for k, v in sj.counters.items():
        assert st.counters[k] == v, k
    for k, v in EXPECT[S].items():
        assert st.counters[k] == v, k
    h_j, h_t = sj.chi2_history(), st.chi2_history()
    assert h_t.shape == h_j.shape == (EXPECT[S]["superstep"] + 1,)
    np.testing.assert_allclose(h_t, h_j, rtol=1e-9, atol=CHI2_ATOL)
    n = rep_t.graph.nnodes
    np.testing.assert_allclose(st.ds.state[:n].numpy(),
                               np.asarray(sj.ds.state[:n]), rtol=0,
                               atol=1e-9)


def test_superstep_matches_per_step_full_path():
    """B frontal updates with fixed l_points compose into one joint update:
    with no new nodes or seeds and the per-step run forced onto the
    (unpruned) full path, the two agree to rounding: states within 1e-9,
    R^T R within 1e-8."""
    n = 24
    closures = [(2, 17, 0.08), (4, 21, -0.06), (1, 11, 0.04), (9, 22, 0.05),
                (3, 15, -0.03), (6, 19, 0.02), (0, 13, 0.01), (8, 23, -0.02)]

    def replay(**kw):
        g = chain_graph(n, y_noise=0.05, seed=7)
        cfg = SolverConfig(**{**SUP, "panel_nodes": 32, "nthreshold": 10**9,
                              "log_chi2": False, **kw})
        s = IncrementalSolver(cfg, device="cpu")
        s.solve(g)
        for (a, b, dy) in closures:
            z = np_xyt_inv_mul(g.init[a], g.init[b]) + np.array([0.0, dy, 0])
            g.add_factor_xyt(a, b, z, W_ODO)
            s.update(g)
        s.flush(g)
        s.sync_states(g)
        R = dense_R(s)
        return g.state[:n].copy(), R.T @ R, s

    st_per, A_per, s_per = replay(small_path_max=0)
    st_sup, A_sup, s_sup = replay(superstep_size=4)
    assert s_per.counters["full"] == len(closures)
    assert s_sup.counters["superstep"] == len(closures) // 4
    np.testing.assert_allclose(st_sup, st_per, rtol=0, atol=1e-9)
    np.testing.assert_allclose(A_sup, A_per, rtol=0, atol=1e-8)


def _closure_run(Solver, Graph, cfg, third=False, **solver_kw):
    """test_superstep_capacity_flush_ingests_everything's replay: a chain
    with two factors per step (three with `third`), long closures among
    them."""
    n = 30
    g = chain_graph(n, y_noise=0.05, seed=11)
    if Graph is not None:              # the same graph in the JAX package
        h = Graph()
        for i in range(n):
            h.add_node(g.state[i], init=g.init[i])
        for f in range(g.nfactors):
            a, b = (int(v) for v in g.fnodes[f])
            if b >= 0:
                h.add_factor_xyt(a, b, g.fz[f], g.fW[f])
            else:
                h.add_factor_xytpos(a, g.fz[f], g.fW[f])
        g = h
    s = Solver(cfg, **solver_kw)
    s.solve(g)
    rng = np.random.default_rng(5)
    for _ in range(12):
        a = int(rng.integers(0, n - 10))
        b = int(rng.integers(a + 5, n))
        z = np_xyt_inv_mul(g.init[a], g.init[b]) + np.array([0.02, -0.01,
                                                             0.005])
        g.add_factor_xyt(a, b, z, W_ODO)
        c = int(rng.integers(0, n - 1))
        g.add_factor_xyt(c, c + 1, np_xyt_inv_mul(g.init[c], g.init[c + 1]),
                         W_ODO)
        if third:
            d = int(rng.integers(0, 5))
            g.add_factor_xyt(d, n - 1 - d, np_xyt_inv_mul(
                g.init[d], g.init[n - 1 - d]) + 0.01, W_ODO)
        s.update(g)
    s.flush(g)
    return s, g


@pytest.mark.parametrize("variant", ["buckets16-32", "overflow", "growth"])
def test_superstep_capacity_flush_ingests_everything(variant):
    """A superstep flushed for capacity dispatches a buffer whose span
    predates the caller's pending step; the ingestion markers track the
    buffered span, so union-overflow fallbacks ingest every factor.  The
    final chi2 is within 0.02 of a per-step run's and of the JAX
    package's for the same config, with the same counters.  The JAX
    test's buckets (16, 32) hold every union of this 30-node chain; the
    "overflow" variant adds a third factor per step (a capacity flush every
    second step at kfac = 8) and caps unions at 24 nodes (overflows).  The
    "growth" variant starts at a factor capacity the replay outgrows, so
    that a capacity growth flushes the buffered superstep."""
    third = variant == "overflow"
    kw = dict(SUP, panel_nodes=32, nthreshold=10**9, log_chi2=False,
              superstep_size=4, superstep_buckets=(16, 24) if third
              else (16, 32), policy_lag=1, policy_poll=1)
    if third:
        kw["new_factor_capacity"] = 4
    if variant == "growth":
        kw.update(factor_capacity=48, new_factor_capacity=4)
    s, g = _closure_run(IncrementalSolver, None, SolverConfig(**kw),
                        third=third, device="cpu")
    c = s.counters
    if third:
        assert c["sup_overflow"] > 0 and c["superstep"] > 0
        assert c["superstep"] + c["sup_overflow"] == 6     # 2 steps each
    if variant == "growth":
        assert [r["factor_capacity"] for r in s.growths] == [96]
    nx = int(np.sum(g.ftype[:g.nfactors] == FACTOR_XYT))
    assert s.ds.n_xyt == nx
    assert s.ds.n_pos == g.nfactors - nx
    assert s.ds.nnodes == g.nnodes

    s2, _ = _closure_run(IncrementalSolver, None, SolverConfig(
        **{**SUP, "panel_nodes": 32, "nthreshold": 10**9,
           "log_chi2": False}), third=third, device="cpu")
    assert abs(s.chi2() - s2.chi2()) < 0.02, (s.chi2(), s2.chi2())

    sj, _ = _closure_run(JSolver, JGraph, JConfig(**kw), third=third)
    assert sj.cfg.factor_capacity == s.cfg.factor_capacity
    for k, v in sj.counters.items():
        assert s.counters[k] == v, k
    assert abs(s.chi2() - sj.chi2()) < 0.02, (s.chi2(), sj.chi2())
