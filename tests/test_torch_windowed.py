"""The port's windowed sweep (sweep_window_panels > 0) against the JAX
package and against the full sweep, on the CPU in float64.

Tolerances: at policy_lag=0 the port takes the JAX package's trajectory
(ring entries within relative 1e-9, states within 1e-9, counters equal; the
port inverts each window's triangles in one tri_inv call where the JAX
package solves each panel in its scan, a difference of rounding only).
Against the full sweep, the bands are the JAX package's own tests': exact
(1e-6) on the last window's nodes, 5e-2 elsewhere, and final chi2 within
0.5 (tests/test_incremental.py:792, :822)."""

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
from aprilsam_tpu_torch.graph import FactorGraph
from aprilsam_tpu_torch.replay import Replay as TReplay
from aprilsam_tpu_torch.solver import IncrementalSolver, SolverConfig

from test_torch_incremental import W_ODO

torch.set_num_threads(1)

SMALL = dict(node_capacity=512, factor_capacity=2048, row_block_capacity=64,
             panel_nodes=16, wallclock_gate=False)
CHI2_ATOL = 1e-20
WINDOWED = dict(SMALL, superstep_size=8, sweep_window_panels=4,
                sweep_full_every=3)


@pytest.fixture(scope="module")
def jax_windowed():
    rep = JReplay(j_manhattan(300, seed=0), JConfig(**WINDOWED),
                  deferred=True)
    rep.run()
    return rep


def test_windowed_replay_matches_jax(jax_windowed):
    sj = jax_windowed.solver
    rep = TReplay(t_manhattan(300, seed=0), SolverConfig(**WINDOWED),
                  deferred=True, device="cpu")
    rep.run()
    st = rep.solver
    assert sj.counters["sweep_win"] == 20
    for k, v in sj.counters.items():
        assert st.counters[k] == v, k
    # the last superstep's window left the graph stale: flush() swept it
    assert st.counters["sweep_flush"] == 1
    np.testing.assert_allclose(st.chi2_history(), sj.chi2_history(),
                               rtol=1e-9, atol=CHI2_ATOL)
    np.testing.assert_allclose(st.ds.state[:300].numpy(),
                               np.asarray(sj.ds.state[:300]), rtol=0,
                               atol=1e-9)


def _superstep_replay(n, cfg, seed, Solver=IncrementalSolver,
                      Graph=FactorGraph, **solver_kw):
    """tests/test_incremental.py:_superstep_replay: a noisy chain with
    periodic loop closures through the superstep path."""
    rng = np.random.default_rng(seed)
    g = Graph()
    s = Solver(cfg, **solver_kw)
    p0 = [0.0, 0.0, 0.0]
    g.add_node(p0, init=p0)
    g.add_factor_xytpos(0, p0, np.diag([1e4, 1e4, 1e3]))
    s.solve(g)
    init = np.zeros((n, 3))
    init[:, 0] = np.arange(n)
    init[:, 1] = 0.05 * rng.standard_normal(n)
    for i in range(1, n):
        g.add_node(init[i], init=init[i])
        z = np_xyt_inv_mul(init[i - 1], init[i]) \
            + 0.01 * rng.standard_normal(3)
        g.add_factor_xyt(i - 1, i, z, W_ODO)
        if i % 17 == 0 and i > 20:
            a = int(rng.integers(0, i - 10))
            z2 = np_xyt_inv_mul(init[a], init[i]) \
                + 0.01 * rng.standard_normal(3)
            g.add_factor_xyt(a, i, z2, W_ODO)
        s.update(g)
    s.flush(g)
    return s, g


def test_windowed_sweep_matches_full_on_members():
    """Windowed and full sweeps agree exactly on the nodes of the last
    windows (fronts are ancestor-closed, R rows reference only etree
    ancestors), and elsewhere within the pruning approximation."""
    n = 120
    base = dict(SMALL, nthreshold=10**9, superstep_size=8, policy_lag=2,
                log_chi2=False, sweep_full_every=0)
    states = {}
    for mode, pw in (("full", 0), ("win", 8)):
        s, _ = _superstep_replay(n, SolverConfig(**base,
                                                 sweep_window_panels=pw),
                                 seed=7, device="cpu")
        states[mode] = s.ds.state[:n].numpy().copy()
        if mode == "win":
            assert s.counters["sweep_win"] > 0, s.counters
    d = np.abs(states["full"] - states["win"])
    assert d[-16:].max() < 1e-6, d[-16:].max()
    assert d.max() < 5e-2, d.max()


def test_windowed_sweep_chi2_parity():
    """A windowed replay lands at the full-sweep replay's optimum (final
    chi2 within 0.5), and at the JAX package's windowed one."""
    n = 160
    base = dict(SMALL, nthreshold=60, superstep_size=8, policy_lag=2,
                log_chi2=False, sweep_full_every=4)
    chi2s = {}
    for mode, pw in (("full", 0), ("win", 6)):
        s, _ = _superstep_replay(n, SolverConfig(**base,
                                                 sweep_window_panels=pw),
                                 seed=11, device="cpu")
        chi2s[mode] = s.chi2()
        assert np.isfinite(chi2s[mode])
    assert abs(chi2s["full"] - chi2s["win"]) < 0.5, chi2s
    sj, _ = _superstep_replay(n, JConfig(**base, sweep_window_panels=6),
                              seed=11, Solver=JSolver, Graph=JGraph)
    assert abs(chi2s["win"] - sj.chi2()) < 0.5, (chi2s, sj.chi2())
