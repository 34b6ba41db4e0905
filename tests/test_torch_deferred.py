"""The port's lagged batch-fallback policy (policy_lag > 0), per step and in
supersteps, on the CPU in float64, against the JAX package and against the
synchronous policy.

With a lag, which pending entry the policy reads depends on which stats
have reached the host: the newest ready one, else the oldest due one.  On
the CPU the port's stats are always ready; the JAX package's depend on its
asynchronous dispatch.  Four repeated JAX runs of the bench-like config
below gave the same final chi2 to the last bit (spread 0), and the port's
equals it to rounding, but another timing may make the JAX package read an
older entry, which moves a batch epoch by a superstep or two.  Moving the
decisions that way (policy_lag 0 to 4 at this config, on the port) moves
the final chi2 by up to 8.1e-4, so the band is 2e-3, still 25x inside the
JAX package's own 0.05 at 3500 poses (tests/test_incremental.py:664).  The last test is the per-step
test_giant_closure_spike_recovers (tests/test_incremental.py:857)."""

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
from aprilsam_tpu_torch.geometry import np_xyt_mul
from aprilsam_tpu_torch.graph import FactorGraph
from aprilsam_tpu_torch.replay import Replay as TReplay
from aprilsam_tpu_torch.solver import (BatchSolver, IncrementalSolver,
                                       SolverConfig)

from test_torch_incremental import W_ODO
from test_torch_windowed import _superstep_replay

torch.set_num_threads(1)

SMALL = dict(node_capacity=512, factor_capacity=2048, row_block_capacity=64,
             panel_nodes=16, wallclock_gate=False)
BENCH_LIKE = dict(SMALL, superstep_size=32, policy_lag=3, policy_poll=2,
                  log_chi2=False, superstep_buckets=(64, 128, 256, 384, 640,
                                                     1024))
BAND = 2e-3


def test_lagged_superstep_final_chi2_matches_jax():
    rep_j = JReplay(j_manhattan(300, seed=0), JConfig(**BENCH_LIKE),
                    deferred=True)
    rep_j.run()
    rep_t = TReplay(t_manhattan(300, seed=0), SolverConfig(**BENCH_LIKE),
                    deferred=True, device="cpu")
    rep_t.run()
    c = rep_t.solver.counters
    assert c["superstep"] == 10 and c["batch"] > 1
    assert c["superstep"] == rep_j.solver.counters["superstep"]
    assert rep_t.solver.chi2_history().shape == (1,)   # log_chi2 off
    final_j, final_t = rep_j.solver.chi2(), rep_t.solver.chi2()
    assert abs(final_t - final_j) < BAND, (final_t, final_j)


def test_sweep_cadence_chi2_parity():
    """sweep_every_supersteps=2 (frontal-only supersteps between sweeps)
    converges to the every-superstep optimum (final chi2 within 0.5, the
    JAX test's band, tests/test_incremental.py:840) and to the JAX
    package's for the same config."""
    n = 160
    base = dict(SMALL, nthreshold=60, superstep_size=8, policy_lag=2,
                log_chi2=False)
    chi2s = {}
    for mode, k in (("every", 1), ("half", 2)):
        s, _ = _superstep_replay(n, SolverConfig(**base,
                                                 sweep_every_supersteps=k),
                                 seed=11, device="cpu")
        chi2s[mode] = s.chi2()
        if k > 1:
            assert s.counters["sup_nosweep"] > 0, s.counters
    assert abs(chi2s["every"] - chi2s["half"]) < 0.5, chi2s
    sj, _ = _superstep_replay(n, JConfig(**base, sweep_every_supersteps=2),
                              seed=11, Solver=JSolver, Graph=JGraph)
    assert abs(chi2s["half"] - sj.chi2()) < 0.5, (chi2s, sj.chi2())


def _per_step(**kw):
    rep = TReplay(t_manhattan(300, seed=0),
                  SolverConfig(**{**SMALL, "panel_nodes": 32, **kw}),
                  deferred=kw.get("policy_lag", 0) > 0, device="cpu")
    return rep, rep.run()


def test_deferred_per_step_without_fallbacks_equals_synchronous():
    """policy_lag=2, superstep_size=1: with nthreshold out of reach no
    policy decision fires, so the lag changes nothing: the final states
    equal the synchronous run's within 1e-9, and finish() backfills every
    step's chi2 from the metric ring."""
    rep_s, res_s = _per_step(nthreshold=10**9)
    rep_d, res_d = _per_step(nthreshold=10**9, policy_lag=2)
    assert rep_d.solver.counters == rep_s.solver.counters
    assert rep_s.solver.counters["batch"] == 1
    np.testing.assert_allclose(rep_d.solver.ds.state[:300].numpy(),
                               rep_s.solver.ds.state[:300].numpy(),
                               rtol=0, atol=1e-9)
    assert not any(math.isnan(r.chi2) for r in res_d)
    np.testing.assert_allclose([r.chi2 for r in res_d],
                               [r.chi2 for r in res_s], rtol=1e-9,
                               atol=1e-20)


def test_deferred_per_step_fires_batch_epochs():
    """With nthreshold low the lagged policy fires batch epochs, a few
    steps after the synchronous one would; both end at the same optimum
    (within 0.5 (1 + chi2), the JAX test's band for lagged decisions,
    tests/test_incremental.py:504)."""
    rep_s, _ = _per_step(nthreshold=30)
    rep_d, _ = _per_step(nthreshold=30, policy_lag=2)
    assert rep_d.solver.counters["batch"] > 2
    cs, cd = rep_s.solver.chi2(), rep_d.solver.chi2()
    assert np.isfinite(cd)
    assert abs(cd - cs) < 0.5 * (1.0 + cs), (cd, cs)


@pytest.mark.parametrize("mode", ["per-step", "superstep"])
def test_deferred_wallclock_gate_fires(mode):
    """The batch_time/3 gate (aprilsam.c:557-559) works when the policy
    lags: per-step time is the dispatch-to-dispatch interval, so a tiny
    recorded batch time makes the gate force an epoch, and without the
    gate none fires."""
    kw = dict(SMALL, nthreshold=10**9, policy_lag=2)
    if mode == "superstep":
        kw["superstep_size"] = 4

    def epochs(gate):
        rep = TReplay(t_manhattan(60, seed=3),
                      SolverConfig(**{**kw, "wallclock_gate": gate}),
                      deferred=True, device="cpu")
        rep.step()                             # the first pose: a batch
        rep.solver.batch_time_ms = 1e-6        # every step is "too slow"
        rep.run()
        return rep.solver._batch_serial

    assert epochs(True) > 1
    assert epochs(False) == 1


def test_giant_closure_spike_recovers():
    """tests/test_incremental.py:857 on the port: a loop closure across a
    chain of accumulated drift spikes chi2 once; the relinearizing batch
    epochs bring the final chi2 back near the batch-only optimum."""
    n = 260
    rng = np.random.default_rng(4)
    zs = np.zeros((n - 1, 3))
    zs[:, 0] = 1.0
    zs[:, 2] = 0.01 + 0.002 * rng.standard_normal(n - 1)   # turning bias
    init = np.zeros((n, 3))
    for i in range(1, n):
        init[i] = np_xyt_mul(init[i - 1], zs[i - 1])
    cfg = SolverConfig(**{**SMALL, "panel_nodes": 32, "nthreshold": 40,
                          "log_chi2": False})

    def chain(upto):
        g = FactorGraph()
        g.add_node(init[0], init=init[0])
        g.add_factor_xytpos(0, init[0], np.diag([1e4, 1e4, 1e3]))
        for i in range(1, upto):
            g.add_node(init[i], init=init[i])
            g.add_factor_xyt(i - 1, i, zs[i - 1], W_ODO)
        return g

    s = IncrementalSolver(cfg, device="cpu")
    g = chain(1)
    s.solve(g)
    for i in range(1, n):
        g.add_node(init[i], init=init[i])
        g.add_factor_xyt(i - 1, i, zs[i - 1], W_ODO)
        if i == n - 1:
            g.add_factor_xyt(0, i, [1.0, 0.0, 0.0], W_ODO)   # the closure
        s.update(g)
    s.flush(g)
    final = s.chi2()

    g2 = chain(n)
    g2.add_factor_xyt(0, n - 1, [1.0, 0.0, 0.0], W_ODO)
    b = BatchSolver(cfg, device="cpu")
    for _ in range(6):            # iterate batches to the nonlinear optimum
        info_b = b.solve(g2)
        b.sync_states(g2)
    assert np.isfinite(final)
    assert final < 10.0 * max(info_b.chi2, 1.0) + 50.0, (final, info_b.chi2)
