"""The port's device batch epochs (dense and panel) against the JAX
package's and against the port's host epoch, on the CPU in float64.

Tolerances.  The three epochs solve the same normal equations with
different factorizations (dense LAPACK, panel-by-panel, the native
up-looking one), so they agree to rounding amplified by the system's
conditioning, not bit for bit.  Port and JAX package run the same epoch
with different summation orders: R within 1e-8, y and states within 1e-9,
chi2 within 1e-9 relative (manhattan_world(200)).  Against the host epoch
the JAX package's own tolerances hold (tests/test_batch.py:135-143: same
ordering, R and y within 1e-7, states within 1e-8), except its absolute
1e-6 on chi2: on manhattan_world(700), at chi2 ~2900, rounding alone moves
the JAX package's own dense epoch 9.5e-7 from the host one, so chi2 is
held to 1e-9 relative.  Replays are held per step to 1e-6 relative, the
bar of the port's other replay tests.
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aprilsam_tpu.datasets import manhattan_world as j_manhattan
from aprilsam_tpu.replay import Replay as JReplay
from aprilsam_tpu.solver import BatchSolver as JBatchSolver
from aprilsam_tpu.solver import SolverConfig as JConfig
from aprilsam_tpu.solver.batch import run_batch_epoch as j_run_batch_epoch
from aprilsam_tpu.solver.ingest import ingest_graph as j_ingest
from aprilsam_tpu.solver.state import init_device_state as j_init

from aprilsam_tpu_torch.datasets import manhattan_world as t_manhattan
from aprilsam_tpu_torch.geometry import np_xyt_inv_mul, np_xyt_mul
from aprilsam_tpu_torch.graph import FactorGraph
from aprilsam_tpu_torch.replay import Replay as TReplay
from aprilsam_tpu_torch.solver import (BatchSolver, IncrementalSolver,
                                       SolverConfig)
from aprilsam_tpu_torch.solver import panel_epoch as PE
from aprilsam_tpu_torch.solver.batch import run_batch_epoch
from aprilsam_tpu_torch.solver.host_batch import host_batch_epoch
from aprilsam_tpu_torch.solver.incremental import SeedSpec
from aprilsam_tpu_torch.solver.ingest import ingest_graph
from aprilsam_tpu_torch.solver.state import init_device_state
from aprilsam_tpu_torch.utils import GraphCache

torch.set_num_threads(1)

SMALL = dict(node_capacity=512, factor_capacity=2048, row_block_capacity=64,
             panel_nodes=32, wallclock_gate=False)
PANEL700 = dict(node_capacity=1024, factor_capacity=2048,
                row_block_capacity=96, panel_nodes=128)
W_ODO = np.diag([100.0, 100.0, (180.0 / np.pi) ** 2])
# the epochs' dispatches on the CPU (always eager)
EAGER = GraphCache(torch.device("cpu"))


def _tables(g):
    nf = g.nfactors
    return g.ftype[:nf], g.fnodes[:nf]


def port_state(cfg, g):
    return ingest_graph(init_device_state(cfg, "cpu"), g, cfg, 0, 0)


def jax_state(cfg, g):
    return j_ingest(j_init(cfg), g, cfg, 0, 0)


RING = np.array([3.0, 2.0, 1.0])


# ------------------------------------------------------------ dense epoch

@pytest.fixture(scope="module")
def graph200():
    return t_manhattan(200, seed=0), j_manhattan(200, seed=0)


@pytest.mark.parametrize("log_mode", [0, 1, 2])
@pytest.mark.parametrize("gn_iters", [1, 2])
def test_dense_epoch_matches_jax(graph200, gn_iters, log_mode):
    """run_batch_epoch with batch_backend="device" on manhattan_world(200)
    at node_capacity 512, from a metric ring that already holds three
    entries (log_mode 1 overwrites the newest, 2 leaves the ring alone)."""
    g_t, g_j = graph200
    kw = dict(SMALL, batch_backend="device", gn_iters=gn_iters)
    cfg_t, cfg_j = SolverConfig(**kw), JConfig(**kw)
    ds_t = port_state(cfg_t, g_t)
    ds_t.chi2_log[:3] = torch.from_numpy(RING)
    ds_t.log_ptr = 3
    ds_j = jax_state(cfg_j, g_j)
    ds_j = ds_j._replace(chi2_log=ds_j.chi2_log.at[:3].set(RING),
                         log_ptr=jnp.int32(3))

    ds_t, sym_t, info_t, backend = run_batch_epoch(
        ds_t, cfg_t, g_t.nnodes, *_tables(g_t), log_mode=log_mode,
        graphs=EAGER)
    ds_j, sym_j, info_j = j_run_batch_epoch(
        ds_j, cfg_j, g_j.nnodes, *_tables(g_j), log_mode=log_mode)
    assert backend == "dense"
    np.testing.assert_array_equal(sym_t.order, np.asarray(sym_j.order))
    assert info_t.spd and info_j.spd
    if log_mode < 2:
        assert abs(info_t.chi2 - info_j.chi2) <= 1e-9 * abs(info_j.chi2)
    for name in ("R_idx", "R_nnz", "pos", "order"):
        np.testing.assert_array_equal(getattr(ds_t, name).numpy(),
                                      np.asarray(getattr(ds_j, name)), name)
    for name, tol in (("R_blocks", 1e-8), ("y", 1e-9), ("state", 1e-9),
                      ("l_point", 1e-9), ("delta_X", 1e-9)):
        np.testing.assert_allclose(getattr(ds_t, name).numpy(),
                                   np.asarray(getattr(ds_j, name)),
                                   rtol=0, atol=tol, err_msg=name)
    assert ds_t.log_ptr == int(ds_j.log_ptr)
    np.testing.assert_allclose(ds_t.chi2_log[:ds_t.log_ptr].numpy(),
                               np.asarray(ds_j.chi2_log[:ds_t.log_ptr]),
                               rtol=1e-9)


# ------------------------------------------------------------ panel epoch

@pytest.fixture(scope="module")
def epochs700():
    """The panel epoch of both packages and the port's host epoch on
    manhattan_world(700), as the JAX package's
    test_panel_epoch_matches_host_epoch runs them on an M3500 prefix."""
    g_t, g_j = t_manhattan(700, seed=0), j_manhattan(700, seed=0)
    cfg_t = SolverConfig(**PANEL700, batch_backend="panel")
    cfg_j = JConfig(**PANEL700, batch_backend="panel")
    panel = run_batch_epoch(port_state(cfg_t, g_t), cfg_t, g_t.nnodes,
                            *_tables(g_t), graphs=EAGER)
    jax = j_run_batch_epoch(jax_state(cfg_j, g_j), cfg_j, g_j.nnodes,
                            *_tables(g_j))
    nf = g_t.nfactors
    host = host_batch_epoch(port_state(cfg_t, g_t), cfg_t, g_t.nnodes,
                            *_tables(g_t), g_t.fz[:nf], g_t.fW[:nf],
                            graphs=EAGER)
    return panel, jax, host


def test_panel_epoch_matches_host_epoch(epochs700):
    (ds_p, sym_p, info_p, backend), _jax, (ds_h, sym_h, info_h) = epochs700
    assert backend == "panel"
    np.testing.assert_array_equal(sym_p.order, sym_h.order)
    assert info_p.spd and info_h.spd
    assert abs(info_p.chi2 - info_h.chi2) < 1e-9 * abs(info_h.chi2)
    np.testing.assert_allclose(ds_p.R_blocks.numpy(), ds_h.R_blocks.numpy(),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(ds_p.y.numpy(), ds_h.y.numpy(), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(ds_p.state[:700].numpy(),
                               ds_h.state[:700].numpy(), rtol=0, atol=1e-8)


def test_panel_epoch_matches_jax(epochs700):
    (ds_p, sym_p, info_p, _b), (ds_j, sym_j, info_j), _host = epochs700
    np.testing.assert_array_equal(sym_p.order, np.asarray(sym_j.order))
    assert bool(info_j.spd) and info_p.spd
    assert abs(info_p.chi2 - info_j.chi2) < 1e-9 * abs(info_j.chi2)
    for name in ("R_idx", "R_nnz", "pos", "order"):
        np.testing.assert_array_equal(getattr(ds_p, name).numpy(),
                                      np.asarray(getattr(ds_j, name)), name)
    for name, tol in (("R_blocks", 1e-7), ("y", 1e-8), ("state", 1e-8),
                      ("delta_X", 1e-8)):
        np.testing.assert_allclose(getattr(ds_p, name).numpy(),
                                   np.asarray(getattr(ds_j, name)),
                                   rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(ds_p.chi2_log[:1].numpy(),
                               np.asarray(ds_j.chi2_log[:1]), rtol=1e-9)


def _tight_caps(calls, grades_that_fit):
    orig = PE.panel_caps

    def caps(npanb, panel, grade=0):
        calls.append(grade)
        if grade in grades_that_fit:
            return orig(npanb, panel, grade=grade)
        return 8, 8, 1, 64, 64          # absurdly tight: everything overflows
    return caps


@pytest.mark.parametrize("fits,backend", [((1,), "panel"), ((), "dense")])
def test_panel_caps_grade_escalation(monkeypatch, fits, backend):
    """A plan that overflows the grade-0 caps retries at grade 1; one that
    overflows both falls back to the dense epoch where it fits."""
    calls = []
    monkeypatch.setattr(PE, "panel_caps", _tight_caps(calls, fits))
    g = t_manhattan(300, seed=1)
    cfg = SolverConfig(**PANEL700, batch_backend="panel")
    _ds, _sym, info, ran = run_batch_epoch(port_state(cfg, g), cfg,
                                           g.nnodes, *_tables(g),
                                           graphs=EAGER)
    assert calls == [0, 1]
    assert ran == backend
    assert info.spd and np.isfinite(info.chi2)


def test_panel_fallback_error_takes_the_host_epoch(monkeypatch):
    """No panel plan at either grade, and a graph whose dense epoch would
    exceed 3 * node_bucket = 16384 rows: IncrementalSolver runs the host
    epoch, as the JAX package does, and counts it as one."""
    calls = []
    monkeypatch.setattr(PE, "panel_caps", _tight_caps(calls, ()))
    g = t_manhattan(4100, seed=0)
    cfg = SolverConfig(node_capacity=8192, factor_capacity=16384,
                       batch_backend="panel", wallclock_gate=False)
    s = IncrementalSolver(cfg, device="cpu")
    info = s.solve(g)
    assert calls == [0, 1]
    assert s.counters["epoch_host"] == 1
    assert s.counters["epoch_panel"] == s.counters["epoch_dense"] == 0
    assert info.spd
    s.sync_states(g)
    assert abs(info.chi2 - g.chi2()) < 1e-9 * g.chi2()


@pytest.mark.parametrize("backend", ["device", "panel"])
def test_singular_graph_is_not_spd_and_stays_finite(backend):
    """tikhonov 0 and a node without a factor: the epoch's factor is NaN,
    spd is False in both packages, and the NaN guard keeps every state
    finite and equal to the JAX package's."""
    n = 60
    g_t, g_j = t_manhattan(n, seed=2), j_manhattan(n, seed=2)
    for g in (g_t, g_j):
        g.add_node([1.0, 2.0, 0.3], init=[1.0, 2.0, 0.3])
    kw = dict(SMALL, batch_backend=backend, tikhonov=0.0)
    s_t = BatchSolver(SolverConfig(**kw), device="cpu")
    s_j = JBatchSolver(JConfig(**kw))
    info_t, info_j = s_t.solve(g_t), s_j.solve(g_j)
    assert info_t.spd is False and bool(info_j.spd) is False
    st_t = s_t.ds.state[:n + 1].numpy()
    st_j = np.asarray(s_j.ds.state[:n + 1])
    assert np.all(np.isfinite(st_t))
    np.testing.assert_allclose(st_t, st_j, rtol=0, atol=1e-8)


# ------------------------------------------------------- per-step replays

@pytest.mark.parametrize("backend", ["device", "panel"])
def test_replay_with_device_epochs_matches_jax(backend):
    """Per-step Replay of manhattan_world(150) at nthreshold 30 with every
    batch epoch on the device backend: per-step chi2 within 1e-6
    relative, the path census equal, and the epochs counted by backend."""
    n = 150
    kw = dict(SMALL, batch_backend=backend, nthreshold=30)
    rep_j = JReplay(j_manhattan(n, seed=0), JConfig(**kw))
    res_j = rep_j.run()
    rep_t = TReplay(t_manhattan(n, seed=0), SolverConfig(**kw),
                    device="cpu")
    res_t = rep_t.run()
    paths_j = [r.path for r in res_j]
    assert [r.path for r in res_t] == paths_j
    assert Counter(paths_j)["batch"] >= 3
    c = rep_t.solver.counters
    assert c["batch"] == rep_j.solver.counters["batch"]
    ran = "epoch_panel" if backend == "panel" else "epoch_dense"
    assert c[ran] == c["batch"] and c["epoch_host"] == 0
    h_j, h_t = rep_j.solver.chi2_history(), rep_t.solver.chi2_history()
    np.testing.assert_allclose(h_t, h_j, rtol=1e-6, atol=1e-20)


# ------------------------------------------- plan overflow on the device

def chain_graph(n, y_noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    g = FactorGraph()
    for i in range(n):
        p = [float(i), y_noise * rng.standard_normal(), 0.0]
        g.add_node(p, init=p)
    g.add_factor_xytpos(0, [0, 0, 0], np.diag([1e4, 1e4, 1e3]))
    for i in range(n - 1):
        g.add_factor_xyt(i, i + 1, np_xyt_inv_mul(g.init[i], g.init[i + 1]),
                         W_ODO)
    return g


@pytest.mark.parametrize("backend", ["device", "panel"])
def test_plan_overflow_fallback_ingests_new_factors(backend):
    """A step beyond new_factor_capacity falls back to a device batch
    epoch after ingesting its nodes, factors and seed; later steps still
    see them (the JAX package's test, backend "device")."""
    n = 30
    g = chain_graph(n, y_noise=0.05, seed=7)
    cfg = SolverConfig(**dict(SMALL, nthreshold=10**9,
                              batch_backend=backend))
    s = IncrementalSolver(cfg, device="cpu")
    s.solve(g)
    z = np.array([1.0, 0.0, 0.0])
    seeded = np_xyt_mul(s.ds.state[n - 1].numpy(), z)
    g.add_node(seeded, init=seeded)
    g.add_factor_xyt(n - 1, n, z, W_ODO)
    rng = np.random.default_rng(11)
    for a in rng.choice(n - 2, size=18, replace=False):
        zc = np_xyt_inv_mul(g.init[a], g.init[n]) + np.array([0.05, -0.02,
                                                               0.01])
        g.add_factor_xyt(int(a), n, zc, W_ODO)
    info = s.update(g, seeds=[SeedSpec(src=n - 1, dst=n, z=z, invert=False)])
    assert s.last_path == "batch"
    ran = "epoch_panel" if backend == "panel" else "epoch_dense"
    assert s.counters[ran] == 2 and s.counters["epoch_host"] == 0
    s.sync_states(g)
    assert abs(info.chi2 - g.chi2()) < 1e-6 * (1.0 + abs(g.chi2()))
    assert abs(s.chi2() - g.chi2()) < 1e-6 * (1.0 + abs(g.chi2()))

    seeded2 = np_xyt_mul(s.ds.state[n].numpy(), z)
    g.add_node(seeded2, init=seeded2)
    g.add_factor_xyt(n, n + 1, z, W_ODO)
    s.update(g, seeds=[SeedSpec(src=n, dst=n + 1, z=z, invert=False)])
    s.flush(g)
    s.sync_states(g)
    assert abs(s.chi2() - g.chi2()) < 1e-6 * (1.0 + abs(g.chi2()))


def test_lagged_device_epoch_is_lazy():
    """With policy_lag > 0 the device epochs return BatchInfo with 0-d
    tensors and make no read of the device."""
    g = t_manhattan(100, seed=0)
    cfg = SolverConfig(**dict(SMALL, batch_backend="panel", policy_lag=2))
    ds = port_state(cfg, g)
    _ds, _sym, info, _b = run_batch_epoch(ds, cfg, g.nnodes, *_tables(g),
                                          lazy=True, graphs=EAGER)
    assert isinstance(info.chi2, torch.Tensor) and info.chi2.dim() == 0
    assert isinstance(info.spd, torch.Tensor) and bool(info.spd)
    s = IncrementalSolver(dataclasses.replace(cfg), device="cpu")
    assert isinstance(s.solve(g).chi2, float)
