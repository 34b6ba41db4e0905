"""The port's ahead-of-time surface against the JAX package, on the CPU in
float64: default_signatures and the panel epoch's shape ladder tuple for
tuple; the padded dispatch path (every step, superstep and bundle slot
padded to its signature, dead slots writing to the dump rows) against the
JAX package's per-step chi2, states and census; precompile leaving the
solver state bit-identical; capacity growth dropping the cached graphs.

Tolerances: both packages pad the frontal QR to the same bucket, so they
differ by the rounding of two LAPACK builds: chi2 entries and states are
held to relative 1e-9 (values at rounding level of zero, ~1e-28, to an
absolute 1e-20), the census and the paths exactly; precompile's state to
the bit."""

import math

import numpy as np
import pytest
import torch

from aprilsam_tpu.datasets import manhattan_world as j_manhattan
from aprilsam_tpu.graph import FactorGraph as JGraph
from aprilsam_tpu.replay import Replay as JReplay
from aprilsam_tpu.solver import IncrementalSolver as JSolver
from aprilsam_tpu.solver import SolverConfig as JConfig
from aprilsam_tpu.solver import panel_epoch as j_panel

from aprilsam_tpu_torch.datasets import manhattan_world as t_manhattan
from aprilsam_tpu_torch.geometry import np_xyt_inv_mul
from aprilsam_tpu_torch.graph import FactorGraph
from aprilsam_tpu_torch.replay import Replay as TReplay
from aprilsam_tpu_torch.solver import IncrementalSolver, SolverConfig
from aprilsam_tpu_torch.solver import panel_epoch as t_panel
from aprilsam_tpu_torch.solver.state import DUMP, state_to_numpy

from test_torch_bundles import _jax_stats_ready

torch.set_num_threads(1)

SMALL = dict(node_capacity=512, factor_capacity=2048, row_block_capacity=64,
             panel_nodes=32, wallclock_gate=False)
CHI2_ATOL = 1e-20

# the configurations whose signatures are compared: the per-step default,
# bundles of 8 (mixed), the JAX bench's S = 96 throughput config
# (bench.py:121-166) and the large-N windowed one (bench_large_inc.py)
SIG_CONFIGS = {
    "per-step": dict(),
    "bundled8": dict(bundle_size=8, policy_lag=8),
    "bundled8-legacy": dict(bundle_size=8, policy_lag=8, mixed_bundles=False),
    "bench-S96": dict(superstep_size=96, policy_lag=3, policy_poll=2,
                      superstep_buckets=(64, 128, 256, 384, 640, 1024),
                      log_chi2=False),
    "windowed16": dict(superstep_size=64, policy_lag=3, panel_nodes=256,
                       sweep_window_panels=16, sweep_full_every=16),
    "odd-capacity": dict(node_capacity=3000, panel_nodes=128),
}


@pytest.mark.parametrize("nnodes", [None, 300, 3500])
@pytest.mark.parametrize("name", list(SIG_CONFIGS))
def test_default_signatures_match_jax(name, nnodes):
    kw = dict(wallclock_gate=False, **SIG_CONFIGS[name])
    port = IncrementalSolver(SolverConfig(**kw), device="cpu")
    jax_sigs = JSolver(JConfig(**kw)).default_signatures(nnodes)
    assert port.default_signatures(nnodes) == jax_sigs
    assert len(jax_sigs) > 0


def test_panel_ladder_matches_jax():
    for v in range(0, 300):
        for lo in (1, 2, 3, 16, 64):
            assert t_panel._bucket_pow2(v, lo) == j_panel._bucket_pow2(v, lo)
    for npanb in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        for panel in (16, 128, 256):
            for grade in (0, 1):
                caps = t_panel.panel_caps(npanb, panel, grade)
                assert caps == j_panel.panel_caps(npanb, panel, grade)
                assert t_panel.seg_ladder(caps[0], caps[1]) == \
                    j_panel.seg_ladder(caps[0], caps[1])
    for mc in (1, 63, 64, 65, 255, 256, 257, 1024, 2048):
        for nu in (1, 255, 256, 512, 1536):
            assert t_panel.seg_ladder(mc, nu) == j_panel.seg_ladder(mc, nu)


# ---------------------------------------------------------- padded path

def _census(res):
    return {p: sum(r.path == p for r in res) for p in ("fast", "full",
                                                        "batch")}


PADDED = {
    # mode: (graph size, config, deferred)
    "per-step": (160, dict(), False),
    "S96": (400, dict(superstep_size=96, policy_lag=0), True),
    "bundled8": (160, dict(bundle_size=8, policy_lag=8), True),
}


@pytest.mark.parametrize("mode", list(PADDED))
def test_padded_path_matches_jax(mode):
    n, kw, deferred = PADDED[mode]
    kw = dict(SMALL, **kw)
    rep_j = JReplay(j_manhattan(n, seed=1), JConfig(**kw), deferred=deferred)
    if mode == "bundled8":
        _jax_stats_ready(rep_j.solver)
    res_j = rep_j.run()
    rep_t = TReplay(t_manhattan(n, seed=1), SolverConfig(**kw),
                    deferred=deferred, device="cpu")
    res_t = rep_t.run()
    sj, st = rep_j.solver, rep_t.solver
    assert [r.path for r in res_t] == [r.path for r in res_j]
    assert _census(res_t) == _census(res_j)
    for key in ("batch", "superstep", "sup_overflow"):
        assert st.counters[key] == sj.counters[key], key
    h_j, h_t = sj.chi2_history(), st.chi2_history()
    assert h_t.shape == h_j.shape and len(h_t) > 0
    np.testing.assert_allclose(h_t, h_j, rtol=1e-9, atol=CHI2_ATOL)
    if not deferred:
        np.testing.assert_allclose([r.chi2 for r in res_t],
                                   [r.chi2 for r in res_j], rtol=1e-6,
                                   atol=CHI2_ATOL)
    np.testing.assert_allclose(st.ds.state[:n].numpy(),
                               np.asarray(sj.ds.state[:n]), rtol=1e-9,
                               atol=1e-9)


def test_padded_tutorial_matches_jax():
    """The tutorial dogleg through both packages, step by step: chi2 and
    states of every step."""
    W = np.diag([1 / 0.1 ** 2, 1 / 0.1 ** 2, 1 / np.radians(1.0) ** 2])
    out = {}
    for pkg, Solver, Config, Graph in (
            ("torch", IncrementalSolver, SolverConfig, FactorGraph),
            ("jax", JSolver, JConfig, JGraph)):
        s = (Solver(Config(**SMALL), device="cpu") if pkg == "torch"
             else Solver(Config(**SMALL)))
        g = Graph()
        g.add_node([0, 0, 0], init=[0, 0, 0])
        g.add_factor_xytpos(0, [0, 0, 0], np.diag([1e4, 1e4, 1e3]))
        chi2 = [s.solve(g).chi2]
        for i in range(1, 6):
            g.add_node([i, 0, 0], init=[i, 0, 0])
            g.add_factor_xyt(i - 1, i, np_xyt_inv_mul(g.init[i - 1],
                                                      g.init[i]), W)
            if i == 5:
                g.add_factor_xyt(0, 5, np_xyt_inv_mul(
                    np.zeros(3), np.array([5.0, 1, 0])), W)
            chi2.append(s.update(g).chi2)
        out[pkg] = (np.asarray(chi2), np.asarray(s.ds.state[:6]),
                    s.last_path)
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=1e-6,
                               atol=1e-9)
    assert abs(out["torch"][0][-1] - 7.805041) < 1e-4
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=1e-9,
                               atol=1e-9)
    assert out["torch"][2] == out["jax"][2]


# ------------------------------------------------------------ precompile

PRECOMPILE = {
    "per-step": dict(frontal_buckets=(16, 64, 128, 256)),
    "bundled8": dict(bundle_size=8, policy_lag=8),
    "coalesced8": dict(bundle_size=8, policy_lag=8,
                       coalesce_full_solves=True, mixed_bundles=False,
                       frontal_buckets=(16, 64, 128, 256)),
    "windowed": dict(superstep_size=16, policy_lag=2, sweep_window_panels=4,
                     sweep_full_every=4, sweep_every_supersteps=2),
}


def _snapshot(s):
    st = state_to_numpy(s.ds)
    return st, dict(s.counters), (s.steps_done, s.factor_num, s.node_num,
                                  s.ds.nnodes, s.ds.n_xyt, s.ds.n_pos,
                                  s.ds.log_ptr, len(s._pending),
                                  len(s._queue), len(s._sbuf))


@pytest.mark.parametrize("name", list(PRECOMPILE))
def test_precompile_leaves_the_state_bit_identical(name):
    """precompile mid-replay: every signature's dead dispatch runs, the
    solver state (and the host counts) stay as they were to the bit, and
    the rest of the replay is the one without precompile, to the bit."""
    n, k = 140, 90
    cfg = SolverConfig(**SMALL, **PRECOMPILE[name])
    runs = []
    for precompile in (False, True):
        rep = TReplay(t_manhattan(n, seed=2), cfg, deferred=cfg.policy_lag
                      > 0 or cfg.superstep_size > 1, device="cpu")
        for _ in range(k):
            rep.step()
        s = rep.solver
        if precompile:
            before = _snapshot(s)
            count = s.precompile(nnodes=n)
            assert count == len(s.default_signatures(n)) + 1
            after = _snapshot(s)
            for field, a in before[0].items():
                assert np.array_equal(a, after[0][field],
                                      equal_nan=True), field
            assert before[1:] == after[1:]
            assert s._last_dispatch_t is None
        for _ in range(n - k):
            rep.step()
        rep.finish()
        runs.append((state_to_numpy(s.ds), s.chi2_history()))
    for field, a in runs[0][0].items():
        assert np.array_equal(a, runs[1][0][field], equal_nan=True), field
    assert np.array_equal(runs[0][1], runs[1][1], equal_nan=True)


def test_dead_dispatches_write_only_dump_rows():
    """precompile's dead dispatches write the dump rows past each table's
    capacity, which the fields (views) never show."""
    s = IncrementalSolver(SolverConfig(**SMALL, bundle_size=8, policy_lag=8),
                          device="cpu")
    bases = {name: getattr(s.ds, name)._base.clone() for name in DUMP}
    s.precompile(nnodes=100)
    for name in DUMP:
        base = getattr(s.ds, name)._base
        view = getattr(s.ds, name)
        assert base.shape[0] == view.shape[0] + 1
        assert torch.equal(base[:-1], bases[name][:-1]), name


def test_capacity_growth_bumps_the_cache_generation():
    """Node/factor growth and row growth reallocate the state: the graph
    cache's generation advances with each, so no graph captured on the
    freed tensors is replayed (on the card; on the CPU nothing is
    captured)."""
    rep = TReplay(t_manhattan(150, seed=0), SolverConfig(**dict(
        SMALL, node_capacity=64, factor_capacity=128)), device="cpu")
    s = rep.solver
    assert not s.graphs.enabled and s.graphs.generation == 0
    rep.run()
    assert s.cfg.node_capacity > 64
    assert s.graphs.generation >= 1
    assert math.isfinite(s.chi2())

    # row growth: dense closures overflow a tiny row_block_capacity
    # (tests/test_robustness.py:test_row_capacity_growth_recovers)
    rng = np.random.default_rng(0)
    g = FactorGraph()
    n = 40
    W = np.diag([100.0, 100.0, 400.0])
    for i in range(n):
        g.add_node([i, 0, 0], init=[i, 0, 0])
    g.add_factor_xytpos(0, [0, 0, 0], np.diag([1e4, 1e4, 1e3]))
    for i in range(n - 1):
        g.add_factor_xyt(i, i + 1, [1, 0, 0], W)
    for _ in range(80):
        a, b = sorted(rng.choice(n, 2, replace=False))
        g.add_factor_xyt(int(a), int(b), [float(b - a), 0, 0], W)
    s = IncrementalSolver(SolverConfig(**dict(SMALL, row_block_capacity=8,
                                              nthreshold=10**9)),
                          device="cpu")
    assert math.isfinite(s.solve(g).chi2)
    assert s.cfg.row_block_capacity > 8
    assert s.graphs.generation >= 1


@pytest.mark.parametrize("ladder", ["dense", "panel", "expand"])
def test_epoch_ladders_leave_the_state_bit_identical(ladder):
    """precompile_device_batch, precompile_panel_epoch and
    precompile_expand run their ladders' dead epochs on a live solver's
    state (where the card captures them) and leave it as it was; later
    epochs run as without them."""
    from aprilsam_tpu_torch.solver.batch import precompile_device_batch
    from aprilsam_tpu_torch.solver.host_batch import precompile_expand
    from aprilsam_tpu_torch.solver.panel_epoch import precompile_panel_epoch

    backend, fn = {"dense": ("device", precompile_device_batch),
                   "panel": ("panel", precompile_panel_epoch),
                   "expand": ("auto", precompile_expand)}[ladder]
    cfg = SolverConfig(**dict(SMALL, panel_nodes=16, batch_backend=backend,
                              nthreshold=30))
    n = 150
    runs = []
    for warm in (False, True):
        rep = TReplay(t_manhattan(n, seed=4), cfg, device="cpu")
        for _ in range(80):
            rep.step()
        s = rep.solver
        if warm:
            before = _snapshot(s)
            assert fn(s.ds, s.cfg, n, s.graphs) >= 1
            after = _snapshot(s)
            for field, a in before[0].items():
                assert np.array_equal(a, after[0][field],
                                      equal_nan=True), field
            assert before[1:] == after[1:]
        rep.run()
        runs.append((state_to_numpy(s.ds), s.chi2_history(),
                     dict(s.counters)))
    assert runs[0][2] == runs[1][2] and runs[0][2]["batch"] > 1
    for field, a in runs[0][0].items():
        assert np.array_equal(a, runs[1][0][field], equal_nan=True), field
    assert np.array_equal(runs[0][1], runs[1][1], equal_nan=True)


def test_big_bucket_signatures_complete_the_ladder():
    """replay_checks.big_bucket_signatures (what the card's mixed-factor
    phase precompiles beyond default_signatures): with them every frontal
    bucket has a full-path signature at every panel count of the
    trajectory, and none is one default_signatures already gives."""
    from aprilsam_tpu_torch.replay_checks import (MIXED_CONFIG,
                                                  big_bucket_signatures)

    s = IncrementalSolver(SolverConfig(**MIXED_CONFIG), device="cpu")
    sigs = s.default_signatures(3500)
    extra = big_bucket_signatures(s, 3500)
    assert extra and not set(extra) & set(sigs)
    full = [x for x in list(sigs) + extra if x[0] == "full"]
    npanbs = {x[3] for x in full}
    assert {(x[1], x[3]) for x in full} == {
        (b, n) for b in s.cfg.frontal_buckets for n in npanbs}
