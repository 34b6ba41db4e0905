"""Counterparts in the port of the JAX package's robustness tests
(tests/test_robustness.py:25, :47, :67, :78, :87) and of its mid-replay
priors test (tests/test_mixed_factors.py:33), each against the JAX package's
result on the same input, on the CPU in float64.  These are the edges the
padded dispatch rewrites: a front past the largest bucket, an update with
nothing new, an indefinite update, xytpos priors through the frontal QR,
and the R rows outgrowing their capacity with updates after it (also
against golden/rowgrowth40_jax.txt, which the card is held to).

Tolerances: chi2 relative 1e-9 (the two packages pad the frontal QR to the
same bucket and differ by rounding), paths exactly; a step's returned chi2
relative 1e-6, because the JAX package reads it back through a float32
stats vector."""

import numpy as np
import pytest
import torch

from aprilsam_tpu.datasets import manhattan_world as j_manhattan
from aprilsam_tpu.graph import FactorGraph as JGraph
from aprilsam_tpu.io import load_g2o_text as j_load_g2o
from aprilsam_tpu.solver import IncrementalSolver as JSolver
from aprilsam_tpu.solver import SolverConfig as JConfig
from aprilsam_tpu.solver.incremental import SeedSpec as JSeed

from aprilsam_tpu_torch.datasets import manhattan_world as t_manhattan
from aprilsam_tpu_torch.datasets import row_growth_world
from aprilsam_tpu_torch.graph import FACTOR_XYTPOS, FactorGraph
from aprilsam_tpu_torch.io import load_g2o_text as t_load_g2o
from aprilsam_tpu_torch.replay import replay_by_max_endpoint
from aprilsam_tpu_torch.replay_checks import (CHI2_REL, ROW_GROWTH_CASES,
                                              ROW_GROWTH_FIRST,
                                              ROW_GROWTH_GRAPH,
                                              hold_row_growth,
                                              read_row_growth_golden,
                                              row_growth_config,
                                              run_row_growth)
from aprilsam_tpu_torch.solver import IncrementalSolver, SolverConfig
from aprilsam_tpu_torch.solver.incremental import SeedSpec

torch.set_num_threads(1)

W = np.diag([100.0, 100.0, 400.0])
PACKAGES = {
    "torch": (lambda **kw: IncrementalSolver(_cfg(SolverConfig, **kw),
                                             device="cpu"),
              FactorGraph, SeedSpec),
    "jax": (lambda **kw: JSolver(_cfg(JConfig, **kw)), JGraph, JSeed),
}


def _cfg(Config, **kw):
    kw.setdefault("node_capacity", 256)
    kw.setdefault("factor_capacity", 1024)
    kw.setdefault("panel_nodes", 32)
    kw.setdefault("wallclock_gate", False)
    return Config(**kw)


def _chain(Graph, n):
    g = Graph()
    for i in range(n):
        g.add_node([i, 0, 0], init=[i, 0, 0])
    g.add_factor_xytpos(0, [0, 0, 0], np.diag([1e4, 1e4, 1e3]))
    for i in range(n - 1):
        g.add_factor_xyt(i, i + 1, [1, 0, 0], W)
    return g


def _both(run):
    out = {name: run(*pkg) for name, pkg in PACKAGES.items()}
    return out["torch"], out["jax"]


def test_frontal_bucket_overflow_falls_back_to_batch():
    """An affected set larger than the biggest frontal bucket escalates to
    a batch epoch (tests/test_robustness.py:47)."""
    def run(Solver, Graph, _Seed):
        n = 60
        g = _chain(Graph, n)
        s = Solver(nthreshold=10**9, frontal_buckets=(4,))
        s.solve(g)
        # long-range closure -> affected path > 4
        g.add_factor_xyt(0, n - 1, [n - 1.0, 0.5, 0], W)
        info = s.update(g)
        return s.last_path, float(info.chi2), s.chi2(), \
            np.asarray(s.ds.state[:n])

    t, j = _both(run)
    assert t[0] == j[0] == "batch"
    assert np.isfinite(t[2])
    np.testing.assert_allclose(t[1:3], j[1:3], rtol=1e-9)
    np.testing.assert_allclose(t[3], j[3], rtol=1e-9, atol=1e-9)


def test_update_without_new_factors_is_noop():
    """tests/test_robustness.py:67: the guard path returns the current
    chi2 and changes nothing."""
    def run(Solver, Graph, _Seed):
        g = Graph()
        g.add_node([0, 0, 0], init=[0, 0, 0])
        g.add_factor_xytpos(0, [0, 0, 0], np.diag([1e4, 1e4, 1e3]))
        s = Solver()
        s.solve(g)
        c1 = s.chi2()
        info = s.update(g)
        return c1, float(info.chi2), s.last_path

    t, j = _both(run)
    assert abs(t[1] - t[0]) < 1e-12
    np.testing.assert_allclose(t[:2], j[:2], rtol=1e-9, atol=1e-12)
    assert t[2] == j[2]


def test_g2o_loader_rejects_garbage(tmp_path):
    """tests/test_robustness.py:78: an unknown record raises ValueError in
    both loaders."""
    p = tmp_path / "bad.g2o"
    p.write_text("VERTEX2 0 0 0 0\nBOGUS 1 2 3\n")
    for load in (t_load_g2o, j_load_g2o):
        with pytest.raises(ValueError):
            load(str(p))


def test_spd_failure_triggers_batch():
    """tests/test_robustness.py:87: an indefinite update flips the SPD
    check, the policy runs a batch epoch, and the solver goes on."""
    def run(Solver, Graph, Seed):
        n = 10
        g = _chain(Graph, n)
        s = Solver(nthreshold=10**9)
        s.solve(g)
        # a NEGATIVE-definite "information" matrix makes the update
        # indefinite
        g.add_factor_xyt(0, n - 1, [n - 1.0, 0, 0], -10 * W)
        first = float(s.update(g).chi2)
        path = s.last_path
        g.add_node([n, 0, 0], init=[n, 0, 0])
        g.add_factor_xyt(n - 1, n, [1, 0, 0], W)
        s.update(g, seeds=[Seed(n - 1, n, np.array([1.0, 0, 0]), False)])
        return path, first, s.chi2(), s.last_path

    t, j = _both(run)
    assert t[0] == j[0] == "batch"
    assert np.isfinite(t[2])
    np.testing.assert_allclose(t[1:3], j[1:3], rtol=1e-9)
    assert t[3] == j[3]


@pytest.mark.parametrize("n,seed,geopin_every,closure_prob",
                         [(60, 9, 10, 0.2), (300, 0, 25, 0.3)],
                         ids=["60-poses", "300-poses-geopin25"])
def test_priors_arriving_mid_replay(n, seed, geopin_every, closure_prob):
    """tests/test_mixed_factors.py:33: xytpos priors keep arriving through
    the incremental replay (through the frontal QR); per-step chi2 and
    paths against the JAX package, and the optimized trajectory closer to
    the truth than the dead-reckoned one.  The 300-pose case is the
    card's mixed-factor replay (replay_checks.py) at a tenth of its
    length."""
    def run(Solver, Graph, Seed, make):
        g = make(n, seed=seed, geopin_every=geopin_every,
                 closure_prob=closure_prob)
        s = Solver(node_capacity=512, factor_capacity=2048,
                   row_block_capacity=64, nthreshold=100)
        res = replay_by_max_endpoint(g, s, Graph, Seed)
        priors = int(np.sum(g.ftype[:g.nfactors] == FACTOR_XYTPOS))
        return (np.asarray([r["chi2"] for r in res]),
                [r["path"] for r in res], np.asarray(s.ds.state[:n]),
                g.truth[:n], g.init[:n], priors, s.chi2_history())

    t = run(*PACKAGES["torch"], t_manhattan)
    j = run(*PACKAGES["jax"], j_manhattan)
    assert t[5] == j[5] >= 5
    assert t[1] == j[1] and "fast" in t[1]
    np.testing.assert_allclose(t[0], j[0], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(t[6], j[6], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-9, atol=1e-9)
    err_opt = np.linalg.norm(t[2][:, :2] - t[3][:, :2])
    err_init = np.linalg.norm(t[4][:, :2] - t[3][:, :2])
    assert err_opt < err_init * 0.8


@pytest.mark.parametrize("case", list(ROW_GROWTH_CASES))
def test_row_capacity_growth_then_updates(case):
    """tests/test_robustness.py:25 carried on past the growth: the rows of
    row_growth_world outgrow row_block_capacity=8 (8 -> 12 -> 18) while it
    is solved at 20 poses and updated pose by pose to 40, per step and in
    supersteps of 4.  The port runs it through replay_checks.
    run_row_growth, as the card does; against the JAX package step by
    step: the row capacity and the path exactly, the returned chi2 within
    relative 1e-6 (read through float32 stats), the metric ring within
    1e-9 and the final states within 1e-9."""
    run = run_row_growth(case, "cpu")
    s = JSolver(row_growth_config(case, JConfig))
    res = replay_by_max_endpoint(row_growth_world(**ROW_GROWTH_GRAPH,
                                                  graph=JGraph), s, JGraph,
                                 JSeed, first=ROW_GROWTH_FIRST)
    t = run["records"]
    assert [r["rows"] for r in t] == [r["rows"] for r in res]
    assert t[0]["rows"] == 8 and t[-1]["rows"] == 18
    assert [r["path"] for r in t] == [r["path"] for r in res]
    np.testing.assert_allclose([r["chi2"] for r in t],
                               [r["chi2"] for r in res], rtol=1e-6,
                               equal_nan=True)
    np.testing.assert_allclose(run["ring"], s.chi2_history(), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(run["final_chi2"], s.chi2(), rtol=1e-9)
    np.testing.assert_allclose(run["states"], np.asarray(s.ds.state[:40]),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", list(ROW_GROWTH_CASES))
def test_row_growth_golden_holds_the_cpu_port(case):
    """The hold the card's row-growth runs face (replay_checks.
    hold_row_growth against golden/rowgrowth40_jax.txt) passes the port
    on the CPU, and fails a run whose final chi2 is twice its bound off,
    or whose rows grew one step late."""
    gold = read_row_growth_golden()[case]
    run = run_row_growth(case, "cpu")
    held = hold_row_growth(run["records"], run["ring"], run["final_chi2"],
                           gold)
    assert held["bad"] == [] and held["final_rel"] <= CHI2_REL
    assert len(held["growth_steps"]) == 2
    off = hold_row_growth(run["records"], run["ring"],
                          run["final_chi2"] * (1 + 2 * CHI2_REL), gold)
    assert len(off["bad"]) == 1 and "final chi2" in off["bad"][0]
    late = [dict(r) for r in run["records"]]
    k = next(i for i, r in enumerate(late) if r["rows"] != late[0]["rows"])
    late[k]["rows"] = late[k - 1]["rows"]
    assert "row capacities" in hold_row_growth(
        late, run["ring"], run["final_chi2"], gold)["bad"][0]
