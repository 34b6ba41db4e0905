"""Counterparts in the port of the JAX package's robustness tests
(tests/test_robustness.py:47, :67, :78, :87) and of its mid-replay priors
test (tests/test_mixed_factors.py:33), each against the JAX package's
result on the same input, on the CPU in float64.  These are the edges the
padded dispatch rewrites: a front past the largest bucket, an update with
nothing new, an indefinite update, xytpos priors through the frontal QR.

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
from aprilsam_tpu_torch.graph import FACTOR_XYTPOS, FactorGraph
from aprilsam_tpu_torch.io import load_g2o_text as t_load_g2o
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


def test_priors_arriving_mid_replay():
    """tests/test_mixed_factors.py:33: xytpos priors keep arriving through
    the incremental replay (through the frontal QR); per-step chi2 and
    paths against the JAX package, and the optimized trajectory closer to
    the truth than the dead-reckoned one."""
    n = 60

    def run(Solver, Graph, Seed, make):
        g = make(n, seed=9, geopin_every=10, closure_prob=0.2)
        s = Solver(node_capacity=512, factor_capacity=2048,
                   row_block_capacity=64, nthreshold=100)
        live = Graph()
        by_max = [[] for _ in range(n)]
        for f in range(g.nfactors):
            a, b = g.fnodes[f]
            by_max[int(max(a, b))].append(f)
        chi2, paths = [], []
        for k in range(n):
            live.add_node(g.init[k], init=g.init[k])
            seeds = []
            for f in by_max[k]:
                a, b = (int(v) for v in g.fnodes[f])
                if b >= 0:
                    if abs(a - b) == 1:
                        seeds.append(Seed(a, b, g.fz[f], False) if a < b
                                     else Seed(b, a, g.fz[f], True))
                    live.add_factor_xyt(a, b, g.fz[f], g.fW[f])
                else:
                    live.add_factor_xytpos(a, g.fz[f], g.fW[f])
            info = s.solve(live) if k == 0 else s.update(live, seeds=seeds)
            chi2.append(float(info.chi2))
            paths.append(s.last_path)
        priors = int(np.sum(g.ftype[:g.nfactors] == FACTOR_XYTPOS))
        return (np.asarray(chi2), paths, np.asarray(s.ds.state[:n]),
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
