"""The plain references: posegraph's chi2 convention and optima that are
known; stationary's gradient, its numbers at a dense optimum, and its
cost at 750 000 unknowns."""

from __future__ import annotations

import numpy as np

from benchmark.gen.manhattan import _between, generate
from benchmark.reference import posegraph as P
from benchmark.reference import stationary as S

PRIOR = {"node": 0, "z": [0.0, 0.0, 0.0],
         "W": np.diag([1e4, 1e4, 1e3]).tolist()}


def test_chi2_convention():
    """Half of r^T W r for an edge, all of it for the prior."""
    x = np.array([[0.5, 0.0, 0.0], [1.0, 0.0, 0.1]])
    a, b = np.array([0]), np.array([1])
    z = np.array([[1.0, 0.0, 0.0]])
    W = np.eye(3)[None] * 2.0
    # edge residual: z - (0.5, 0, 0.1) = (0.5, 0, -0.1)
    edge = 0.5 * 2.0 * (0.25 + 0.01)
    prior = 1e4 * 0.25
    assert abs(P.chi2(x, a, b, z, W, PRIOR) - (edge + prior)) < 1e-12


def test_noiseless_graph_optimum_is_truth():
    """Measurements without noise: the optimum is the true trajectory
    (chi2 0), reached from the dead-reckoned one."""
    g = generate(poses=120, closures=40, world=3, seed=5)
    a, b, _, W = P.edges_upto(g, 119)
    z = np.stack([_between(g["truth"][i], g["truth"][j])
                  for i, j in zip(a, b)])
    start = g["truth"] + np.random.default_rng(0).normal(0, 0.05,
                                                         g["truth"].shape)
    x, c, it = P.optimum(start, a, b, z, W, PRIOR)
    assert c < 1e-16
    d = x - g["truth"]
    d[:, 2] = P.wrap(d[:, 2])
    assert np.abs(d).max() < 1e-9


def test_optimum_is_stationary():
    """With noise: the optimum's chi2 rises for any small move of a
    pose, and matches a second start."""
    g = generate(poses=150, closures=60, world=3, seed=9)
    e = P.edges_upto(g, 149)
    x, c, _ = P.optimum(g["truth"], *e, PRIOR)
    rng = np.random.default_rng(1)
    for _ in range(5):
        y = x.copy()
        y[rng.integers(150)] += rng.normal(0, 1e-4, 3)
        assert P.chi2(y, *e, PRIOR) > c
    x2, c2, _ = P.optimum(g["init"], *e, PRIOR)
    assert abs(c2 - c) <= 1e-12 * c


def test_stationary_gradient_is_chi2s():
    """The gradient assembled edge by edge against central differences
    of posegraph's chi2, wraps and the prior included."""
    g = generate(poses=200, closures=80, world=3, seed=4)
    e = P.edges_upto(g, 199)
    x = g["init"] + np.random.default_rng(2).normal(0, 0.05, (200, 3))
    x[5, 2] = np.pi - 1e-3                    # an angle near the wrap
    grad = S.gradient(x, *e, PRIOR)
    h = 1e-6
    for i, j in [(0, 0), (0, 2), (5, 2), (77, 1), (199, 0), (120, 2)]:
        up, down = x.copy(), x.copy()
        up[i, j] += h
        down[i, j] -= h
        fd = (P.chi2(up, *e, PRIOR) - P.chi2(down, *e, PRIOR)) / (2 * h)
        assert abs(fd - grad[i, j]) <= 1e-5 * max(1.0, abs(fd)), (i, j)


def test_stationary_at_the_dense_optimum():
    """At posegraph's dense optimum of the test's batch cell (2000
    poses), the gradient is rounding and chi2 lies below the true
    poses'; at the true poses neither."""
    import benchmark.run as R
    from benchmark.tests.small import batch_spec

    spec = batch_spec()
    g = R.pass_graph(spec["config"], 3_200_000_001, 0)
    e = P.edges_upto(g, 1999)
    x, c, _ = P.optimum(g["truth"], *e, PRIOR)
    at_opt = S.numbers(g, PRIOR, {"step": 1999, "chi2": c}, x)
    assert at_opt["grad_rel"] <= 1e-10
    assert at_opt["truth_gap"] < 0
    assert at_opt["chi2_rel"] <= 1e-14
    at_truth = S.numbers(g, PRIOR, {"step": 1999, "chi2": c}, g["truth"])
    assert at_truth["grad_rel"] > 1e-4 and at_truth["truth_gap"] == 0.0


def test_stationary_scales_with_the_edges():
    """A map of 250 000 poses (750 000 unknowns) and 250 000 closures is
    judged in seconds: no Hessian, no solve."""
    import time

    rng = np.random.default_rng(0)
    n, m = 250_000, 250_000
    truth = np.cumsum(rng.normal(0, 1, (n, 3)), axis=0)
    a = np.concatenate([np.arange(n - 1), rng.integers(0, n - 20, m)])
    b = np.concatenate([np.arange(1, n), a[n - 1:] + rng.integers(10, 20,
                                                                  m)])
    z = rng.normal(0, 1, (len(a), 3))
    W = np.broadcast_to(np.diag([2500.0, 2500.0, 13131.0]), (len(a), 3, 3))
    g = {"truth": truth, "init": truth + rng.normal(0, 1, (n, 3)),
         "a": a, "b": b, "z": z, "W": W}
    t = time.perf_counter()
    got = S.numbers(g, PRIOR, {"step": n - 1, "chi2": 1.0}, truth)
    assert time.perf_counter() - t < 20
    assert all(np.isfinite(v) for v in got.values())
