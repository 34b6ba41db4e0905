"""The plain reference: its chi2 convention, and optima that are known."""

from __future__ import annotations

import numpy as np

from benchmark.gen.manhattan import _between, generate
from benchmark.reference import posegraph as P

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
