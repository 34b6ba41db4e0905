"""The plain reference of a batch solve: whether the states a solve returns
are the optimum of the whole graph, judged by what makes them so and not
by solving it again.

Written from the problem's definition alone (posegraph.py's graph, edge
residual and chi2), in float64 numpy on the host; it reads the
generator's arrays and the configuration's prior, and nothing that the
program made.  The gradient of chi2 is assembled edge by edge: memory and
time linear in the edges, with no Hessian and no factorization, so a map
of 250 000 poses (750 000 unknowns) is judged in about a second, where
posegraph.optimum's dense normal equations would take some 4.5 TB.

The gradient, for an edge (a, b) with r = z - h(x_a, x_b) (posegraph's
residual) and chi2_e = 1/2 r^T W r: d chi2_e / dx = -(dh/dx)^T W r, with

  dh/dx_a = [[-c, -s,  h1],      dh/dx_b = [[ c, s, 0],
             [ s, -c, -h0],                 [-s, c, 0],
             [ 0,  0,  -1]]                 [ 0, 0, 1]]

(c, s the cosine and sine of theta_a, h0, h1 the first two parts of h);
for the prior, chi2_p = r^T W r with r = z - x_0: -2 W r.

The numbers (check.py: each the largest over the run's answers,
`ranks_disagree` and `nonfinite` counted), for an answer with finite
states x of the graph after its step k:

  chi2_rel        as posegraph's: whether the returned chi2 belongs to the
                  returned states;
  grad_rel        |grad chi2(x)| / |grad chi2(the dead-reckoned start)|,
                  2-norms: zero at the optimum, so a solve that stops
                  early, drops a block's contribution or loses a rank's
                  Schur term reads far above its rounding;
  truth_gap       (chi2(x) - chi2(the generator's true poses)) / the
                  latter: the true poses are a feasible point, so the
                  optimum lies at or below them (about -n / m for n poses
                  and m edges); a stationary point on a wrong branch, such
                  as a flipped wrap, reads above;
  ranks_disagree  1 where the ranks' digests of their states (the
                  answer's "digests", one a rank) differ: the deployment's
                  guarantee is that every rank holds the same map (an
                  exact comparison: limit 0);
  nonfinite       answers with a state or chi2 that is not finite.
"""

from __future__ import annotations

import numpy as np

from . import posegraph as P

NUMBERS = ("chi2_rel", "grad_rel", "truth_gap", "ranks_disagree",
           "nonfinite")


def gradient(x, a, b, z, W, prior) -> np.ndarray:
    """The gradient [n, 3] of chi2 at states x [n, 3]."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    pa, pb = x[a], x[b]
    c, s = np.cos(pa[:, 2]), np.sin(pa[:, 2])
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    h0, h1 = c * dx + s * dy, -s * dx + c * dy
    r = np.stack([z[:, 0] - h0, z[:, 1] - h1,
                  P.wrap(z[:, 2] - (pb[:, 2] - pa[:, 2]))], axis=1)
    e = np.einsum("fij,fj->fi", W, r)
    # -(dh/dx_a)^T e and -(dh/dx_b)^T e, row by row of the matrices above
    ga = -np.stack([-c * e[:, 0] + s * e[:, 1],
                    -s * e[:, 0] - c * e[:, 1],
                    h1 * e[:, 0] - h0 * e[:, 1] - e[:, 2]], axis=1)
    gb = -np.stack([c * e[:, 0] - s * e[:, 1],
                    s * e[:, 0] + c * e[:, 1],
                    e[:, 2]], axis=1)
    g = np.stack([np.bincount(a, ga[:, i], n) + np.bincount(b, gb[:, i], n)
                  for i in range(3)], axis=1)
    node = int(prior["node"])
    rp = np.asarray(prior["z"], dtype=np.float64) - x[node]
    rp[2] = P.wrap(rp[2])
    g[node] -= 2.0 * np.asarray(prior["W"], dtype=np.float64) @ rp
    return g


def numbers(graph: dict, prior: dict, ans: dict, x, device="cpu") -> dict:
    """This reference's numbers of one answer with finite states x (all on
    the host: `device` is not used)."""
    k = ans["step"]
    edges = P.edges_upto(graph, k)
    out = {}
    out["chi2_rel"], ref = P.chi2_rel(graph, prior, ans, x)
    start = np.linalg.norm(gradient(graph["init"][:k + 1], *edges, prior))
    out["grad_rel"] = float(np.linalg.norm(gradient(x, *edges, prior))
                            / start)
    truth = P.chi2(graph["truth"][:k + 1], *edges, prior)
    out["truth_gap"] = (ref - truth) / truth
    digests = ans.get("digests", ())
    out["ranks_disagree"] = int(len(set(digests)) > 1)
    return out
