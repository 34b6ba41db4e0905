"""Synthetic dataset generators (the port's own copy of
``aprilsam_tpu/datasets.py``; same seeds give the same graphs).

Manhattan-world pose-graph generator in the style of the M3500 benchmark
(Olson's Manhattan dataset): a trajectory on a grid with 90-degree turns,
odometry factors between consecutive poses, and loop-closure factors between
revisited nearby poses.  Used for the 100k-pose scaling configuration
(BASELINE.json configs 4-5) and for mixed pose+landmark graphs
(config 3: xytpos "landmark/geopin" factors sprinkled along the trajectory).
"""

from __future__ import annotations

import numpy as np

from .graph import FactorGraph
from .geometry import np_mod2pi, np_xyt_inv_mul, np_xyt_mul


def manhattan_world(
    n_poses: int,
    step_len: float = 1.0,
    block: int = 10,
    odom_sigma_xy: float = 0.02,
    odom_sigma_theta: float = np.radians(0.5),
    closure_prob: float = 0.3,
    closure_radius: float = 1.5,
    max_closures_per_pose: int = 2,
    geopin_every: int = 0,
    seed: int = 0,
) -> FactorGraph:
    """Generate a Manhattan-world trajectory graph.

    The robot walks `block` steps then turns +/-90 degrees, on an integer
    grid.  Odometry measurements are the true relative pose corrupted with
    Gaussian noise; loop closures connect the current pose to earlier poses
    within `closure_radius` (true relative pose + noise).  Node states/init
    are the dead-reckoned (noisy) trajectory — the standard SLAM starting
    point.  With geopin_every > 0, an absolute xytpos prior is added every
    that many poses (the mixed factor-type configuration).
    """
    rng = np.random.default_rng(seed)

    # --- ground-truth trajectory
    truth = np.zeros((n_poses, 3))
    heading = 0.0
    pos = np.zeros(2)
    for i in range(1, n_poses):
        if i % block == 0:
            heading += rng.choice([-1.0, 1.0]) * np.pi / 2
        pos = pos + step_len * np.array([np.cos(heading), np.sin(heading)])
        truth[i] = [pos[0], pos[1], heading]
    truth[:, 2] = np_mod2pi(truth[:, 2])

    # --- odometry measurements + dead-reckoned initialization
    W_odom = np.diag([1.0 / odom_sigma_xy**2, 1.0 / odom_sigma_xy**2,
                      1.0 / odom_sigma_theta**2])
    z_odom = np.zeros((n_poses - 1, 3))
    init = np.zeros_like(truth)
    for i in range(n_poses - 1):
        z = np_xyt_inv_mul(truth[i], truth[i + 1])
        z[:2] += odom_sigma_xy * rng.standard_normal(2)
        z[2] = np_mod2pi(z[2] + odom_sigma_theta * rng.standard_normal())
        z_odom[i] = z
        init[i + 1] = np_xyt_mul(init[i], z)
    init[:, 2] = np_mod2pi(init[:, 2])

    g = FactorGraph()
    for i in range(n_poses):
        g.add_node(init[i], init=init[i], truth=truth[i])

    W_geo = np.diag([1e4, 1e4, 1e3])
    if geopin_every <= 0:
        g.add_factor_xytpos(0, truth[0], W_geo)

    # factors must be appendable pose-by-pose: emit in max-endpoint order
    grid: dict = {}

    def cell(p):
        return (int(np.floor(p[0] / closure_radius)),
                int(np.floor(p[1] / closure_radius)))

    W_cl = np.diag([1.0 / 0.05**2, 1.0 / 0.05**2, 1.0 / np.radians(1.0) ** 2])
    for i in range(n_poses):
        if i > 0:
            g.add_factor_xyt(i - 1, i, z_odom[i - 1], W_odom)
        if geopin_every > 0 and i % geopin_every == 0:
            z = truth[i] + np.concatenate(
                [0.02 * rng.standard_normal(2), [0.005 * rng.standard_normal()]])
            g.add_factor_xytpos(i, z, W_geo)
        # loop closures to earlier poses in nearby cells
        if i > block and rng.random() < closure_prob:
            cx, cy = cell(truth[i, :2])
            cands = []
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    cands.extend(grid.get((cx + dx, cy + dy), ()))
            cands = [j for j in cands if j < i - block
                     and np.linalg.norm(truth[j, :2] - truth[i, :2]) < closure_radius]
            rng.shuffle(cands)
            for j in cands[:max_closures_per_pose]:
                z = np_xyt_inv_mul(truth[j], truth[i])
                z[:2] += 0.05 * rng.standard_normal(2)
                z[2] = np_mod2pi(z[2] + np.radians(1.0) * rng.standard_normal())
                g.add_factor_xyt(j, i, z, W_cl)
        grid.setdefault(cell(truth[i, :2]), []).append(i)

    return g


def row_growth_world(n_poses: int = 40, closures: int = 80, seed: int = 0,
                     graph=FactorGraph):
    """A chain of `n_poses` poses along x with a prior at node 0, an
    odometry factor between consecutive poses and `closures` random
    closures between any two poses: dense enough that the R rows of its
    factor outgrow a small ``row_block_capacity``.  Measurements and
    initial values carry noise drawn from `seed`.  `graph` is the class
    the graph is built in (any with the port's FactorGraph methods), so
    that another package's solver can be given the same input."""
    rng = np.random.default_rng(seed)
    W = np.diag([100.0, 100.0, 400.0])
    sigma = np.array([0.05, 0.05, 0.02])
    truth = np.zeros((n_poses, 3))
    truth[:, 0] = np.arange(n_poses)
    init = truth + 0.1 * rng.standard_normal((n_poses, 3))
    init[:, 2] = np_mod2pi(init[:, 2])
    g = graph()
    for i in range(n_poses):
        g.add_node(init[i], init=init[i], truth=truth[i])
    g.add_factor_xytpos(0, np.zeros(3), np.diag([1e4, 1e4, 1e3]))
    for i in range(n_poses - 1):
        g.add_factor_xyt(i, i + 1, np.array([1.0, 0.0, 0.0])
                         + sigma * rng.standard_normal(3), W)
    for _ in range(closures):
        a, b = sorted(int(v) for v in rng.choice(n_poses, 2, replace=False))
        g.add_factor_xyt(a, b, np.array([float(b - a), 0.0, 0.0])
                         + sigma * rng.standard_normal(3), W)
    return g
