"""The benchmark's pose-graph generator: a Manhattan world in the style of
the M3500 and City10000 data sets, made from a seed as numpy arrays.

A frozen copy of the port's ``datasets.manhattan_world`` (same trajectory,
odometry and closure geometry), with two changes, so that a seed changes
the measurements and not how much work a replay has:

  * the world (the true trajectory and which poses close loops) comes from
    the configuration's `world` seed, and only the noise of every
    measurement from the run's `seed`: as a data set is one world measured
    once; ``manhattan_world`` draws both from one seed, and a replay's
    epochs then moved from 29 to 72 between seeds;
  * the number of loop closures is a parameter, not a probability.

The closures are drawn from the candidate pool: for every pose i > block,
up to ``max_closures_per_pose`` earlier poses j < i - block within
``closure_radius`` of it (the generator's own rule), and then exactly
``closures`` of the pool.  Where a world revisits too little for that, the
candidates beyond each pose's cap fill the pool up.

Returns plain arrays, which the reference reads as they are and the driver
hands to the program:
  truth [n, 3], init [n, 3] (dead-reckoned), a [m], b [m] (a < b, the
  edges ordered by b, the odometry edge of b first), z [m, 3], W [m, 3, 3].
"""

from __future__ import annotations

import functools

import numpy as np

TWOPI = 2.0 * np.pi


def mod2pi(v):
    v = np.asarray(v, dtype=np.float64) + np.pi
    return (v - TWOPI * np.floor(v / TWOPI)) - np.pi


def _compose(a, b):
    """a (+) b for xyt poses (theta not wrapped)."""
    s, c = np.sin(a[2]), np.cos(a[2])
    return np.array([c * b[0] - s * b[1] + a[0], s * b[0] + c * b[1] + a[1],
                     a[2] + b[2]])


def _between(a, b):
    """a^-1 (+) b for xyt poses."""
    ca, sa = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    return np.array([ca * dx + sa * dy, -sa * dx + ca * dy, b[2] - a[2]])


@functools.lru_cache(maxsize=2)
def _world(poses: int, closures: int, world: int, step_len: float,
           block: int, closure_radius: float,
           max_closures_per_pose: int) -> tuple:
    """What a seed leaves alone: the true trajectory (read-only) and the
    chosen closures, as a tuple of (j, i).  Kept for the last two worlds
    asked for, since a run's passes share theirs (a 250 000-pose world
    takes some ten seconds)."""
    wrng = np.random.default_rng(world)
    truth = np.zeros((poses, 3))
    heading = 0.0
    pos = np.zeros(2)
    for i in range(1, poses):
        if i % block == 0:
            heading += wrng.choice([-1.0, 1.0]) * np.pi / 2
        pos = pos + step_len * np.array([np.cos(heading), np.sin(heading)])
        truth[i] = [pos[0], pos[1], heading]
    truth[:, 2] = mod2pi(truth[:, 2])

    # the candidate pool, pose by pose (the generator's grid of cells)
    grid: dict = {}
    pool, spare = [], []

    def cell(p):
        return (int(np.floor(p[0] / closure_radius)),
                int(np.floor(p[1] / closure_radius)))

    for i in range(poses):
        if i > block:
            cx, cy = cell(truth[i, :2])
            cands = []
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    cands.extend(grid.get((cx + dx, cy + dy), ()))
            cands = [j for j in cands if j < i - block and np.linalg.norm(
                truth[j, :2] - truth[i, :2]) < closure_radius]
            wrng.shuffle(cands)
            pool.extend((j, i) for j in cands[:max_closures_per_pose])
            spare.extend((j, i) for j in cands[max_closures_per_pose:])
        grid.setdefault(cell(truth[i, :2]), []).append(i)
    if len(pool) < closures:
        short = closures - len(pool)
        if len(spare) < short:
            raise ValueError(f"world {world}: {len(pool) + len(spare)} "
                             f"candidate closures, fewer than the "
                             f"{closures} asked for")
        fill = wrng.choice(len(spare), size=short, replace=False)
        pool = sorted(pool + [spare[k] for k in fill], key=lambda e: e[1])
    pick = np.sort(wrng.choice(len(pool), size=closures, replace=False))
    truth.setflags(write=False)
    return truth, tuple(pool[k] for k in pick)


def generate(poses: int, closures: int, world: int, seed: int,
             step_len: float = 1.0,
              block: int = 10, odom_sigma_xy: float = 0.02,
              odom_sigma_theta_deg: float = 0.5,
              closure_sigma_xy: float = 0.05,
              closure_sigma_theta_deg: float = 1.0,
              closure_radius: float = 1.5,
              max_closures_per_pose: int = 2) -> dict:
    """The graph of `poses` poses and poses - 1 + `closures` edges of the
    world `world` (a non-negative integer), measured with the noise of
    `seed` (one, or a sequence of them).  Raises ValueError when the world
    offers fewer candidate closures than asked for."""
    truth, chosen = _world(poses, closures, world, step_len, block,
                           closure_radius, max_closures_per_pose)
    rng = np.random.default_rng(seed)
    sig_th = np.radians(odom_sigma_theta_deg)

    z_odom = np.zeros((poses - 1, 3))
    init = np.zeros_like(truth)
    for i in range(poses - 1):
        z = _between(truth[i], truth[i + 1])
        z[:2] += odom_sigma_xy * rng.standard_normal(2)
        z[2] = mod2pi(z[2] + sig_th * rng.standard_normal())
        z_odom[i] = z
        init[i + 1] = _compose(init[i], z)
    init[:, 2] = mod2pi(init[:, 2])

    W_odom = np.diag([odom_sigma_xy ** -2, odom_sigma_xy ** -2,
                      sig_th ** -2])
    sig_cth = np.radians(closure_sigma_theta_deg)
    W_cl = np.diag([closure_sigma_xy ** -2, closure_sigma_xy ** -2,
                    sig_cth ** -2])
    m = poses - 1 + closures
    a = np.zeros(m, dtype=np.int64)
    b = np.zeros(m, dtype=np.int64)
    z = np.zeros((m, 3))
    W = np.zeros((m, 3, 3))
    e, c = 0, 0
    for i in range(1, poses):
        a[e], b[e], z[e], W[e] = i - 1, i, z_odom[i - 1], W_odom
        e += 1
        while c < closures and chosen[c][1] == i:
            j = chosen[c][0]
            zc = _between(truth[j], truth[i])
            zc[:2] += closure_sigma_xy * rng.standard_normal(2)
            zc[2] = mod2pi(zc[2] + sig_cth * rng.standard_normal())
            a[e], b[e], z[e], W[e] = j, i, zc, W_cl
            e += 1
            c += 1
    return {"truth": truth.copy(), "init": init, "a": a, "b": b, "z": z,
            "W": W}
