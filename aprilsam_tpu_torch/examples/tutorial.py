"""Six-step walkthrough of the incremental API, the counterpart of the
reference tutorial (examples/aprilsam_tutorial.c) and of the JAX package's
examples/tutorial.py.

Builds the dogleg graph: a geopin prior on node 0, an odometry chain of six
poses at (i, 0, 0), then a loop closure claiming node 5 sits at (5, 1, 0).
Prints chi2 and the full state after every step; the final output matches
the reference (chi2 = 7.805041, y-ramp 0.16/0.32/0.50/0.67/0.84).

Run:  python -m aprilsam_tpu_torch.examples.tutorial [--device cpu]
"""

import argparse

import numpy as np

from aprilsam_tpu_torch import FactorGraph, SolverConfig
from aprilsam_tpu_torch.geometry import np_xyt_inv_mul
from aprilsam_tpu_torch.solver.incremental import IncrementalSolver

W_ODOM = np.diag([1 / 0.1**2, 1 / 0.1**2, 1 / np.radians(1.0) ** 2])
W_GEOPIN = np.diag([1e4, 1e4, 1e3])


def print_state(solver, g, step):
    print(f"\n==================== Step: {step} =======================")
    print(f"Chi squared error: {solver.chi2():f}")
    states = solver.ds.state[: g.nnodes].cpu().numpy()
    for i in range(g.nnodes):
        x, y, t = states[i]
        print(f"node_{i} = {{{x:.2f}, {y:.2f}, {t:.2f}}}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = SolverConfig(node_capacity=256, factor_capacity=1024,
                       row_block_capacity=48, panel_nodes=32)
    solver = IncrementalSolver(cfg, device=args.device)
    g = FactorGraph()

    # step 1: first node + geopin prior; the first update must be a batch
    # (the reference has the same constraint, aprilsam_tutorial.c:106)
    g.add_node([0, 0, 0], init=[0, 0, 0])
    g.add_factor_xytpos(0, [0, 0, 0], W_GEOPIN)
    solver.solve(g)
    print_state(solver, g, 1)

    # steps 2-5: odometry chain
    for i in range(1, 5):
        g.add_node([i, 0, 0], init=[i, 0, 0])
        z = np_xyt_inv_mul(g.init[i - 1], g.init[i])
        g.add_factor_xyt(i - 1, i, z, W_ODOM)
        solver.update(g)
        print_state(solver, g, i + 1)

    # step 6: last pose + a loop closure that believes node 5 is at (5,1,0)
    g.add_node([5, 0, 0], init=[5, 0, 0])
    z = np_xyt_inv_mul(g.init[4], g.init[5])
    g.add_factor_xyt(4, 5, z, W_ODOM)
    z2 = np_xyt_inv_mul(np.array([0.0, 0, 0]), np.array([5.0, 1, 0]))
    g.add_factor_xyt(0, 5, z2, W_ODOM)
    solver.update(g)
    print_state(solver, g, 6)


if __name__ == "__main__":
    main()
