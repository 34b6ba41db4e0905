"""How far the port's and the JAX package's float64 keyframe-block solves
lie from each other and from the exact Gauss-Newton step, and what the
float32 solve's damping does to chi2: the evidence behind the bounds of
tests/test_torch_scaling.py and chip_smoke.py phase 16.

    JAX_PLATFORMS=cpu python tests/schur_rounding.py      # ~3 min

Prints, on the scaling bench's graph at 4000 poses in 16 blocks:
  * the largest xy and theta differences between the two packages after
    one and two Gauss-Newton iterations, with tikhonov 1e-4 (the solve's
    default) and 1e-2;
  * each package's first step against the whole system's float64
    Cholesky refined to the residual's float64 floor (long double
    residuals), and that unrefined Cholesky's own error;
  * the port with its Cholesky swapped for numpy's, against itself;
and at 20 000 poses in 64 blocks (bench_scaling.py's defaults) the port's
chi2 after two and four iterations in float64, float32, and float64 with
float32's damping (eq_jitter 1e-5).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import scipy.linalg as sl  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def xy_theta(a, b):
    dth = np.abs((a[:, 2] - b[:, 2] + np.pi) % (2 * np.pi) - np.pi)
    return float(np.max(np.abs(a[:, :2] - b[:, :2]))), float(np.max(dth))


def refined_first_step(g, S):
    """States after one exact Gauss-Newton step (tikhonov 1e-4 on every
    diagonal entry, as the decomposition adds it), and after the same
    step through one unrefined float64 Cholesky of the whole system."""
    n = g.nnodes
    p1 = S.partition_graph(g, 1)
    ids = p1.interiors[0]
    loc = S._local_states(p1, g.state[:n].astype(np.float64), np.float64)

    def t(x, dt=None):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt)

    A, B = S._assemble(torch.from_numpy(loc), t(p1.fa, torch.int64),
                       t(p1.fb, torch.int64), t(p1.fz), t(p1.fW),
                       t(p1.fvalid), t(p1.pn, torch.int64), t(p1.pz),
                       t(p1.pW))
    A = A[0, :3 * n, :3 * n].numpy().copy()
    b = B[0, :3 * n].numpy().copy()
    A[np.diag_indices(3 * n)] += 1e-4
    L = np.linalg.cholesky(A)
    x = sl.cho_solve((L, True), b)
    Al, bl, xl = (v.astype(np.longdouble) for v in (A, b, x))
    for _ in range(3):
        r = bl - Al @ xl
        xl = xl + sl.cho_solve((L, True), r.astype(np.float64))
    out = {}
    for name, dx in (("refined", np.asarray(xl, dtype=np.float64)),
                     ("one Cholesky", x)):
        st = np.zeros((n, 3))
        st[ids] = loc[0, :n] + dx.reshape(n, 3)
        out[name] = st
    return out


def main():
    from aprilsam_tpu.datasets import manhattan_world
    from aprilsam_tpu.parallel.dist import make_mesh
    from aprilsam_tpu.parallel.schur import partition_graph, schur_solve
    from aprilsam_tpu_torch.parallel import one_rank_group
    from aprilsam_tpu_torch.parallel import schur as S
    from aprilsam_tpu_torch.scaling import graph_chi2
    from aprilsam_tpu_torch.scaling_model import scaling_graph

    g = manhattan_world(4000, seed=0, closure_prob=0.04, block=25,
                        max_closures_per_pose=1)
    tg = scaling_graph(4000, 0.04)
    part, tpart = partition_graph(g, 16), S.partition_graph(tg, 16)
    with one_rank_group("cpu") as mesh:
        for tik in (1e-4, 1e-2):
            for gn in (1, 2):
                j = schur_solve(make_mesh(1), g, part, gn_iters=gn,
                                dtype=np.float64, tikhonov=tik)
                t = S.schur_solve(mesh, tg, tpart, gn_iters=gn,
                                  dtype=np.float64, tikhonov=tik)
                print(f"tikhonov {tik:g}, {gn} iterations: JAX - port "
                      "(xy, theta)", xy_theta(j, t), flush=True)
                if tik == 1e-4 and gn == 1:
                    first = (j, t)
        ref = refined_first_step(tg, S)
        for name, st in (("JAX", first[0]), ("port", first[1]),
                         ("one Cholesky", ref["one Cholesky"])):
            print(f"first step, {name} - refined (xy, theta)",
                  xy_theta(st, ref["refined"]), flush=True)
        saved = S.cholesky_nan
        S.cholesky_nan = lambda A: torch.from_numpy(
            np.linalg.cholesky(A.numpy()))
        try:
            tn = S.schur_solve(mesh, tg, tpart, gn_iters=1,
                               dtype=np.float64)
        finally:
            S.cholesky_nan = saved
        print("first step, port with numpy's Cholesky - port (xy, theta)",
              xy_theta(tn, first[1]), flush=True)

        g20 = scaling_graph(20000, 0.04)
        p20 = S.partition_graph(g20, 64)
        for gn in (2, 4):
            for name, dt, kw in (("float64", np.float64, {}),
                                 ("float32", np.float32, {}),
                                 ("float64, eq_jitter 1e-5", np.float64,
                                  {"eq_jitter": 1e-5})):
                st = S.schur_solve(mesh, g20, p20, gn_iters=gn, dtype=dt,
                                   **kw)
                print(f"20000 poses, {gn} iterations, {name}: chi2",
                      repr(graph_chi2(g20, st)), flush=True)


if __name__ == "__main__":
    main()
