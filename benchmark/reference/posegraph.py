"""The plain reference of the pose graph that a replay solves.

Written from the problem's definition alone; it reads the generator's
arrays and the configuration's prior, and nothing that the program made:

  * the graph after pose k: poses 0..k, every edge (a, b) with b <= k, and
    the prior on pose 0 that the replay adds at its first step;
  * an edge's residual r = z - h(x_a, x_b), h = (R(theta_a)^T (p_b - p_a),
    theta_b - theta_a), its angle wrapped to [-pi, pi); the prior's
    r = z - x_0, wrapped alike;
  * chi2 = 1/2 sum over edges r^T W r + sum over priors r^T W r (the
    AprilSAM convention: april_graph_chi2, april_graph.c:79-98);
  * the optimum: Gauss-Newton on that chi2 from the generator's true poses,
    with dense normal equations, until no pose moves by more than TOL
    (1e-8 m or rad: a step of that size changes chi2 by about 1e-16 of
    itself; the steps stall at some 1e-9 where a solve of 30 000 unknowns
    rounds).

Everything is float64: chi2 in numpy on the host, the optimum in torch on
the device it is given (dense Cholesky; 30 000 unknowns take 7.2 GB).

The check's numbers on this reference (check.py: each the largest over
the run's answers, `nonfinite` counted), for every answer of `step` k
whose states are finite:

  chi2_rel   |chi2 the program returned - the reference's chi2 of the
             states the program returned| / the latter (at least FLOOR:
             before the first loop closes, the odometry chain is met
             exactly and chi2 is rounding, 1e-28, which no relative
             comparison can judge): whether the returned chi2 belongs to
             the returned states at the precision the configuration
             states;
  end_gap    at each pass's end, how far the reference's chi2 of the
             returned states of every pose lies above the optimum of the
             whole graph (the reference's Gauss-Newton from the true
             poses), over the optimum: whether the states are the solve's
             answer.  The incremental solver stops short of the optimum
             (it relinearizes a pose only past the configuration's
             thresholds), so sound runs read above 0; a solve whose
             updates are dropped or wrong reads far above.  Mid-pass the
             answer can lie well above the optimum for a while after a
             loop closes (sound runs read up to 2.3 times at a checked
             step), so the optimum is compared at pass ends alone;
  nonfinite  answers with a state or chi2 that is not a finite number.
"""

from __future__ import annotations

import numpy as np
import torch

TWOPI = 2.0 * np.pi
TOL = 1e-8
MAX_ITERS = 12
NUMBERS = ("chi2_rel", "end_gap", "nonfinite")
FLOOR = 1.0


def wrap(v):
    """An angle (a numpy array or a torch tensor) in [-pi, pi)."""
    v = v + np.pi
    floor = torch.floor if isinstance(v, torch.Tensor) else np.floor
    return (v - TWOPI * floor(v / TWOPI)) - np.pi


def edges_upto(graph: dict, k: int):
    """(a, b, z, W) of the edges of the graph after pose k."""
    keep = graph["b"] <= k
    return (graph["a"][keep], graph["b"][keep], graph["z"][keep],
            graph["W"][keep])


def chi2(x, a, b, z, W, prior) -> float:
    """The chi2 of states x [n, 3] on the edges and the prior."""
    x = np.asarray(x, dtype=np.float64)
    pa, pb = x[a], x[b]
    c, s = np.cos(pa[:, 2]), np.sin(pa[:, 2])
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    r = np.stack([z[:, 0] - (c * dx + s * dy), z[:, 1] - (-s * dx + c * dy),
                  wrap(z[:, 2] - (pb[:, 2] - pa[:, 2]))], axis=1)
    e = 0.5 * np.einsum("fi,fij,fj->", r, W, r)
    rp = np.asarray(prior["z"], dtype=np.float64) - x[prior["node"]]
    rp[2] = wrap(rp[2])
    return float(e + rp @ np.asarray(prior["W"], dtype=np.float64) @ rp)


def _scatter(H, idx_row, idx_col, blocks, n3):
    """H[3u+i, 3v+j] += blocks[f, i, j] for the (u, v) of each block."""
    i3 = torch.arange(3, device=H.device)
    rows = (3 * idx_row)[:, None, None] + i3[None, :, None]
    cols = (3 * idx_col)[:, None, None] + i3[None, None, :]
    H.view(-1).index_add_(0, (rows * n3 + cols).reshape(-1),
                          blocks.reshape(-1))


def optimum(x0, a, b, z, W, prior, device="cpu"):
    """Gauss-Newton from x0 [n, 3] to the optimum of chi2.  Returns (x,
    chi2, iterations).  Raises RuntimeError if it has not converged."""
    dev = torch.device(device)
    f64 = torch.float64
    x = torch.as_tensor(np.asarray(x0, dtype=np.float64), device=dev).clone()
    n = x.shape[0]
    n3 = 3 * n
    at = torch.as_tensor(a, device=dev)
    bt = torch.as_tensor(b, device=dev)
    zt = torch.as_tensor(z, dtype=f64, device=dev)
    Wt = torch.as_tensor(W, dtype=f64, device=dev)
    pn = int(prior["node"])
    pz = torch.as_tensor(prior["z"], dtype=f64, device=dev)
    pW = torch.as_tensor(prior["W"], dtype=f64, device=dev)
    for it in range(1, MAX_ITERS + 1):
        pa, pb = x[at], x[bt]
        c, s = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
        dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
        h0, h1 = c * dx + s * dy, -s * dx + c * dy
        r = torch.stack([zt[:, 0] - h0, zt[:, 1] - h1,
                         wrap(zt[:, 2] - (pb[:, 2] - pa[:, 2]))], dim=1)
        m = at.shape[0]
        zero, one = torch.zeros(m, dtype=f64, device=dev), \
            torch.ones(m, dtype=f64, device=dev)
        # dh/dx_a and dh/dx_b (r = z - h, so J_r = -J_h; the signs cancel
        # in H and are carried in the gradient)
        Ja = torch.stack([torch.stack([-c, -s, h1], 1),
                          torch.stack([s, -c, -h0], 1),
                          torch.stack([zero, zero, -one], 1)], 1)
        Jb = torch.stack([torch.stack([c, s, zero], 1),
                          torch.stack([-s, c, zero], 1),
                          torch.stack([zero, zero, one], 1)], 1)
        # chi2 = 1/2 r^T W r per edge: gradient -J^T W r, Gauss-Newton
        # Hessian J^T W J (the factor 2 of the square cancels the 1/2)
        JaW = Ja.transpose(1, 2) @ Wt
        JbW = Jb.transpose(1, 2) @ Wt
        H = torch.zeros(n3, n3, dtype=f64, device=dev)
        _scatter(H, at, at, JaW @ Ja, n3)
        _scatter(H, at, bt, JaW @ Jb, n3)
        _scatter(H, bt, at, JbW @ Ja, n3)
        _scatter(H, bt, bt, JbW @ Jb, n3)
        g = torch.zeros(n3, dtype=f64, device=dev)
        i3 = torch.arange(3, device=dev)
        g.index_add_(0, ((3 * at)[:, None] + i3).reshape(-1),
                     -(JaW @ r[:, :, None]).reshape(-1))
        g.index_add_(0, ((3 * bt)[:, None] + i3).reshape(-1),
                     -(JbW @ r[:, :, None]).reshape(-1))
        # the prior: chi2 = r^T W r, r = z - x_0
        rp = pz - x[pn]
        rp[2] = wrap(rp[2])
        H[3 * pn:3 * pn + 3, 3 * pn:3 * pn + 3] += 2.0 * pW
        g[3 * pn:3 * pn + 3] += -2.0 * (pW @ rp)
        L = torch.linalg.cholesky(H)
        step = torch.cholesky_solve(-g[:, None], L).reshape(n, 3)
        x = x + step
        del H, L
        if float(step.abs().max()) < TOL:
            xs = x.cpu().numpy()
            return xs, chi2(xs, a, b, z, W, prior), it
    raise RuntimeError(f"Gauss-Newton did not converge in {MAX_ITERS} "
                       f"iterations (last step {float(step.abs().max())!r})")



def chi2_rel(graph: dict, prior: dict, ans: dict, x) -> tuple:
    """(the chi2_rel of an answer with finite states x, the reference's
    chi2 of x)."""
    ref = chi2(x, *edges_upto(graph, ans["step"]), prior)
    return abs(ans["chi2"] - ref) / max(ref, FLOOR), ref


def numbers(graph: dict, prior: dict, ans: dict, x, device="cpu") -> dict:
    """This reference's numbers of one answer with finite states x."""
    k = ans["step"]
    out = {}
    out["chi2_rel"], ref = chi2_rel(graph, prior, ans, x)
    if ans.get("end"):
        opt = optimum(graph["truth"][:k + 1], *edges_upto(graph, k), prior,
                      device)[1]
        out["end_gap"] = (ref - opt) / max(opt, FLOOR)
    return out
