"""The port's synchronous incremental engine against the algebra and
against the JAX package, on the CPU in float64.

Tolerances: the port runs the same algebra as the JAX package on the same
padded shapes, but through another LAPACK build (torch's, where the JAX
package runs XLA's), so values agree to rounding, not bit for bit.  Per-step chi2 is held to
relative 1e-9; chi2 values at rounding level of zero (the first steps of a
replay, ~1e-28) are held to an absolute 1e-20 instead.  StepResult.chi2 is
held to relative 1e-6 because the JAX package reads it back through a
float32 stats vector."""

from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aprilsam_tpu.datasets import manhattan_world as j_manhattan
from aprilsam_tpu.factors import eval_xyt, gn_blocks_xyt
from aprilsam_tpu.replay import Replay as JReplay
from aprilsam_tpu.solver import SolverConfig as JConfig

from aprilsam_tpu_torch.datasets import manhattan_world as t_manhattan
from aprilsam_tpu_torch.geometry import np_xyt_inv_mul, np_xyt_mul
from aprilsam_tpu_torch.graph import FactorGraph
from aprilsam_tpu_torch.kernels import tri_inv as K
from aprilsam_tpu_torch.replay import Replay as TReplay
from aprilsam_tpu_torch.solver import IncrementalSolver, SolverConfig
from aprilsam_tpu_torch.solver.incremental import SeedSpec
from aprilsam_tpu_torch.solver.state import (state_from_numpy,
                                             state_to_numpy,
                                             symbolic_from_numpy,
                                             symbolic_to_numpy)

torch.set_num_threads(1)

W_ODO = np.diag([100.0, 100.0, (180.0 / np.pi) ** 2])
SMALL = dict(node_capacity=512, factor_capacity=2048, row_block_capacity=64,
             panel_nodes=32, wallclock_gate=False)
CHI2_ATOL = 1e-20


def small_cfg(**kw):
    return SolverConfig(**{**SMALL, **kw})


def chain_graph(n, y_noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    g = FactorGraph()
    for i in range(n):
        p = [float(i), y_noise * rng.standard_normal(), 0.0]
        g.add_node(p, init=p)
    g.add_factor_xytpos(0, [0, 0, 0], np.diag([1e4, 1e4, 1e3]))
    for i in range(n - 1):
        z = np_xyt_inv_mul(g.init[i], g.init[i + 1])
        g.add_factor_xyt(i, i + 1, z, W_ODO)
    return g


def dense_R(solver):
    ds = solver.ds
    n = ds.nnodes
    NCAP = ds.state.shape[0]
    Rb, Ri = ds.R_blocks.numpy(), ds.R_idx.numpy()
    R = np.zeros((3 * n, 3 * n))
    for p in range(n):
        for s in range(Ri.shape[1]):
            c = Ri[p, s]
            if c >= NCAP or c >= n:
                continue
            R[3 * p: 3 * p + 3, 3 * c: 3 * c + 3] = Rb[p, s]
    return R


def normal_equations(g, pos, tikhonov_nodes):
    """A and b at the graph's l_points (position space, upper-mirror W),
    assembled with the JAX package's factor code; tikhonov only on the rows
    of the last batch epoch (the incremental path adds no damping)."""
    n = g.nnodes
    A = np.zeros((3 * n, 3 * n))
    b = np.zeros(3 * n)
    lp = jnp.asarray(g.l_point[:n])
    for f in range(g.nfactors):
        a, bb = (int(v) for v in g.fnodes[f])
        if bb >= 0:
            ev = eval_xyt(lp, jnp.asarray([a]), jnp.asarray([bb]),
                          jnp.asarray(g.fz[f][None]),
                          jnp.asarray(g.fW[f][None]))
            Haa, Hab, Hba, Hbb, ga, gb = gn_blocks_xyt(
                ev, jnp.asarray(g.fW[f][None]))
            pa, pb = 3 * pos[a], 3 * pos[bb]
            A[pa:pa + 3, pa:pa + 3] += np.asarray(Haa[0])
            A[pa:pa + 3, pb:pb + 3] += np.asarray(Hab[0])
            A[pb:pb + 3, pa:pa + 3] += np.asarray(Hba[0])
            A[pb:pb + 3, pb:pb + 3] += np.asarray(Hbb[0])
            b[pa:pa + 3] += np.asarray(ga[0])
            b[pb:pb + 3] += np.asarray(gb[0])
        else:
            pa = 3 * pos[a]
            A[pa:pa + 3, pa:pa + 3] += g.fW[f]
            b[pa:pa + 3] += g.fW[f] @ (g.fz[f] - g.state[a])
    A = np.triu(A) + np.triu(A, 1).T
    for i in tikhonov_nodes:
        p = 3 * pos[i]
        A[p:p + 3, p:p + 3] += 1e-4 * np.eye(3)
    return A, b


def test_incremental_factor_matches_normal_equations():
    """R^T R equals the normal equations at the linearization points after
    a batch epoch and after two incremental steps."""
    g = chain_graph(6)
    s = IncrementalSolver(small_cfg(nthreshold=10**9), device="cpu")
    s.solve(g)
    R = dense_R(s)
    A, _ = normal_equations(g, np.asarray(s.sym.pos), range(6))
    np.testing.assert_allclose(R.T @ R, A, atol=1e-8)

    for k in (6, 7):
        z = np.array([1.0, 0.0, 0.0])
        seeded = np_xyt_mul(s.ds.state[k - 1].numpy(), z)
        g.add_node(seeded, init=seeded)
        g.l_point[k] = seeded
        g.add_factor_xyt(k - 1, k, z, W_ODO)
        info = s.update(g)
        assert s.last_path in ("fast", "full")
        assert info.spd
    g.l_point[: g.nnodes] = s.ds.l_point[: g.nnodes].numpy()
    R = dense_R(s)
    A, _ = normal_equations(g, np.asarray(s.sym.pos), range(6))
    np.testing.assert_allclose(R.T @ R, A, atol=1e-7)


def test_incremental_loop_closure_full_path_solution():
    """A loop closure forced onto the full path (the panel sweep through
    tri_inv): the states solve the accumulated normal equations."""
    n = 20
    g = chain_graph(n)
    s = IncrementalSolver(small_cfg(nthreshold=10**9, small_path_max=0),
                          device="cpu")
    s.solve(g)
    g.add_factor_xyt(2, n - 1, np.array([0.5, 0.3, 0.05]), W_ODO)
    s.update(g)
    assert s.last_path == "full"
    assert K.launches == 0            # CPU tensors take the plain version

    g.l_point[: g.nnodes] = s.ds.l_point[: g.nnodes].numpy()
    pos = np.asarray(s.sym.pos)
    A, b = normal_equations(g, pos, range(n))
    x = np.linalg.solve(A, b)
    exp = np.stack([g.l_point[i] + x[3 * pos[i]: 3 * pos[i] + 3]
                    for i in range(n)])
    np.testing.assert_allclose(s.ds.state[:n, :2].numpy(), exp[:, :2],
                               atol=1e-7)


def test_tutorial_incremental_replay():
    """The tutorial dogleg: chi2 0 through step 5, 7.805041 at the loop
    closure, and the golden y values."""
    s = IncrementalSolver(small_cfg(nthreshold=100), device="cpu")
    g = FactorGraph()
    g.add_node([0, 0, 0], init=[0, 0, 0])
    g.add_factor_xytpos(0, [0, 0, 0], np.diag([1e4, 1e4, 1e3]))
    assert s.solve(g).chi2 < 1e-9
    W = np.diag([1 / 0.1 ** 2, 1 / 0.1 ** 2, 1 / np.radians(1.0) ** 2])
    for i in range(1, 6):
        g.add_node([i, 0, 0], init=[i, 0, 0])
        g.add_factor_xyt(i - 1, i, np_xyt_inv_mul(g.init[i - 1], g.init[i]), W)
        if i == 5:
            g.add_factor_xyt(0, 5, np_xyt_inv_mul(np.zeros(3),
                                                  np.array([5.0, 1, 0])), W)
        info = s.update(g)
        if i < 5:
            assert info.chi2 < 1e-9
    assert abs(info.chi2 - 7.805041) < 1e-4
    np.testing.assert_allclose(
        s.ds.state[:6, 1].numpy(),
        [0.0, 0.156098, 0.323291, 0.496825, 0.671944, 0.843894], atol=1e-4)


def test_plan_overflow_fallback_ingests_new_factors():
    """A step beyond new_factor_capacity falls back to a batch epoch after
    ingesting its nodes, factors and seed; later steps still see them."""
    n = 30
    g = chain_graph(n, y_noise=0.05, seed=7)
    s = IncrementalSolver(small_cfg(nthreshold=10**9), device="cpu")
    s.solve(g)
    z = np.array([1.0, 0.0, 0.0])
    seeded = np_xyt_mul(s.ds.state[n - 1].numpy(), z)
    g.add_node(seeded, init=seeded)
    g.add_factor_xyt(n - 1, n, z, W_ODO)
    rng = np.random.default_rng(11)
    for a in rng.choice(n - 2, size=18, replace=False):
        zc = np_xyt_inv_mul(g.init[a], g.init[n]) + np.array([0.05, -0.02,
                                                               0.01])
        g.add_factor_xyt(int(a), n, zc, W_ODO)
    info = s.update(g, seeds=[SeedSpec(src=n - 1, dst=n, z=z, invert=False)])
    assert s.last_path == "batch"
    s.sync_states(g)
    assert abs(info.chi2 - g.chi2()) < 1e-6 * (1.0 + abs(g.chi2()))
    assert abs(s.chi2() - g.chi2()) < 1e-6 * (1.0 + abs(g.chi2()))

    seeded2 = np_xyt_mul(s.ds.state[n].numpy(), z)
    g.add_node(seeded2, init=seeded2)
    g.add_factor_xyt(n, n + 1, z, W_ODO)
    s.update(g, seeds=[SeedSpec(src=n, dst=n + 1, z=z, invert=False)])
    s.flush(g)
    s.sync_states(g)
    assert abs(s.chi2() - g.chi2()) < 1e-6 * (1.0 + abs(g.chi2()))


def test_python_planner_matches_native_planner():
    """The pure-python planner and the native C planner give the same
    trajectory (the same plans, hence bit-identical chi2)."""
    def run(python_planner):
        rep = TReplay(t_manhattan(150, seed=1),
                      SolverConfig(**{**SMALL, "nthreshold": 30}),
                      device="cpu")
        rep.solver.python_planner = python_planner
        res = rep.run()
        return rep.solver.chi2_history(), [r.path for r in res]

    h_nat, p_nat = run(False)
    h_py, p_py = run(True)
    assert p_py == p_nat
    assert {"fast", "full", "batch"} <= set(p_nat)
    np.testing.assert_array_equal(h_py, h_nat)


# ------------------------------------------------------ JAX replay parity

N_REPLAY = 300


@pytest.fixture(scope="module")
def jax_replay():
    rep = JReplay(j_manhattan(N_REPLAY, seed=0), JConfig(**SMALL))
    res = rep.run()
    return rep, res


def test_manhattan300_replay_matches_jax(jax_replay):
    rep_j, res_j = jax_replay
    rep_t = TReplay(t_manhattan(N_REPLAY, seed=0), SolverConfig(**SMALL),
                    device="cpu")
    res_t = rep_t.run()
    paths_j = [r.path for r in res_j]
    paths_t = [r.path for r in res_t]
    assert Counter(paths_j) == Counter({"fast": 263, "full": 33, "batch": 4})
    assert paths_t == paths_j
    # batch epochs, the fallbacks that fired after a step's body included
    assert rep_t.solver.counters["batch"] == rep_j.solver.counters["batch"]
    h_j, h_t = rep_j.solver.chi2_history(), rep_t.solver.chi2_history()
    assert h_t.shape == h_j.shape == (N_REPLAY,)
    np.testing.assert_allclose(h_t, h_j, rtol=1e-9, atol=CHI2_ATOL)
    np.testing.assert_allclose([r.chi2 for r in res_t],
                               [r.chi2 for r in res_j], rtol=1e-6,
                               atol=CHI2_ATOL)
    n = rep_t.graph.nnodes
    np.testing.assert_allclose(rep_t.solver.ds.state[:n].numpy(),
                               np.asarray(rep_j.solver.ds.state[:n]),
                               rtol=1e-9, atol=1e-9)


# ------------------------------------------------------------ carry-across

CARRY_FIELDS_F = ("R_blocks", "y", "state", "l_point", "delta_X")
CARRY_FIELDS_I = ("R_idx", "R_nnz", "relinearized", "start_over", "spd_ok",
                  "pos", "order", "n_xyt", "n_pos", "nnodes", "log_ptr")


def _jax_fields(ds):
    return {k: np.array(v) for k, v in ds._asdict().items()}


def test_carry_across_mid_replay():
    """Load a JAX solver's state (device state, symbolic state with its
    native planner mirror, solver counters) after k steps into the port;
    both then take one fast and one full step and agree to 1e-10."""
    k = 69               # manhattan_world(300, seed=0): step 69 fast, 70 full
    rep_j = JReplay(j_manhattan(N_REPLAY, seed=0), JConfig(**SMALL))
    rep_j.run(max_steps=k)
    sj = rep_j.solver
    assert sj.sym.pad_idx is not None        # the native mirror is carried

    rep_t = TReplay(t_manhattan(N_REPLAY, seed=0), SolverConfig(**SMALL),
                    device="cpu")
    for _ in range(k):                   # the same graph, without solving
        rep_t._add_pose()
    st = rep_t.solver
    st.ds = state_from_numpy(_jax_fields(sj.ds), "cpu")
    st.sym = symbolic_from_numpy(symbolic_to_numpy(sj.sym))
    for name in ("factor_num", "node_num", "_ingested_nodes",
                 "_ingested_factors", "batch_time_ms"):
        setattr(st, name, getattr(sj, name))
    # the round trip is lossless
    back = state_to_numpy(st.ds)
    for name, v in _jax_fields(sj.ds).items():
        np.testing.assert_array_equal(back[name], v, err_msg=name)

    for expect in ("fast", "full"):
        a, b = rep_j.step(), rep_t.step()
        assert a.path == b.path == expect
        hj, ht = _jax_fields(sj.ds), state_to_numpy(st.ds)
        for name in CARRY_FIELDS_F:
            np.testing.assert_allclose(ht[name], hj[name], rtol=1e-10,
                                       atol=1e-10, err_msg=name)
        for name in CARRY_FIELDS_I:
            np.testing.assert_array_equal(ht[name], hj[name], err_msg=name)
        np.testing.assert_allclose(b.chi2, a.chi2, rtol=1e-6,
                                   atol=CHI2_ATOL)

