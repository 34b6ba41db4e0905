"""The port's distributed solves (parallel/) against numpy, against the JAX
package and against the port's host batch solver, on the CPU in float64.

Every multi-rank computation runs twice: in this process on a gloo world
of one rank, and in one spawned gloo world of four CPU processes (one
spawn for the whole file).  The JAX package runs on the 4-device virtual
mesh of conftest.py.  The spawned ranks import this module, so JAX and the
JAX package are imported inside the tests only.
"""

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

from aprilsam_tpu_torch.datasets import manhattan_world
from aprilsam_tpu_torch.examples import distributed_solve
from aprilsam_tpu_torch.parallel import (local_shard, one_rank_group,
                                         shard_factor_tables)
from aprilsam_tpu_torch.parallel.dryrun import (_small_problem,
                                                dryrun_multichip, run_ranks,
                                                small_dp_solve)
from aprilsam_tpu_torch.parallel.pchol import (layout_rows, pchol_geom,
                                               pchol_solve)
from aprilsam_tpu_torch.parallel.schur import partition_graph, schur_solve
from aprilsam_tpu_torch.solver import BatchSolver, SolverConfig

torch.set_num_threads(1)

WORLDS = (1, 4)
PCHOL_CASES = [(96, 16), (200, 16), (513, 32)]
MODES = ("gathered", "looped")
SCHUR_GRAPH = dict(n_poses=240, seed=7, closure_prob=0.4)
SCHUR_BLOCKS = (4, 16)
SEP = {"replicated": dict(sep_dist=False),
       "distributed": dict(sep_dist=True, sep_block=16)}
DP = dict(n=32, seed=0, tikhonov=1e-2)
PCHOL_TIKHONOV = 1e-8
# The dry run's realistically shaped float32 case at D = 4 (its graph,
# its separator modes; gn_iters=1, float32's default eq_jitter 1e-5).
# Measured on the CPU: the JAX package's two modes differ by 2.7e-4 in xy
# and 1.1e-5 in theta (mod 2pi), but they share the interior eliminations,
# so that spread sees only the separator solve's rounding.  The port and
# the JAX package differ by 0.020 in xy and 4.7e-4 in theta in each mode,
# while in float64 they agree to 1.2e-10: the difference is float32
# rounding of the whole solve.  Against the float64 solve of the same
# damped system the JAX package's float32 is 0.0164 (xy) and 4.9e-4
# (theta) off in each mode, the port's 0.0075 and 1.5e-4.  So each mode is
# held to twice the JAX package's own float32 error, and the port's
# float32 error to no more than the JAX package's.
F32_GRAPH = dict(n_poses=512 * 4, seed=3, closure_prob=0.2, block=25)
F32_SEP = {"replicated": dict(sep_dist=False),
           "distributed": dict(sep_dist=True, sep_block=128)}
F32_TOL = {"replicated": {"xy": 0.033, "theta": 1e-3},
           "distributed": {"xy": 0.033, "theta": 1e-3}}


def _spd_system(nl):
    rng = np.random.default_rng(nl)
    M = rng.standard_normal((nl, nl))
    c = np.random.default_rng(nl + 1).standard_normal(nl)
    return M @ M.T + nl * np.eye(nl), c


def _pchol_case(mesh, nl, block, mode):
    """pchol_solve of a seeded SPD system: rank 0 holds the padded system
    in the block-cyclic row layout, the reduce-scatter sums it over the
    ranks and hands each its strip, as schur_solve does."""
    geom = pchol_geom(nl, mesh.size, block=block)
    A, c = _spd_system(nl)
    S_pad = torch.zeros((geom.n, geom.n), dtype=torch.float64)
    if mesh.rank == 0:
        lrow = layout_rows(geom, torch.arange(nl))
        S_pad[lrow] = torch.nn.functional.pad(torch.from_numpy(A),
                                              (0, geom.n - nl))
    strip = torch.empty((geom.m * geom.b, geom.n), dtype=torch.float64)
    dist.reduce_scatter_tensor(strip, S_pad, group=mesh.group)
    c_pad = torch.zeros(geom.n, dtype=torch.float64)
    c_pad[:nl] = torch.from_numpy(c)
    return pchol_solve(geom, mesh, strip, c_pad, tikhonov=PCHOL_TIKHONOV,
                       solve_mode=mode).numpy()


def _rank_checks(mesh):
    """Everything this file holds against its references, on one rank."""
    g = manhattan_world(**SCHUR_GRAPH)
    out = {"pchol": {}, "schur": {}}
    for nl, block in PCHOL_CASES:
        for mode in MODES:
            out["pchol"][nl, block, mode] = _pchol_case(mesh, nl, block, mode)
    for B in SCHUR_BLOCKS:
        part = partition_graph(g, B)
        for name, kw in SEP.items():
            out["schur"][B, name] = schur_solve(mesh, g, part, gn_iters=2,
                                                dtype=np.float64, **kw)
    out["dp"] = tuple(t.numpy() for t in small_dp_solve(
        mesh, DP["n"], DP["seed"], torch.float64, DP["tikhonov"]))
    out["f32"] = {}
    out["dryrun"] = dryrun_multichip(mesh, states=out["f32"])
    return out


@pytest.fixture(scope="module")
def port():
    """{world size: [each rank's _rank_checks]}."""
    with one_rank_group("cpu") as mesh:
        one = _rank_checks(mesh)
    return {1: [one], 4: run_ranks(_rank_checks, 4, device="cpu",
                                   timeout=900)}


def _jax_mesh(n):
    from aprilsam_tpu.parallel.dist import make_mesh

    return make_mesh(n)


@pytest.fixture(scope="module")
def jax_schur():
    from aprilsam_tpu.datasets import manhattan_world as j_manhattan
    from aprilsam_tpu.parallel.schur import partition_graph as j_partition
    from aprilsam_tpu.parallel.schur import schur_solve as j_schur

    g = j_manhattan(**SCHUR_GRAPH)
    mesh = _jax_mesh(4)
    return {(B, name): j_schur(mesh, g, j_partition(g, B), gn_iters=2,
                               dtype=np.float64, **kw)
            for B in SCHUR_BLOCKS for name, kw in SEP.items()}


@pytest.fixture(scope="module")
def jax_schur_f32():
    """The JAX package's float32 solve of the dry run's 512*D-pose graph on
    its 4-device mesh in both separator modes, and the float64 solve of
    the same damped system (eq_jitter 1e-5)."""
    from aprilsam_tpu.datasets import manhattan_world as j_manhattan
    from aprilsam_tpu.parallel.schur import partition_graph as j_partition
    from aprilsam_tpu.parallel.schur import schur_solve as j_schur

    g = j_manhattan(**F32_GRAPH)
    part, mesh = j_partition(g, 4), _jax_mesh(4)
    out = {name: j_schur(mesh, g, part, gn_iters=1, dtype=np.float32, **kw)
           for name, kw in F32_SEP.items()}
    out["float64"] = j_schur(mesh, g, part, gn_iters=1, dtype=np.float64,
                             eq_jitter=1e-5)
    return out


def _xy_theta(a, b):
    """Largest xy and theta (mod 2pi) differences of two state tables."""
    dth = np.abs((a[:, 2] - b[:, 2] + np.pi) % (2 * np.pi) - np.pi)
    return float(np.max(np.abs(a[:, :2] - b[:, :2]))), float(np.max(dth))


@pytest.mark.parametrize("sep", list(F32_SEP))
def test_schur_float32_matches_jax(port, jax_schur_f32, sep):
    """The float32 schur_solve of the dry run (four gloo ranks) against the
    JAX package's on its 4-device mesh, per separator mode (F32_TOL), and
    at least as close as the JAX package's to the float64 solve."""
    got = port[4][0]["f32"][sep]
    want = jax_schur_f32[sep]
    assert got.shape == want.shape == (F32_GRAPH["n_poses"], 3)
    xy, th = _xy_theta(got, want)
    assert xy < F32_TOL[sep]["xy"] and th < F32_TOL[sep]["theta"], (xy, th)
    ref = jax_schur_f32["float64"]
    err_t, err_j = _xy_theta(got, ref), _xy_theta(want, ref)
    assert err_t[0] <= err_j[0] and err_t[1] <= err_j[1], (err_t, err_j)


def test_dryrun_max_diff_is_jax():
    """The dry run compares two state tables as the JAX package's does
    (__graft_entry__.py:146): max |a - b| over all three columns, angles
    not wrapped; the figure mod 2pi is printed beside it."""
    from aprilsam_tpu_torch.parallel.dryrun import _max_diff, _max_diff_mod2pi

    rng = np.random.default_rng(0)
    a = rng.standard_normal((50, 3))
    a[:, 2] = rng.uniform(-np.pi, np.pi, 50)
    b = a + 1e-3 * rng.standard_normal((50, 3))
    b[7, 2] = a[7, 2] + 2 * np.pi - 1e-3        # nearly 2pi apart
    assert _max_diff(a, b) == float(np.max(np.abs(a - b)))
    assert _max_diff(a, b) > 6.0
    d = a - b
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    assert _max_diff_mod2pi(a, b) == pytest.approx(np.max(np.abs(d)),
                                                   abs=1e-12)
    assert _max_diff_mod2pi(a, b) < 0.01


def test_ranks_agree(port):
    """Outputs are replicated: the four ranks return the same arrays."""
    ranks = port[4]
    for r in ranks[1:]:
        for key, x in ranks[0]["pchol"].items():
            np.testing.assert_array_equal(r["pchol"][key], x)
        for key, x in ranks[0]["schur"].items():
            np.testing.assert_array_equal(r["schur"][key], x)
        for a, b in zip(r["dp"], ranks[0]["dp"]):
            np.testing.assert_array_equal(a, b)
        for key, x in ranks[0]["f32"].items():
            np.testing.assert_array_equal(r["f32"][key], x)
        assert r["dryrun"] == ranks[0]["dryrun"]


@pytest.mark.parametrize("n,seed,closure,B", [(240, 7, 0.4, 4),
                                              (400, 11, 0.5, 8)])
def test_partition_matches_jax(n, seed, closure, B):
    from aprilsam_tpu.datasets import manhattan_world as j_manhattan
    from aprilsam_tpu.parallel.schur import partition_graph as j_partition

    pt = partition_graph(manhattan_world(n, seed=seed, closure_prob=closure),
                         B)
    pj = j_partition(j_manhattan(n, seed=seed, closure_prob=closure), B)
    assert pt.ns > 0
    for f in ("B", "ni_max", "ns", "nsl", "fmax", "pmax", "D"):
        assert getattr(pt, f) == getattr(pj, f), f
    for f in ("sep_nodes", "sep_map", "fa", "fb", "fz", "fW", "fvalid",
              "pn", "pz", "pW", "pvalid"):
        a, b = getattr(pt, f), getattr(pj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(pt.interiors) == len(pj.interiors) == B
    for a, b in zip(pt.interiors, pj.interiors):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nl,block", PCHOL_CASES)
def test_pchol_matches_numpy(port, world, nl, block, mode):
    """The block-cyclic factorization and both solve modes against
    np.linalg.solve; the padding solves to exactly zero."""
    x = port[world][0]["pchol"][nl, block, mode]
    assert x.shape == (pchol_geom(nl, world, block=block).n,)
    A, c = _spd_system(nl)
    ref = np.linalg.solve(A + PCHOL_TIKHONOV * np.eye(nl), c)
    np.testing.assert_allclose(x[:nl], ref, rtol=1e-9, atol=1e-9)
    assert np.all(x[nl:] == 0.0)


def test_layout_rows_matches_jax():
    import jax.numpy as jnp

    from aprilsam_tpu.parallel.pchol import layout_rows as j_layout
    from aprilsam_tpu.parallel.pchol import pchol_geom as j_geom

    for nl, D, b in ((513, 4, 32), (96, 1, 16), (300, 8, 8)):
        gt, gj = pchol_geom(nl, D, block=b), j_geom(nl, D, block=b)
        assert (gt.n_live, gt.D, gt.b, gt.m, gt.nb, gt.n) == \
            (gj.n_live, gj.D, gj.b, gj.m, gj.nb, gj.n)
        idx = np.arange(gt.n + 5)
        np.testing.assert_array_equal(
            layout_rows(gt, torch.from_numpy(idx)).numpy(),
            np.asarray(j_layout(gj, jnp.asarray(idx))))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("sep", list(SEP))
@pytest.mark.parametrize("B", SCHUR_BLOCKS)
def test_schur_matches_jax(port, jax_schur, world, B, sep):
    """Both separator modes, B = 4 and 16, against the JAX package's
    schur_solve on its 4-device mesh: states within 1e-8."""
    np.testing.assert_allclose(port[world][0]["schur"][B, sep],
                               jax_schur[B, sep], rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def batch_reference():
    g = manhattan_world(**SCHUR_GRAPH)
    cfg = SolverConfig(node_capacity=512, factor_capacity=2048,
                       row_block_capacity=64, gn_iters=2)
    mono = BatchSolver(cfg, device="cpu")
    mono.solve(g)
    g_mono = copy.deepcopy(g)
    mono.sync_states(g_mono)
    return g, mono.chi2(), g_mono.state[: g.nnodes]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("B", SCHUR_BLOCKS)
def test_schur_matches_batch_solver(port, batch_reference, world, B):
    """The decomposition solves the monolithic normal equations: chi2 and
    xy of the port's host BatchSolver (gn_iters=2) within 1e-5."""
    g, chi2_mono, st_mono = batch_reference
    states = port[world][0]["schur"][B, "replicated"]
    g2 = copy.deepcopy(g)
    g2.state[: g.nnodes] = states
    assert abs(g2.chi2() - chi2_mono) / max(chi2_mono, 1e-9) < 1e-5
    np.testing.assert_allclose(states[:, :2], st_mono[:, :2], atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_batch_solve_matches_jax(port, world):
    """dx, y and L of the data-parallel solve against the JAX package's on
    a mesh of the same size, within 1e-10."""
    import jax.numpy as jnp

    from aprilsam_tpu.parallel.dist import dp_batch_solve as j_dp
    from aprilsam_tpu.parallel.dist import shard_factor_tables as j_shard

    n = DP["n"]
    states, a, b, z, W = _small_problem(n, seed=DP["seed"])
    a, b, z, W, valid = j_shard(world, a, b, z, W,
                                np.ones(a.shape[0], dtype=bool))
    st = jnp.asarray(states)
    ref = j_dp(_jax_mesh(world), st, st, jnp.arange(n, dtype=jnp.int32),
               jnp.asarray(a), jnp.asarray(b), jnp.asarray(z),
               jnp.asarray(W), jnp.asarray(valid),
               jnp.zeros((world,), jnp.int32), jnp.zeros((world, 3)),
               jnp.zeros((world, 3, 3)), jnp.zeros((world,), dtype=bool),
               MB=n, tikhonov=DP["tikhonov"])
    for got, want in zip(port[world][0]["dp"], ref):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-10)


def test_small_problem_and_sharding_match_jax():
    """_small_problem is the JAX dry run's; the padded tables are the JAX
    package's, and the ranks' shards tile them in order."""
    from __graft_entry__ import _small_problem as j_small
    from aprilsam_tpu.parallel.dist import shard_factor_tables as j_shard

    for t, j in zip(_small_problem(16, seed=1), j_small(16, seed=1)):
        np.testing.assert_array_equal(t, j)
    states, a, b, z, W = _small_problem(17, seed=1)
    valid = np.ones(a.shape[0], dtype=bool)
    padded = shard_factor_tables(4, a, b, z, W, valid)
    for t, j in zip(padded, j_shard(4, a, b, z, W, valid)):
        np.testing.assert_array_equal(t, j)

    class Rank:
        size = 4

        def __init__(self, rank):
            self.rank = rank

    for t in padded:
        np.testing.assert_array_equal(
            np.concatenate([local_shard(Rank(r), t)[0] for r in range(4)]),
            t)
    with pytest.raises(ValueError):
        local_shard(Rank(0), a[:17])


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_multichip(port, world):
    """The JAX package's dry run, ported: every check passed on every rank
    (it raises otherwise); with four ranks both separator modes ran."""
    res = port[world][0]["dryrun"]
    assert res["ranks"] == world
    assert res["large_poses"] == 512 * world
    if world == 4:
        assert res["small_ns"] > 0 and res["large_ns"] > 0
        assert res["small_sep_diff"] < 5e-2 and res["large_sep_diff"] < 5e-2
        assert res["large_sep_diff_mod2pi"] <= res["large_sep_diff"]


def test_distributed_solve_example(capsys):
    """The example brings up its own one-rank group on the CPU and lowers
    the chi2."""
    distributed_solve.main(["--poses", "400", "--blocks", "4",
                            "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "ranks: 1, blocks: 4, device: cpu"
    before = float(out[1].split("chi2 ")[1])
    after = float(out[-1].split("chi2 ")[1])
    assert after < 0.1 * before
    assert not dist.is_initialized()


def test_cholesky_nan_per_matrix_of_a_batch():
    """A batch of interior blocks where one is not SPD: that factor is NaN
    throughout (as jnp.linalg.cholesky returns it), the others exact."""
    from aprilsam_tpu_torch.solver.batch import cholesky_nan

    A = torch.from_numpy(np.stack([_spd_system(8)[0], -np.eye(8),
                                   _spd_system(9)[0][:8, :8]]))
    L = cholesky_nan(A.clone())
    assert torch.isnan(L[1]).all()
    for i in (0, 2):
        torch.testing.assert_close(L[i], torch.linalg.cholesky(A[i]),
                                   rtol=0, atol=0)
