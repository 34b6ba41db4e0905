"""CUDA-graph replay against the eager path on the card: the same replay of
manhattan_world(500, seed=0) with the solver's graphs on and off, per step,
in supersteps and in bundles; K1's launch record under graphs; precompile
on the card.

Needs an NVIDIA card and nvcc; every test here carries the `gpu` marker and
skips without a card.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_graphs_gpu.py

Tolerance: a graph replays the kernels the eager dispatch launches, on the
same inputs, so the two agree to rounding at most; per-entry chi2 is held
to relative 1e-9 (absolute 1e-12 near zero), the census exactly.  The
lagged policy reads the newest stats that are *ready*, which depends on
timing, so lagged replays wait for the device before each policy read
(as the JAX package's lagged tests wait for each dispatch).
"""

import numpy as np
import pytest
import torch

from aprilsam_tpu_torch.datasets import manhattan_world
from aprilsam_tpu_torch.kernels import tri_inv as K
from aprilsam_tpu_torch.replay import Replay
from aprilsam_tpu_torch.solver import SolverConfig
from aprilsam_tpu_torch.solver.state import state_to_numpy

POSES = 500
CONFIGS = {
    "per-step": dict(),
    "superstep96": dict(superstep_size=96, policy_lag=0,
                        superstep_buckets=(64, 128, 256, 384, 640, 1024)),
    "windowed": dict(superstep_size=16, policy_lag=2,
                     sweep_window_panels=4, sweep_full_every=4),
    "bundled8": dict(bundle_size=8, policy_lag=8),
    "coalesced8": dict(bundle_size=8, policy_lag=8,
                       coalesce_full_solves=True),
    "dense-epochs": dict(batch_backend="device", nthreshold=30,
                         policy_lag=1),
    "panel-epochs": dict(superstep_size=96, policy_lag=0,
                         batch_backend="panel"),
    # the large-N replay's config scaled down (test_torch_large_inc.py):
    # capacity 128 grows to 512 over these 500 poses
    "large-growth": dict(node_capacity=128, factor_capacity=256,
                         row_block_capacity=96, panel_nodes=32,
                         superstep_size=64, policy_lag=0,
                         superstep_buckets=(64, 128, 256, 384, 640, 1024),
                         sweep_window_panels=16, sweep_full_every=16,
                         batch_backend="panel"),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; graphs are captured on the card")


def _ready_before_policy(s):
    drain = s._drain_pending

    def waited(*args, **kw):
        torch.cuda.synchronize()
        return drain(*args, **kw)
    s._drain_pending = waited


def _replay(kw, graphs):
    cfg = SolverConfig(wallclock_gate=False, **kw)
    rep = Replay(manhattan_world(POSES, seed=0), cfg,
                 deferred=bool(kw), device="cuda")
    if not graphs:
        rep.solver.graphs.enabled = False   # every dispatch eager
    _ready_before_policy(rep.solver)
    K.reset_launches()
    rep.run()
    torch.cuda.synchronize()
    s = rep.solver
    return (s.chi2_history(), dict(s.counters), K.launches,
            dict(K.launches_by_shape), s)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_replay_matches_eager(name):
    _need_card()
    h_e, c_e, n_e, by_e, _s = _replay(CONFIGS[name], graphs=False)
    h_g, c_g, n_g, by_g, s = _replay(CONFIGS[name], graphs=True)
    assert c_g == c_e
    assert h_g.shape == h_e.shape
    assert np.all(np.abs(h_g - h_e) <= 1e-9 * np.abs(h_e) + 1e-12)
    assert s.graphs.replays > 0 and s.graphs.captures > 0
    # K1 under graphs: each replay adds its capture's record
    assert (n_g, by_g) == (n_e, by_e)


@pytest.mark.gpu
def test_precompile_on_the_card_leaves_the_state():
    _need_card()
    rep = Replay(manhattan_world(POSES, seed=0),
                 SolverConfig(wallclock_gate=False), device="cuda")
    for _ in range(200):
        rep.step()
    s = rep.solver
    before = state_to_numpy(s.ds)
    n = s.precompile(nnodes=POSES)
    assert n == len(s.default_signatures(POSES)) + 1
    assert s.graphs.captures >= n
    after = state_to_numpy(s.ds)
    for name, a in before.items():
        assert np.array_equal(a, after[name], equal_nan=True), name
    captured = s.graphs.captures
    # further steps replay the precompiled graphs
    replays = s.graphs.replays
    for _ in range(50):
        rep.step()
    assert s.graphs.replays > replays
    assert s.graphs.captures == captured


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["auto", "device", "panel"])
def test_batch_solver_epochs_on_graphs(backend):
    """BatchSolver's epochs: the first solve captures, the second replays;
    both against the eager solver to rounding."""
    from aprilsam_tpu_torch.solver import BatchSolver

    _need_card()
    out = {}
    for graphs in (False, True):
        s = BatchSolver(SolverConfig(batch_backend=backend), device="cuda")
        if not graphs:
            s.graphs.enabled = False
        g = manhattan_world(POSES, seed=0)
        chi2 = [s.solve(g).chi2, s.solve(g).chi2]
        out[graphs] = (np.asarray(chi2), s.ds.state[:POSES].cpu().numpy(),
                       dict(s.graphs.replayed))
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-9)
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-9,
                               atol=1e-9)
    assert sum(out[True][2].values()) > 0 and not out[False][2]


def _large_growth(graphs: bool, **overrides):
    """test_torch_large_inc.py's scaled-down large-N replay (600 poses from
    node capacity 128, S = 64, window 16/16, panel epochs, lag 0) on the
    card, from a collected allocator; returns (ring, solver, memory
    reserved at its end)."""
    import gc

    from aprilsam_tpu_torch import large_inc

    gc.collect()
    torch.cuda.empty_cache()
    args = large_inc.build_parser().parse_args([
        "--poses", "600", "--start_capacity", "128", "--panel_nodes", "32",
        "--dtype", "float64", "--batch_backend", "panel", "--checkpoints",
        "1"])
    rep = large_inc.make_replay(args, policy_lag=0, policy_poll=1,
                                log_chi2=True, **overrides)
    if not graphs:
        rep.solver.graphs.enabled = False
    large_inc.run_replay(rep, args, out=lambda m: None)
    torch.cuda.synchronize()
    return (rep.solver.chi2_history(), rep.solver,
            torch.cuda.memory_reserved())


@pytest.mark.gpu
def test_capacity_growth_on_graphs():
    """Growth under CUDA graphs: every growth drops the graphs (one
    generation each) and gives their memory back, and the replay captures
    again at the new capacity; the ring equals the eager replay's."""
    _need_card()
    h_e, s_e, _ = _large_growth(graphs=False)
    del s_e
    # one generation at the final capacity, for the memory it holds
    _h, s_one, one_gen = _large_growth(graphs=True, node_capacity=1024,
                                       factor_capacity=1024)
    assert s_one.growths == [] and s_one.graphs.generation == 0
    del s_one
    h_g, s, end = _large_growth(graphs=True)
    assert h_g.shape == h_e.shape
    assert np.all(np.abs(h_g - h_e) <= 1e-12 * np.abs(h_e) + 1e-12)
    caps = [g["node_capacity"] for g in s.growths]
    assert s.cfg.node_capacity == 1024 and sorted(set(caps)) == [256, 512,
                                                                  1024]
    assert s.graphs.generation == len(s.growths)
    assert sorted(s.graphs.by_generation) == list(range(len(s.growths) + 1))
    assert s.graphs.replays > 0
    assert end <= 1.5 * one_gen, (end, one_gen)
