"""Replays of the port that go beyond the default small configuration,
against the JAX package on the CPU: capacity growth mid-replay, and the
float32 replay that the CLI runs by default on the card.  Tolerances as in
test_torch_incremental.py; the float32 one is stated below."""

import numpy as np
import pytest
import torch

from aprilsam_tpu.datasets import manhattan_world as j_manhattan
from aprilsam_tpu.replay import Replay as JReplay
from aprilsam_tpu.solver import SolverConfig as JConfig

from aprilsam_tpu_torch.datasets import manhattan_world as t_manhattan
from aprilsam_tpu_torch.replay import Replay as TReplay
from aprilsam_tpu_torch.solver import SolverConfig

torch.set_num_threads(1)

SMALL = dict(node_capacity=512, factor_capacity=2048, row_block_capacity=64,
             panel_nodes=32, wallclock_gate=False)
CHI2_ATOL = 1e-20
N_REPLAY = 300


@pytest.mark.parametrize("caps", [
    {"node_capacity": 64, "factor_capacity": 128, "metric_log_capacity": 512},
    {"row_block_capacity": 3},
], ids=["node-factor-growth", "row-growth"])
def test_capacity_growth_matches_jax(caps):
    """Replays that outgrow node/factor capacity (state rebuilt at doubled
    capacity, planner mirror rebuilt) or the R row width (grown by 3/2 and
    the epoch retried) take the JAX package's trajectory."""
    kw = {**SMALL, **caps}
    rep_j = JReplay(j_manhattan(100, seed=2), JConfig(**kw))
    res_j = rep_j.run()
    rep_t = TReplay(t_manhattan(100, seed=2), SolverConfig(**kw),
                    device="cpu")
    res_t = rep_t.run()
    for name in ("node_capacity", "factor_capacity", "row_block_capacity"):
        assert getattr(rep_t.solver.cfg, name) == \
            getattr(rep_j.solver.cfg, name)
        assert getattr(rep_t.solver.cfg, name) >= kw[name]
    assert rep_t.solver.cfg != SolverConfig(**kw)       # it did grow
    assert [r.path for r in res_t] == [r.path for r in res_j]
    np.testing.assert_allclose(rep_t.solver.chi2_history(),
                               rep_j.solver.chi2_history(), rtol=1e-9,
                               atol=CHI2_ATOL)


def test_manhattan300_float32_replay_matches_jax():
    """The float32 replay (the CLI's default on the card) takes the JAX
    package's float32 paths, with per-step chi2 within relative 1e-4:
    float32 rounding differs between the two QR implementations and
    accumulates across incremental steps until each batch epoch."""
    kw = {**SMALL, "dtype": np.float32}
    rep_j = JReplay(j_manhattan(N_REPLAY, seed=0), JConfig(**kw))
    res_j = rep_j.run()
    rep_t = TReplay(t_manhattan(N_REPLAY, seed=0), SolverConfig(**kw),
                    device="cpu")
    res_t = rep_t.run()
    assert rep_t.solver.ds.state.dtype == torch.float32
    assert [r.path for r in res_t] == [r.path for r in res_j]
    h_j, h_t = rep_j.solver.chi2_history(), rep_t.solver.chi2_history()
    assert h_t.dtype == h_j.dtype == np.float32
    np.testing.assert_allclose(h_t, h_j, rtol=1e-4, atol=1e-6)
