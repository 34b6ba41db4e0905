"""The large-N replay (aprilsam_tpu_torch/large_inc.py, the counterpart of
bench_large_inc.py) against the JAX package on the CPU in float64, scaled
down: manhattan_world(600, seed=0, closure_prob=0.02, block=25,
max_closures_per_pose=1) from node capacity 128 (it grows to 1024), with
panel_nodes=32, S = 64, the windowed sweep 16/16 and panel epochs.

Tolerances:
  * lag 0: the metric ring within relative 1e-8 (absolute 1e-20 at the
    rounding level of zero); the counters, the capacity growths (step and
    capacities) and the epochs by backend equal.  A panel epoch's factor
    differs from the JAX package's in rounding (relative ~2e-11 in R and
    ~1e-10 in the states after the second epoch: two LAPACK builds), and a
    ring entry read away from a minimum (a superstep's chi2 of ~202 before
    the next epoch) carries that difference to first order: 4.2e-9 here,
    the other entries within 1.4e-11;
  * the script's lag (policy_lag=3, policy_poll=2), each superstep
    dispatch waited for in the JAX package (its lagged policy reads the
    newest *ready* stats): the final chi2 within 0.05, the JAX package's
    band for lagged replays (tests/test_incremental.py:664).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from aprilsam_tpu.datasets import manhattan_world as j_manhattan
from aprilsam_tpu.replay import Replay as JReplay
from aprilsam_tpu.solver import SolverConfig as JConfig

from aprilsam_tpu_torch import large_inc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSES, START, PANEL = 600, 128, 32
ARGV = ["--device", "cpu", "--poses", str(POSES), "--start_capacity",
        str(START), "--panel_nodes", str(PANEL), "--batch_backend", "panel"]
LAG0 = dict(policy_lag=0, policy_poll=1, log_chi2=True)
CHI2_BAND = 0.05


def _jax_replay(wait: bool, **overrides):
    """bench_large_inc.py's graph and config (scaled down as above) through
    the JAX package, with panel epochs; every superstep dispatch waited
    for where `wait`.  Returns the solver, the growths (step, capacities)
    and the epochs by backend, counted by wrapping the package's epoch
    functions and its growth check for the replay."""
    from aprilsam_tpu.solver import batch, host_batch, panel_epoch
    from aprilsam_tpu.solver.incremental import IncrementalSolver

    args = large_inc.build_parser().parse_args(ARGV)
    kw = dict(node_capacity=START, factor_capacity=2 * START,
              row_block_capacity=96, panel_nodes=PANEL, wallclock_gate=False,
              policy_lag=args.policy_lag, policy_poll=2,
              superstep_size=args.superstep,
              superstep_buckets=large_inc.BUCKETS,
              sweep_window_panels=args.sweep_window,
              sweep_full_every=args.sweep_full_every, log_chi2=False,
              batch_backend="panel", dtype=np.float64)
    kw.update(overrides)
    epochs = {"panel": 0, "dense": 0, "host": 0}
    growths = []
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, key in ((panel_epoch, "panel_epoch_step", "panel"),
                               (batch, "_batch_step", "dense"),
                               (host_batch, "host_batch_epoch", "host")):
            def counted(*a, _orig=getattr(mod, name), _key=key, **k):
                epochs[_key] += 1
                return _orig(*a, **k)
            mp.setattr(mod, name, counted)
        grow = IncrementalSolver._maybe_grow_capacity

        def recorded(self, g):
            before = (self.cfg.node_capacity, self.cfg.factor_capacity)
            grow(self, g)
            after = (self.cfg.node_capacity, self.cfg.factor_capacity)
            if after != before:
                growths.append((g.nnodes - 1, *after))
        mp.setattr(IncrementalSolver, "_maybe_grow_capacity", recorded)

        g = j_manhattan(POSES, seed=0, closure_prob=args.closure_prob,
                        block=25, max_closures_per_pose=1)
        rep = JReplay(g, JConfig(**kw), deferred=True)
        s = rep.solver
        if wait:
            dispatch = s._dispatch_superstep

            def waited():
                dispatch()
                jax.block_until_ready(s.ds)
            s._dispatch_superstep = waited
        while rep.step() is not None:
            pass
        s.flush(rep.graph)
        jax.block_until_ready(s.ds)
    return s, growths, epochs


def _port_replay(**overrides):
    """The port's replay through large_inc, one chi2 read at the end."""
    args = large_inc.build_parser().parse_args(ARGV + ["--checkpoints", "1"])
    rep = large_inc.make_replay(args, **overrides)
    res = large_inc.run_replay(rep, args, out=lambda m: None)
    growths = [(g["step"], g["node_capacity"], g["factor_capacity"])
               for g in res["growths"]]
    return rep.solver, res, growths


@pytest.fixture(scope="module")
def lag0():
    return _jax_replay(wait=False, **LAG0), _port_replay(**LAG0)


def test_large_config_ring_matches_jax(lag0):
    (sj, gj, ej), (st, res, gt) = lag0
    hj, ht = np.asarray(sj.chi2_history()), st.chi2_history()
    assert hj.shape == ht.shape and len(ht) > 10
    np.testing.assert_allclose(ht, hj, rtol=1e-8, atol=1e-20)
    assert res["final_chi2"] == pytest.approx(float(sj.chi2()), rel=1e-8)


def test_large_config_counters_growths_epochs_match_jax(lag0):
    (sj, gj, ej), (st, res, gt) = lag0
    for k, v in sj.counters.items():
        assert st.counters[k] == v, k
    assert res["epochs"] == ej
    assert sum(ej.values()) == sj.counters["batch"]
    # three node doublings, 128 -> 1024, each at the step that caused it
    assert gt == gj
    assert sorted({g[1] for g in gt}) == [256, 512, 1024]
    assert (st.cfg.node_capacity, st.cfg.factor_capacity) == \
        (sj.cfg.node_capacity, sj.cfg.factor_capacity)


def test_large_config_lagged_matches_jax():
    sj, gj, ej = _jax_replay(wait=True)
    st, res, gt = _port_replay()
    assert st.cfg.policy_lag == 3 and st.cfg.policy_poll == 2
    assert gt == gj
    assert abs(res["final_chi2"] - float(sj.chi2())) < CHI2_BAND, \
        (res["final_chi2"], float(sj.chi2()))


def test_large_inc_cli_on_the_cpu():
    """The entry point at a small size: exits 0, grows, and ends with the
    JAX script's JSON line."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "aprilsam_tpu_torch.large_inc", "--device",
         "cpu", "--poses", "300", "--start_capacity", "128",
         "--panel_nodes", "32"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["metric"] == "large_inc_replay_poses_per_sec"
    assert last["value"] > 0 and last["vs_baseline"] == 0.0
    unit = dict(kv.split("=", 1) for kv in
                last["unit"][last["unit"].index("(") + 1:-1].split(", "))
    assert int(unit["poses"]) == 300 and unit["device"] == "cpu"
    assert int(unit["final_ncap"]) >= 256
    assert np.isfinite(float(unit["final_chi2"]))
    figures = json.loads(lines[-2])
    assert figures["node_capacity"] == int(unit["final_ncap"])
    assert len(figures["growths"]) >= 1
    # the CPU's default epoch is the JAX script's "auto" (the host epoch)
    assert figures["epochs"]["host"] == figures["counters"]["batch"] > 0
    assert sum(1 for ln in lines if ln.startswith("step ")) == 10


def test_large_graph_equals_jax():
    """The script's 20 000-pose graph is the JAX package's, array for
    array: 20 000 nodes, 20 174 factors."""
    kw = dict(seed=0, closure_prob=0.02, block=25, max_closures_per_pose=1)
    gt = large_inc.make_replay(large_inc.build_parser().parse_args(
        ["--device", "cpu"])).loaded
    gj = j_manhattan(20000, **kw)
    assert (gt.nnodes, gt.nfactors) == (gj.nnodes, gj.nfactors) \
        == (20000, 20174)
    for name in ("ftype", "fnodes", "fz", "fW", "init", "truth", "state"):
        a, b = getattr(gt, name), np.asarray(getattr(gj, name))
        n = gt.nfactors if name.startswith("f") else gt.nnodes
        np.testing.assert_array_equal(a[:n], b[:n], err_msg=name)
