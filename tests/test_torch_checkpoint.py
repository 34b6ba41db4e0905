"""Solver checkpoints of the port, against themselves and across packages.

The port writes the JAX package's .npz layout, so a checkpoint of either
package resumes in the other.  All runs are float64 on the CPU with the
wall-clock gate off, on manhattan_world(80, seed=2, closure_prob=0.3) as
tests/test_checkpoint.py replays it.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from aprilsam_tpu import checkpoint as jck
from aprilsam_tpu.datasets import manhattan_world as j_manhattan
from aprilsam_tpu.replay import Replay as JReplay
from aprilsam_tpu.solver import SolverConfig as JConfig

from aprilsam_tpu_torch import checkpoint as tck
from aprilsam_tpu_torch.datasets import manhattan_world
from aprilsam_tpu_torch.examples import graph_save_load, tutorial
from aprilsam_tpu_torch.graph import FactorGraph
from aprilsam_tpu_torch.replay import Replay
from aprilsam_tpu_torch.solver import SolverConfig

torch.set_num_threads(1)

SMALL = dict(node_capacity=256, factor_capacity=1024, row_block_capacity=48,
             panel_nodes=32, wallclock_gate=False)
GRAPH = dict(n_poses=80, seed=2, closure_prob=0.3)
SAVE_AT, END = 50, 80


def _replay(package, **cfg_kw):
    if package == "jax":
        return JReplay(j_manhattan(**GRAPH), JConfig(**{**SMALL, **cfg_kw}),
                       deferred=bool(cfg_kw))
    return Replay(manhattan_world(**GRAPH), SolverConfig(**{**SMALL, **cfg_kw}),
                  deferred=bool(cfg_kw), device="cpu")


def _drive(rep, n):
    return [rep.step() for _ in range(n)]


def _states(solver):
    st = solver.ds.state[:END]
    return st.numpy() if isinstance(st, torch.Tensor) else np.asarray(st)


def _resume(rep, solver, graph, event_idx):
    rep.solver, rep.graph, rep.event_idx = solver, graph, event_idx
    return rep


def test_solver_checkpoint_roundtrip(tmp_path):
    """Save mid-replay, resume, continue: the same trajectory to 1e-10."""
    rep = _replay("torch")
    _drive(rep, SAVE_AT)
    path = str(tmp_path / "solver.npz")
    tck.save_solver(rep.solver, path)
    snapshot = copy.deepcopy(rep.graph)
    chi_mid = rep.solver.chi2()

    resumed = tck.load_solver(path, device="cpu")
    assert abs(resumed.chi2() - chi_mid) < 1e-9
    assert getattr(resumed.sym, "pad_idx", None) is None
    rep2 = _resume(_replay("torch"), resumed, snapshot, rep.event_idx)
    steps = _drive(rep, END - SAVE_AT)
    steps2 = _drive(rep2, END - SAVE_AT)
    np.testing.assert_allclose(_states(rep.solver), _states(rep2.solver),
                               rtol=0, atol=1e-10)
    assert [s.path for s in steps] == [s.path for s in steps2]
    # the resumed solver planned through the native planner, which keeps
    # its padded mirror on the symbolic state
    assert not resumed.python_planner
    assert getattr(resumed.sym, "pad_idx", None) is not None
    assert resumed.sym.patterns_stale


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_checkpoint_across_packages(writer, reader, tmp_path):
    """A checkpoint written by one package resumes in the other and
    continues as the writer's own solver does: per-step chi2 within 1e-9
    relative, the same path per step, states within 1e-9."""
    save = {"jax": jck.save_solver, "torch": tck.save_solver}[writer]
    load = {"jax": jck.load_solver,
            "torch": lambda p: tck.load_solver(p, device="cpu")}[reader]
    src = _replay(writer)
    _drive(src, SAVE_AT)
    path = str(tmp_path / f"{writer}.npz")
    save(src.solver, path)
    want = _drive(src, END - SAVE_AT)

    dst = _replay(reader)
    _drive(dst, SAVE_AT)                 # the reader's own graph to SAVE_AT
    _resume(dst, load(path), dst.graph, dst.event_idx)
    got = _drive(dst, END - SAVE_AT)

    # per-step chi2 from the float64 metric ring (the JAX package returns
    # StepResult.chi2 through a float32 stats vector)
    chi_w = np.asarray(src.solver.chi2_history())
    chi_r = np.asarray(dst.solver.chi2_history())
    assert chi_w.shape == chi_r.shape == (END,)
    np.testing.assert_allclose(chi_r[SAVE_AT:], chi_w[SAVE_AT:], rtol=1e-9,
                               atol=0)
    assert [s.path for s in got] == [s.path for s in want]
    assert {"full", "fast"} <= {s.path for s in want}
    np.testing.assert_allclose(_states(dst.solver), _states(src.solver),
                               rtol=0, atol=1e-9)


CONFIGS = [
    {},
    {"dtype": np.float32, "gn_iters": 2, "batch_backend": "panel",
     "frontal_buckets": (8, 32), "superstep_size": 16,
     "superstep_buckets": (64, 640), "policy_lag": 3},
]


@pytest.mark.parametrize("kw", CONFIGS, ids=["defaults", "non-defaults"])
def test_cfg_dict_across_packages(kw):
    """_cfg_to_dict of one package is read by the other's _cfg_from_dict,
    both ways; the dicts are the same JSON, dtype a numpy dtype name."""
    t_cfg, j_cfg = SolverConfig(**kw), JConfig(**kw)
    t_dict, j_dict = tck._cfg_to_dict(t_cfg), jck._cfg_to_dict(j_cfg)
    assert json.dumps(t_dict) == json.dumps(j_dict)
    assert t_dict["dtype"] == np.dtype(kw.get("dtype", np.float64)).name
    back_t = tck._cfg_from_dict(json.loads(json.dumps(j_dict)))
    back_j = jck._cfg_from_dict(json.loads(json.dumps(t_dict)))
    assert back_t == t_cfg
    assert json.dumps(jck._cfg_to_dict(back_j)) == json.dumps(j_dict)
    assert [f.name for f in dataclasses.fields(SolverConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]


def _wait_each_jax_dispatch(solver):
    """The JAX package's lagged policy reads the newest ready stats; waiting
    on each dispatch makes that deterministic (as test_torch_bundles.py)."""
    dispatch = solver._dispatch_queue

    def waited():
        dispatch()
        jax.block_until_ready(solver.ds)
    solver._dispatch_queue = waited


def test_save_with_queued_bundle_slots(tmp_path):
    """bundle_size=8, policy_lag=8, saved while bundle slots are queued and
    policy stats pending: neither package dispatches the queue or applies
    the stats before saving, so both write the same file, whose device
    tables lack the queued steps while its symbolic state and counts hold
    them; resumed, both packages continue alike, and far from the
    uninterrupted replay (the queued steps' nodes and factors never reach
    the device tables)."""
    kw = dict(bundle_size=8, policy_lag=8)
    reps = {p: _replay(p, **kw) for p in ("jax", "torch")}
    _wait_each_jax_dispatch(reps["jax"].solver)
    for rep in reps.values():
        _drive(rep, SAVE_AT)
        assert rep.solver._queue and rep.solver._pending
    files = {}
    for p, save in (("jax", jck.save_solver), ("torch", tck.save_solver)):
        files[p] = str(tmp_path / f"{p}.npz")
        save(reps[p].solver, files[p])
    with np.load(files["jax"]) as a, np.load(files["torch"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if a[k].dtype.kind == "f":
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-10)
            elif k != "meta_json":
                np.testing.assert_array_equal(b[k], a[k])
        meta = json.loads(bytes(a["meta_json"]).decode())
        assert json.loads(bytes(b["meta_json"]).decode()) == meta
        queued = meta["factor_num"] - int(a["ds_n_xyt"]) - int(a["ds_n_pos"])
        assert queued > 0 and int(a["ds_nnodes"]) < meta["node_num"]

    snaps = {p: (copy.deepcopy(r.graph), r.event_idx) for p, r in reps.items()}
    for rep in reps.values():
        _drive(rep, END - SAVE_AT)
        rep.finish()
    resumed = {}
    for p, load in (("jax", jck.load_solver),
                    ("torch", lambda f: tck.load_solver(f, device="cpu"))):
        rep = _resume(_replay(p, **kw), load(files[p]), *snaps[p])
        if p == "jax":
            _wait_each_jax_dispatch(rep.solver)
        _drive(rep, END - SAVE_AT)
        rep.finish()
        resumed[p] = rep.solver
    np.testing.assert_allclose(_states(resumed["torch"]),
                               _states(resumed["jax"]), rtol=0, atol=1e-9)
    chi = {p: s.chi2() for p, s in resumed.items()}
    assert abs(chi["torch"] - chi["jax"]) <= 1e-9 * chi["jax"]
    assert chi["torch"] > 10 * reps["torch"].solver.chi2()


def test_describe_tree_matches_jax():
    """The same elimination-tree text, line for line, after a 60-step
    replay (and before any solve)."""
    text = {}
    for p in ("jax", "torch"):
        rep = _replay(p)
        empty = rep.solver.describe_tree()
        _drive(rep, 60)
        text[p] = (empty, rep.solver.describe_tree(),
                   rep.solver.describe_tree(max_nodes=200))
    assert text["torch"] == text["jax"]
    assert len(text["torch"][1].splitlines()) == 52
    assert "more" not in text["torch"][2]


def test_problem_checkpoint_roundtrip(tmp_path):
    g = manhattan_world(**GRAPH)
    path = str(tmp_path / "g.graph")
    tck.save_problem(g, path)
    g2 = tck.load_problem(path)
    assert isinstance(g2, FactorGraph)
    assert (g2.nnodes, g2.nfactors) == (g.nnodes, g.nfactors)
    np.testing.assert_array_equal(g2.fnodes[:g.nfactors], g.fnodes[:g.nfactors])
    assert abs(g2.chi2() - g.chi2()) <= 1e-12 * g.chi2()


def test_tutorial_example(capsys):
    """The tutorial example on the CPU ends at the reference's chi2 and
    y-ramp (tests/golden/tutorial.txt)."""
    tutorial.main(["--device", "cpu"])
    out = capsys.readouterr().out
    last = out.split("Step: 6")[1].splitlines()
    assert last[1] == "Chi squared error: 7.805041"
    ys = [float(line.split(",")[1]) for line in last[2:8]]
    np.testing.assert_allclose(ys, [0.0, 0.16, 0.32, 0.50, 0.67, 0.84],
                               atol=1e-12)


def test_graph_save_load_example(tmp_path, capsys):
    """The save/load example round-trips the graph, its attributes and
    its chi2, and solves the loaded problem."""
    path = tmp_path / "example.graph"
    graph_save_load.main([str(path), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"saved 2 nodes, 2 factors -> {path}"
    assert out[1] == "loaded 2 nodes, 2 factors"
    assert out[3] == "graph attrs: {'robot': 'wanderer-1', 'session': 42}"
    assert out[4] == "factor 0 tag: odom"
    g = tck.load_problem(str(path))
    assert out[5] == f"chi2: {g.chi2()}"
    assert out[6] == "solved on cpu: chi2 0.000000"
