"""The port's benchmark (aprilsam_tpu_torch/bench.py, the counterpart of
bench.py's worker) on the CPU, held against the JAX package's Replay of
the same config in float64, at a small size: manhattan_world(300, seed=0)
per step (SolverConfig(), wall-clock gate off) and in bench.py's
throughput config (S = 96, policy_lag=3, policy_poll=2).

Tolerances: the bench's final chi2 within relative 1e-9 of the JAX
package's, the census (per step) and the counters (S = 96) equal.  The
JAX package's lagged policy reads the newest ready stats, a race on its
asynchronous CPU backend; its superstep dispatches are waited for, so
that every due entry is ready, as the port's CPU stats always are
(tests/test_torch_large_inc.py does the same).

Also: the printed line parses, names the CPU and carries no device
metric; a golden off by more than the gate's tolerance makes the bench
exit 1; the gates of the 3500-pose cells pass the float64 replays and
fail float32 ones (the controls); the 4-card cell on four gloo ranks;
the two packages' top-level __all__ are equal.
"""

import dataclasses

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import aprilsam_tpu
import aprilsam_tpu_torch
from aprilsam_tpu.datasets import manhattan_world as j_manhattan
from aprilsam_tpu.replay import Replay as JReplay
from aprilsam_tpu.solver import SolverConfig as JConfig

from aprilsam_tpu_torch import bench
from aprilsam_tpu_torch.datasets import manhattan_world
from aprilsam_tpu_torch.replay import Replay

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSES = 300
PER_STEP = "manhattan3500-perstep-f64"
SUPER = "manhattan3500-super96-f64"
# figures only the card can give: none may appear in a CPU run's line
DEVICE_KEYS = {"metrics", "device_busy_ms", "idle_share", "device_events",
               "device_ms", "device_kernels", "top",
               "captures_by_generation", "tracing_overhead_s"}


def _jax_per_step():
    rep = JReplay(j_manhattan(POSES, seed=0),
                  JConfig(wallclock_gate=False, dtype=np.float64))
    res = rep.run()
    return [r.path for r in res], np.asarray(rep.solver.chi2_history())


def _jax_super96():
    cfg = bench.bench_config()
    kw = {f: getattr(cfg, f) for f in (
        "node_capacity", "factor_capacity", "row_block_capacity",
        "panel_nodes", "wallclock_gate", "policy_lag", "policy_poll",
        "superstep_size", "superstep_buckets", "log_chi2", "batch_backend")}
    rep = JReplay(j_manhattan(POSES, seed=0),
                  JConfig(dtype=np.float64, **kw), deferred=True)
    s = rep.solver
    dispatch = s._dispatch_superstep

    def waited():
        dispatch()
        jax.block_until_ready(s.ds)
    s._dispatch_superstep = waited
    while rep.step() is not None:
        pass
    s.flush(rep.graph)
    jax.block_until_ready(s.ds)
    return float(s.chi2()), dict(s.counters)


def _write_per_step(path, paths, chi2):
    with open(path, "w") as f:
        f.write(f"# manhattan_world({POSES}, seed=0), JAX package on the "
                "CPU, float64; columns: step path chi2_history\n")
        for k, (p, c) in enumerate(zip(paths, chi2)):
            f.write(f"{k} {p} {float(c)!r}\n")


def _write_super(path, final_chi2, counters):
    with open(path, "w") as f:
        f.write(f"# manhattan_world({POSES}, seed=0), JAX package on the "
                "CPU, float64\n")
        f.write("# bench " + json.dumps({"final_chi2": final_chi2,
                                         "counters": counters}) + "\n")


def _bench(capsys, *argv):
    """bench.main on the CPU; its exit code and its last line."""
    rc = bench.main(["--device", "cpu", "--poses", str(POSES), *argv])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class Goldens:
    """The JAX package's replays of the two configs, each made on first
    use and written in the cell's golden format under `dir`."""

    def __init__(self, d):
        self.dir = d
        self._per_step = self._super96 = None

    @property
    def per_step(self):
        if self._per_step is None:
            self._per_step = _jax_per_step()
            _write_per_step(self.dir / "per_step.txt", *self._per_step)
        return self._per_step

    @property
    def super96(self):
        if self._super96 is None:
            self._super96 = _jax_super96()
            _write_super(self.dir / "super96.txt", *self._super96)
        return self._super96


@pytest.fixture(scope="module")
def goldens(tmp_path_factory):
    return Goldens(tmp_path_factory.mktemp("goldens"))


@pytest.fixture(scope="module")
def per_step_line(goldens):
    """The per-step cell, with its traced run (host figures on the CPU)."""
    goldens.per_step
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench.main(["--device", "cpu", "--poses", str(POSES),
                         "--config", PER_STEP, "--golden",
                         str(goldens.dir / "per_step.txt")])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_per_step_bench_matches_jax(goldens, per_step_line):
    rc, line = per_step_line
    paths, chi2 = goldens.per_step
    assert rc == 0 and line["gate"]["ok"], line["gate"]
    run, = line["runs"]
    assert run["final_chi2"] == pytest.approx(float(chi2[-1]), rel=1e-9)
    want = {p: paths.count(p) for p in ("fast", "full", "batch")}
    assert run["held"]["census"] == want
    assert run["held"]["per_step_path_mismatches"] == 0
    assert run["poses"] == POSES
    # the traced run's host figures: one plan per incremental step, the
    # census's batch steps as host epochs, no K1 launch on the CPU
    layers = line["layers"]
    assert layers["host_plan_ms"]["calls"] == POSES - 1
    assert layers["epochs"]["host"]["epochs"] == want["batch"]
    assert layers["k1"]["launches"] == 0
    assert layers["final_chi2"] == pytest.approx(run["final_chi2"],
                                                 rel=1e-12)


def test_super96_bench_matches_jax(goldens, capsys):
    final, counters = goldens.super96
    rc, line = _bench(capsys, "--config", SUPER, "--golden",
                      str(goldens.dir / "super96.txt"), "--no_trace")
    assert rc == 0 and line["gate"]["ok"], line["gate"]
    run, = line["runs"]
    assert run["final_chi2"] == pytest.approx(final, rel=1e-9)
    for k, v in counters.items():
        assert run["counters"][k] == v, k
    assert "layers" not in line


def _keys(obj):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield k
            yield from _keys(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _keys(v)


def test_cpu_line_names_cpu_and_no_device_metric(per_step_line):
    _rc, line = per_step_line
    assert line["platform"] == "cpu" and line["card"] == "cpu"
    assert line["cell"] == PER_STEP and line["chips"] == 1
    assert not DEVICE_KEYS & set(_keys(line)), DEVICE_KEYS & set(_keys(line))
    assert line["layers"]["device"] == "not measured"
    m = line["cpu_metrics"]
    assert set(m) == {"poses_per_s", "step_ms_p50", "step_ms_p99"}
    for v in m.values():
        assert v["unit"].endswith("(cpu)") and v["samples"] == 1
        assert v["runs"] == [v["value"]] and v["quartiles"][1] == v["value"]
    assert m["step_ms_p99"]["samples_per_run"] == POSES
    assert m["poses_per_s"]["value"] == pytest.approx(
        line["runs"][0]["poses_per_s"])


def test_gate_off_golden_exits_nonzero(goldens, tmp_path):
    """A golden moved past the gate's tolerance (S = 96: relative 1e-9,
    the final chi2 scaled by 1 + 1e-8) fails the gate: the process exits
    1 with the line's gate not ok."""
    path = tmp_path / "off.txt"
    final, counters = goldens.super96
    _write_super(path, final * (1 + 1e-8), counters)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "aprilsam_tpu_torch.bench", "--config", SUPER,
         "--device", "cpu", "--poses", str(POSES), "--golden", str(path),
         "--no_trace"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 1, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert not line["gate"]["ok"] and line["gate"]["failures"]


@pytest.mark.parametrize("off", ["chi2", "path"])
def test_per_step_gate_rejects_off_golden(off, goldens):
    """The per-step gate (hold_per_step) on the JAX package's own replay
    passes against its golden and fails against one moved past the
    tolerance (every chi2 scaled by 1 + 1e-5, relative 1e-6) or with one
    step's path changed (the census)."""
    paths, chi2 = goldens.per_step
    assert bench.hold_per_step(chi2, paths, chi2, paths)["bad"] == []
    gold_chi2, gold_paths = chi2, list(paths)
    if off == "chi2":
        gold_chi2 = chi2 * (1 + 1e-5)
    else:
        k = gold_paths.index("full")
        gold_paths[k] = "fast"
    held = bench.hold_per_step(chi2, paths, gold_chi2, gold_paths)
    assert len(held["bad"]) == 1
    assert ("chi2 differs" if off == "chi2" else "census") in held["bad"][0]


def test_super96_gate_holds_the_counters(goldens, tmp_path):
    """The S = 96 gate fails a run whose final chi2 matches the golden's
    but whose counters (here the batch epochs) do not."""
    final, counters = goldens.super96
    path = tmp_path / "counters.txt"
    _write_super(path, final, dict(counters, batch=counters["batch"] + 1))
    args = bench.build_parser().parse_args(
        ["--config", SUPER, "--device", "cpu", "--golden", str(path)])
    ref = bench.reference(SUPER, args)
    run = {"final_chi2": final, "counters": dict(counters)}
    bad = bench.gate(SUPER, ref, run)
    assert len(bad) == 1 and bad[0].startswith("counter batch"), bad
    assert bench.gate(SUPER, dict(ref, counters=counters), run) == []


def _cell_ref(name):
    return bench.reference(name, bench.build_parser().parse_args(
        ["--config", name, "--device", "cpu"]))


def test_per_step_gate_rejects_float32_control():
    """The per-step cell's gate against the JAX package's float32 replay
    of its graph (golden/manhattan3500_seed0_f32.txt, same census): it
    fails, at steps where chi2 > 1 too, by more than 10x the bound."""
    paths, chi2 = bench.read_golden(os.path.join(
        bench.GOLDEN_DIR, "manhattan3500_seed0_f32.txt"))
    ref = _cell_ref(PER_STEP)
    run = {"final_chi2": float(chi2[-1]), "chi2_history": chi2,
           "paths": paths}
    bad = bench.gate(PER_STEP, ref, run)
    assert run["held"]["census"] == run["held"]["golden_census"]
    assert len(bad) == 1 and "chi2 differs" in bad[0], bad
    big = ref["chi2"] > 1.0
    rel = np.abs(chi2 - ref["chi2"])[big] / ref["chi2"][big]
    print(f"float32 control, per step: {bad[0]}; where chi2 > 1 the "
          f"largest relative difference {rel.max()!r} at "
          f"{int(np.sum(rel > ref['tol']))} steps past {ref['tol']}")
    assert rel.max() > 10 * ref["tol"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_super96_gate_float32_control(dtype):
    """The S = 96 cell's gate on the port's replay of its full graph
    (3500 poses, bench_config) on the CPU: float64 passes, float32 (the
    control) fails on its final chi2."""
    cfg = dataclasses.replace(bench.bench_config(),
                              dtype=getattr(np, dtype))
    rep = Replay(manhattan_world(3500, seed=0), cfg, deferred=True,
                 device="cpu")
    while rep.step() is not None:
        pass
    rep.solver.flush(rep.graph)
    run = {"final_chi2": rep.solver.chi2(),
           "counters": dict(rep.solver.counters)}
    ref = _cell_ref(SUPER)
    bad = bench.gate(SUPER, ref, run)
    rel = abs(run["final_chi2"] - ref["final_chi2"]) / ref["final_chi2"]
    print(f"{dtype}: final chi2 {run['final_chi2']!r}, relative {rel!r}")
    if dtype == "float64":
        assert bad == []
    else:
        assert len(bad) == 1 and bad[0].startswith("final chi2"), bad


def test_gate_needs_a_golden_for_another_graph(capsys):
    with pytest.raises(SystemExit, match="pass --golden"):
        bench.main(["--device", "cpu", "--poses", str(POSES), "--config",
                    PER_STEP])


def test_schur_cell_on_four_gloo_ranks(capsys):
    """The 4-card cell's path on four gloo ranks at a small size (2000
    poses in the cell's 64 blocks): every rank's states bit-identical,
    states and chi2 at D = 4 against D = 1's and chi2 against the host
    BatchSolver's (multicard.check), the iteration time and E(4) from the
    slowest rank, the stage table of each rank, no K1 launch."""
    from aprilsam_tpu_torch.multicard import BATCH_CHI2_REL, SOLVE_TOL

    rc = bench.main(["--device", "cpu", "--config",
                     "manhattan100k-schur-4card-f64", "--poses", "2000"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["gate"]["ok"], line["gate"]
    d = line["detail"]
    assert d["ranks"] == 4 and d["partition"]["nodes"] == 2000
    assert d["partition"]["nsl"] > 0 and d["ranks_identical"]
    assert d["chi2"]["rel"] <= SOLVE_TOL["float64"]["chi2_rel"]
    assert d["states_vs_one_rank"]["norm"] <= SOLVE_TOL["float64"]["states"]
    assert d["chi2"]["rel_vs_batch"] <= BATCH_CHI2_REL
    assert d["gn_iter_ms"]["D=4"] > 0 and 0 < d["E"]
    assert line["cpu_metrics"]["gn_iter_ms"]["value"] == pytest.approx(
        d["gn_iter_ms"]["D=4"])
    assert d["tri_inv_launches"] == 0
    rows = line["layers"]["D=4"]
    assert len(rows) == 4 and len(line["layers"]["D=1"]) == 1
    assert all(r["host_ms"]["interior Cholesky"] > 0 for r in rows)


def test_bench_config_is_the_super96_goldens():
    """bench_config is bench.py's float64 config, and the super96
    golden's bench entry ran it (the entry lists the fields it set)."""
    head, _ring, poses = bench.read_super_golden(
        os.path.join(bench.GOLDEN_DIR, "manhattan3500_seed0_super96.txt"))
    cfg = bench.bench_config()
    assert poses == 3500
    for k, v in head["bench"]["config"].items():
        got = getattr(cfg, k)
        assert (list(got) if isinstance(got, tuple) else got) == v, k
    assert (cfg.node_capacity, cfg.factor_capacity, cfg.row_block_capacity,
            cfg.panel_nodes, cfg.batch_backend) == (4096, 8192, 96, 128,
                                                    "auto")


def test_top_level_all_equal():
    assert aprilsam_tpu_torch.__all__ == aprilsam_tpu.__all__
    from aprilsam_tpu_torch import load_graph_file, save_graph_file
    assert callable(load_graph_file) and callable(save_graph_file)
