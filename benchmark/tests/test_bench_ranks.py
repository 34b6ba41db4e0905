"""Cells of several ranks (ranks.py) and the batch-solve driver, on the
CPU with gloo ranks, at the test's batch cell (cells/, 2000 poses in 16
blocks): judged correct on worlds of 1, 2 and 4 ranks, every rank's
states the same bytes; a traced run of several passes of a driver that
times no steps; its control (float32) and each fault the driver can have
fail; a rank that raises or stalls ends the run, non-zero and inside the
collective timeout, and leaves no process; ranks 1..N-1 write nothing on
standard output."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

import benchmark.run as R
from benchmark.control import read_seeds
from benchmark.tests.small import Args, batch_spec

BATCH_FAULTS = R.load_file("drivers", "batch_solve").FAULTS


@pytest.mark.parametrize("chips", [1, 2, 4])
def test_batch_cell_is_correct_on_ranks(chips):
    spec = batch_spec(chips)
    run = R.run_cell(Args(seed=3_100_000_007), spec, device="cpu")
    v = run["verdict"]
    assert v["correct"] and v["failed"] == 0, v["numbers"]
    # one answer a pass, its states' digest from every rank, all equal
    assert len(run["digests"]) == len(run["passes"]) == 1
    assert [len(d) for d in run["digests"]] == [chips]
    assert len(set(run["digests"][0])) == 1
    assert v["numbers"]["ranks_disagree"]["value"] == 0
    line = R.result_line(spec, run, False, "cpu")
    assert line["correct"] is True
    assert set(line["metrics"]) == {"poses_per_s", "setup_s"}
    assert line["attempted"] == 2000
    if chips > 1:
        assert len(line["device"]["memory_peak_bytes_by_rank"]) == chips
    else:
        assert "memory_peak_bytes_by_rank" not in line["device"]


def test_traced_run_of_several_batch_passes(monkeypatch):
    """A traced run whose window takes more than the traced pass, of a
    driver whose passes time no steps (no `step_s`): the traced pass (on
    the card, torch.profiler) stood in for by a plain one."""
    def traced(driver, rep, checked, world):
        res = driver.run_pass(rep, checked)
        res["seconds"] = 0.0             # so that the window goes on
        return res, {"poses": res["poses"], "pass_s": 0.0, "window_s": 1.0,
                     "busy_s": 0.5, "spans": {}, "k1_launches": [],
                     "k1_device_s": 0.0, "device_ops": [],
                     "idle_gaps": None}

    monkeypatch.setattr(R, "traced_pass", traced)
    spec = batch_spec(1)
    run = R.run_cell(Args(seed=3_100_000_011, seconds=1e-6, trace=1), spec,
                     device="cpu")
    assert len(run["passes"]) == 2 and run["verdict"]["correct"]
    assert run["records"]["untraced_step_s"] == [None]
    line = R.result_line(spec, run, True, "cpu")
    assert line["device"]["busy_s"] == 0.5
    assert line["device"]["window_s"] == 1.0


def test_batch_control_and_faults_fail():
    """In one world of two ranks: the float32 control, then each fault
    the batch driver can have, each fails a limit."""
    spec = batch_spec(2)
    got = {"float32": read_seeds(spec, [17], "cpu", dtype="float32")[0]}
    for fault in BATCH_FAULTS:
        got[fault] = read_seeds(spec, [18], "cpu", fault=fault)[0]
    failed = {k: [n for n, x in v["numbers"].items()
                  if x["value"] > x["limit"]] for k, v in got.items()}
    assert all(failed.values()), failed
    # the ones that only the optimum's test sees: the returned chi2 is
    # still that of the returned states
    for k in ("float32", "early_stop", "lost_rank", "unchanged"):
        assert "grad_rel" in failed[k] and "chi2_rel" not in failed[k], k


def test_ranks_disagree_counts_answers():
    from benchmark.check import judge
    from benchmark.gen.manhattan import generate

    spec = batch_spec(1)
    p = {k: v for k, v in spec["config"]["graph"].items()
         if k != "generator"}
    g = generate(seed=1, **dict(p, poses=300, closures=100))
    ans = {"graph": 0, "step": 299, "chi2": 1.0, "states": g["truth"],
           "end": True}
    limits = spec["workload"]["check"]["limits"]
    same = judge([g], spec["config"]["prior"],
                 [dict(ans, digests=["a", "a"])], limits,
                 reference_name="stationary")
    assert same["numbers"]["ranks_disagree"]["value"] == 0
    differ = judge([g], spec["config"]["prior"],
                   [dict(ans, digests=["a", "b"])] * 2, limits,
                   reference_name="stationary")
    assert differ["numbers"]["ranks_disagree"]["value"] == 2
    assert not differ["correct"]


FAILING = '''
import os
import time

from .batch_solve import FAULTS, GROUP, collect  # noqa: F401
from .batch_solve import Driver as Solve


class Driver(Solve):
    def run_pass(self, g, checked=()):
        print(f"rank {self.mesh.rank} says", flush=True)
        how = os.environ["BENCH_TEST_RANK"] if self.mesh.rank == 1 else ""
        if how == "raise":
            raise RuntimeError("planted on rank 1")
        if how == "stall":
            time.sleep(3600)
        return super().run_pass(g, checked)
'''

RUN = r'''
import sys
import benchmark.run as R
from benchmark.tests.small import Args, batch_spec
spec = batch_spec(int(sys.argv[1]))
spec["workload"].update(driver="batch_failing", collective_timeout_s=15)
args = Args(seed=5)
sys.exit(R.report(args, spec, R.run_cell(args, spec, device="cpu"), "",
                  "cpu"))
'''


def _in(tmp_path):
    """PIDs of the processes whose working directory is tmp_path."""
    pids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            if os.readlink(f"/proc/{pid}/cwd") == str(tmp_path):
                pids.append(int(pid))
        except OSError:
            pass
    return pids


def _world(tmp_path, how: str, chips: int = 2):
    shutil.copytree(os.path.join(R.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(R.ROOT, "BENCHMARK.json"), tmp_path)
    (tmp_path / "benchmark/drivers/batch_failing.py").write_text(FAILING)
    (tmp_path / "tmp").mkdir()
    env = dict(os.environ, PYTHONPATH=R.ROOT, BENCH_TEST_RANK=how,
               TMPDIR=str(tmp_path / "tmp"))
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", RUN, str(chips)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    return out, time.monotonic() - t


@pytest.mark.parametrize("how", ["raise", "stall"])
def test_failing_rank_ends_the_run(tmp_path, how):
    out, seconds = _world(tmp_path, how)
    assert out.returncode != 0
    assert not any(x.startswith("{") for x in out.stdout.splitlines())
    # start-up, set-up and the 15 s collective timeout, not the sleep
    assert seconds < 150
    assert not _in(tmp_path)
    if how == "raise":
        assert "planted on rank 1" in out.stderr
        assert "rank 1 of 2 exited with code 1" in out.stderr


def test_only_rank_zero_writes_stdout(tmp_path):
    out, _ = _world(tmp_path, "none", chips=4)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "rank 0 says" in out.stdout
    for r in (1, 2, 3):
        assert f"rank {r} says" not in out.stdout
        assert f"rank {r} says" in out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["count"] == 4
    assert len(line["device"]["memory_peak_bytes_by_rank"]) == 4
    assert list(line["check"]) == ["chi2_rel", "grad_rel", "truth_gap",
                                   "ranks_disagree", "nonfinite"]
    assert out.stderr.strip().splitlines()[-1].startswith(
        "check nonfinite 0 limit 0")
    assert not _in(tmp_path)
    assert not os.listdir(tmp_path / "tmp")


def test_entry_named_for_other_processes(monkeypatch):
    """A module run as a script (python3 -m benchmark.run) is __main__ in
    its own process: the other ranks import its entry by the module's
    spec."""
    import types

    from benchmark import ranks

    assert ranks.entry_name(R.run_rank) == "benchmark.run:run_rank"
    fake = types.ModuleType("__main__")
    fake.__spec__ = types.SimpleNamespace(name="benchmark.run")
    monkeypatch.setitem(sys.modules, "__main__", fake)

    def run_rank():
        pass
    run_rank.__module__, run_rank.__qualname__ = "__main__", "run_rank"
    assert ranks.entry_name(run_rank) == "benchmark.run:run_rank"
