"""The comparison that decides `correct`, driven as a run drives it (the
harness's set-up, passes and reads; only its look for a card skipped), at
sizes a CPU test run holds: the program as configured is correct; its
control, the program in float32, and each planted fault are not."""

from __future__ import annotations

import pytest

import benchmark.run as R
from benchmark.control import readings
from benchmark.tests.small import Args, small_spec

CELLS = ["m3500-perstep", "city10k-stream"]
REPLAY_FAULTS = R.load_file("drivers", "replay").FAULTS


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    spec = small_spec(cell)
    run = R.run_cell(Args(seed=3_000_000_019), spec, device="cpu")
    v = run["verdict"]
    assert v["correct"] and v["failed"] == 0
    # every checked step and the pass's end were judged
    steps = spec["workload"]["check"]["steps_per_pass"]
    assert len(v["answers"]) == steps + 1
    line = R.result_line(spec, run, False, "cpu")
    assert line["correct"] is True
    # the replay cells' check: posegraph's numbers, the workload's limits
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert {n: x["limit"] for n, x in line["check"].items()} == \
        spec["workload"]["check"]["limits"]
    assert list(line["check"]) == ["chi2_rel", "end_gap", "nonfinite"]


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_fails(cell):
    v = readings(small_spec(cell), 11, "cpu", dtype="float32")
    assert not v["correct"]
    assert v["numbers"]["chi2_rel"]["value"] > \
        v["numbers"]["chi2_rel"]["limit"]


@pytest.mark.parametrize("fault", sorted(REPLAY_FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_fails(cell, fault):
    assert not readings(small_spec(cell), 12, "cpu", fault=fault)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_dropped_update_fails_on_the_optimum(cell):
    """Updates dropped inside the solver, with every chi2 it returns that
    of the states it leaves: the returned chi2 still belongs to the
    returned states, and only the comparison with the optimum fails."""
    v = readings(small_spec(cell), 13, "cpu", fault="unchanged")
    n = v["numbers"]
    assert n["chi2_rel"]["value"] <= n["chi2_rel"]["limit"]
    assert n["end_gap"]["value"] > n["end_gap"]["limit"]


def test_deferred_pass_is_read_at_its_end_alone():
    """A mid-pass read of a superstep pass would dispatch and sweep inside
    the timed pass: the driver refuses it."""
    spec = small_spec("city10k-stream")
    wl = spec["workload"]
    assert wl["check"]["steps_per_pass"] == 0
    g = R.pass_graph(spec["config"], 5, 0)
    driver = R.load_file("drivers", wl["driver"]).Driver(
        spec["config"], dict(wl, warmup_poses=0), "cpu", g)
    with pytest.raises(ValueError):
        driver.run_pass(driver.build(g), checked=[10])


def test_nonfinite_answer_fails():
    from benchmark.check import judge
    from benchmark.gen.manhattan import generate

    spec = small_spec("m3500-perstep")
    p = {k: v for k, v in spec["config"]["graph"].items()
         if k != "generator"}
    g = generate(seed=1, **p)
    x = g["truth"][:50].copy()
    x[7, 1] = float("nan")
    v = judge([g], spec["config"]["prior"],
              [{"graph": 0, "step": 49, "chi2": 1.0, "states": x}],
              spec["workload"]["check"]["limits"])
    assert not v["correct"] and v["numbers"]["nonfinite"]["value"] == 1
