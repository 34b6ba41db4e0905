"""The port's span recorder (aprilsam_tpu_torch/utils/trace.py) on the CPU:
off, it records nothing and hands out one shared no-op; on, its spans nest
by parent, carry the step that opened them and give self times; in a
replay (per step and in supersteps, eager dispatches) every span lies
inside its parent and the spans count what the solver counts; without
enable() it records while torch.profiler runs; recording changes no
answer; the CLI's --show_timing prints the spans; and the
disabled spans of a step cost under 5 µs."""

import timeit

import numpy as np
import pytest
import torch

from aprilsam_tpu_torch import cli
from aprilsam_tpu_torch.datasets import manhattan_world
from aprilsam_tpu_torch.io import save_graph_file
from aprilsam_tpu_torch.replay import Replay
from aprilsam_tpu_torch.solver import SolverConfig
from aprilsam_tpu_torch.utils import trace

torch.set_num_threads(1)

POSES = 60
SMALL = dict(node_capacity=128, factor_capacity=512, row_block_capacity=64,
             panel_nodes=32, wallclock_gate=False, dtype=np.float64)
CONFIGS = {
    "per-step": dict(),
    "superstep": dict(superstep_size=8, policy_lag=0, policy_poll=2,
                      log_chi2=False, batch_backend="panel",
                      sweep_window_panels=2, sweep_full_every=4),
}


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    trace.disable()
    trace.collect()
    yield
    trace.disable()
    trace.collect()


def _replay(cfg_kw, record: bool):
    rep = Replay(manhattan_world(POSES, seed=0),
                 SolverConfig(**SMALL, **cfg_kw), device="cpu")
    if record:
        trace.enable()
    for _ in range(POSES):
        rep.step()
    rep.finish()
    got = trace.collect(rep.solver)
    trace.disable()
    return rep, got


class _NoClock:
    @staticmethod
    def perf_counter_ns():
        raise AssertionError("a disabled span read the clock")


def test_disabled_records_nothing(monkeypatch):
    assert not trace.ON
    assert trace.span("step", step=0) is trace.NOOP
    assert trace.span("solver.plan") is trace.NOOP
    monkeypatch.setattr(trace, "time", _NoClock)
    _step_spans(0)                    # no profiler session runs
    assert not trace.ON
    assert trace.collect() == {"spans": {}, "records": [], "counters": {}}
    with pytest.raises(KeyError):     # an exception passes a disabled span
        with trace.span("step", step=1):
            raise KeyError("x")


def test_nesting_parents_steps_and_self_times():
    trace.enable()
    with trace.span("step", step=3):
        with trace.span("a"):
            sum(range(20000))
        with trace.span("b"):
            with trace.span("c"):
                sum(range(20000))
            trace.count("n", 2)
    with trace.span("step", step=4):
        with trace.span("a"):
            trace.count("n")
    got = trace.collect()
    recs = got["records"]
    assert [r[0] for r in recs] == ["step", "a", "b", "c", "step", "a"]
    assert [r[3] for r in recs] == [-1, 0, 0, 2, -1, 4]
    assert [r[4] for r in recs] == [3, 3, 3, 3, 4, 4]
    assert got["counters"] == {"n": 3}
    dur = [(t1 - t0) / 1e6 for _n, t0, t1, _p, _s in recs]
    sp = got["spans"]
    assert sp["step"]["calls"] == 2 and sp["a"]["calls"] == 2
    assert sp["step"]["ms"] == pytest.approx(dur[0] + dur[4])
    assert sp["step"]["self_ms"] == pytest.approx(
        dur[0] - dur[1] - dur[2] + dur[4] - dur[5])
    assert sp["b"]["self_ms"] == pytest.approx(dur[2] - dur[3])
    assert sp["c"]["self_ms"] == pytest.approx(sp["c"]["ms"])
    assert all(s["self_ms"] >= 0 for s in sp.values())
    # collect() started anew
    assert trace.collect()["records"] == []


def test_recording_follows_the_profiler():
    """Without enable(), a replay's steps record while a torch.profiler
    session runs; the first span after the session turns recording off."""
    rep = Replay(manhattan_world(20, seed=0), SolverConfig(**SMALL),
                 device="cpu")
    rep.step()
    assert not trace.ON
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(5):
            rep.step()
    assert trace.ON
    assert trace.span("solver.flush") is trace.NOOP
    assert not trace.ON
    rep.step()
    got = trace.collect()
    assert [r[4] for r in got["records"] if r[0] == "step"] == [1, 2, 3, 4,
                                                                  5]
    assert got["spans"]["solver.plan"]["calls"] == 5


def test_a_new_profiled_stretch_drops_what_nothing_collected():
    """Steps profiled after unprofiled ones start the records anew, so
    that what is held is one profiled stretch's."""
    rep = Replay(manhattan_world(20, seed=0), SolverConfig(**SMALL),
                 device="cpu")
    for k in (2, 3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(k):
                rep.step()
        rep.step()
    got = trace.collect()
    assert [r[4] for r in got["records"] if r[0] == "step"] == [3, 4, 5]


def test_lines_print_spans_and_counters():
    got = {"records": [("step", 0, 4_000_000, -1, 0),
                       ("solver.stats_wait", 1_000_000, 3_000_000, 0, 0)],
           "spans": {"step": {"ms": 4.0, "self_ms": 2.0, "calls": 1},
                     "solver.stats_wait": {"ms": 2.0, "self_ms": 2.0,
                                           "calls": 1}},
           "counters": {"stats.waits": 1, "graphs.upload_bytes": 4096}}
    out = trace.lines(got)
    assert out[0].split() == ["step", "4.000", "ms", "2.000", "ms", "self"]
    assert out[1].split()[0] == "solver.stats_wait"
    assert out[2].split() == ["graphs.upload_bytes", "4096"]
    assert out[3].split() == ["stats.waits", "1", "of", "1", "stats",
                              "reads", "waited"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_replay_spans_nest_and_count(name):
    rep, got = _replay(CONFIGS[name], record=True)
    recs, sp, c = got["records"], got["spans"], got["counters"]
    for name_, t0, t1, parent, step in recs:
        assert 0 < t0 <= t1, name_
        if parent >= 0:
            p = recs[parent]
            assert p[1] <= t0 and t1 <= p[2], (name_, p[0])
            assert step == p[4], (name_, p[0])
        else:
            assert name_ in ("step", "solver.flush"), name_
    assert [r[4] for r in recs if r[0] == "step"] == list(range(POSES))
    assert sp["step"]["calls"] == POSES
    assert sp["epoch"]["calls"] == c["solver.batch"] >= 1
    assert sp["solver.flush"]["calls"] == 1
    if name == "per-step":
        assert sp["solver.plan"]["calls"] == (c["solver.fast"]
                                              + c["solver.full"])
        assert (sp["solver.stats_wait"]["calls"]
                == sp["solver.plan"]["calls"])
    else:
        assert sp["solver.plan"]["calls"] == (c["solver.superstep"]
                                              + c["solver.sup_overflow"])
    # the CPU dispatches eagerly: each uploads, none replays or captures
    assert sp["graphs.upload"]["calls"] == sp["graphs.dispatch"]["calls"]
    assert "graphs.replay" not in sp and "graphs.capture" not in sp
    assert c["graphs.calls"] == c["graphs.replayed"] == 0
    assert "graphs.upload_bytes" not in c     # nothing goes to a card


@pytest.mark.parametrize("name", list(CONFIGS))
def test_recording_changes_no_answer(name):
    off, _ = _replay(CONFIGS[name], record=False)
    on, got = _replay(CONFIGS[name], record=True)
    assert got["records"]
    np.testing.assert_array_equal(on.solver.chi2_history(),
                                  off.solver.chi2_history())
    np.testing.assert_array_equal(on.solver.ds.state.numpy(),
                                  off.solver.ds.state.numpy())
    assert on.solver.chi2() == off.solver.chi2()
    assert on.solver.counters == off.solver.counters


def test_cli_show_timing_prints_spans(tmp_path, capsys):
    path = str(tmp_path / "m40.graph")
    save_graph_file(manhattan_world(40, seed=0), path)
    assert cli.main(["--graphpath", path, "--device", "cpu",
                     "--no_wallclock_gate", "--max_steps", "30",
                     "--show_timing"]) == 0
    out = capsys.readouterr().out
    for name in ("step", "step.add_pose", "epoch", "epoch.symbolic",
                 "solver.plan", "solver.inputs", "graphs.dispatch",
                 "graphs.upload", "solver.stats_wait", "solver.policy"):
        assert f"   {name} " in out, name
    assert "ms self" in out


def _step_spans(k):
    """The spans and counts of one per-step step on the card."""
    trace.follow_profiler()
    with trace.span("step", step=k):
        with trace.span("step.add_pose"):
            pass
        with trace.span("solver.plan"):
            pass
        with trace.span("solver.inputs"):
            pass
        with trace.span("graphs.dispatch"):
            with trace.span("graphs.upload"):
                trace.count("graphs.upload_bytes", 4096)
            with trace.span("graphs.replay"):
                pass
        trace.count("stats.waits")
        with trace.span("solver.stats_wait"):
            pass
        with trace.span("solver.policy"):
            pass


def test_disabled_step_costs_under_5us():
    """The microbenchmark of the disabled recorder: a step's nine spans,
    two counts and the profiler check; the least of 100 repeats of 200
    steps, so that one repeat fits between two preemptions of a loaded
    host."""
    n = 200
    best = min(timeit.repeat(lambda: [_step_spans(k) for k in range(n)],
                             number=1, repeat=100)) / n
    assert best < 5e-6, f"{best * 1e6:.3f} µs a step"
    assert trace.collect()["records"] == []
