"""The per-layer metrics that read the program's own spans, on fixed
records (and None where there is nothing to read), and the merge of the
program's spans into the idle breakdown (benchmark/program_trace.py)."""

from __future__ import annotations

import numpy as np
import pytest

import benchmark.run as R
from benchmark import program_trace as PT
from benchmark import trace

MS = 1_000_000                 # ns


def program():
    """A pass of two steps: one replays a graph, one captures and runs an
    epoch; (name, start, end, parent, step) as collect() gives them."""
    recs = [
        ("step", 0, 10 * MS, -1, 1),
        ("graphs.dispatch", 1 * MS, 4 * MS, 0, 1),
        ("graphs.upload", 1 * MS, 2 * MS, 1, 1),
        ("graphs.replay", 2 * MS, 3 * MS, 1, 1),
        ("solver.stats_wait", 4 * MS, 6 * MS, 0, 1),
        ("step", 10 * MS, 30 * MS, -1, 2),
        ("graphs.dispatch", 11 * MS, 15 * MS, 5, 2),
        ("graphs.capture", 11 * MS, 15 * MS, 6, 2),
        ("epoch", 16 * MS, 28 * MS, 5, 2),
        ("epoch.symbolic", 16 * MS, 19 * MS, 8, 2),
        ("solver.stats_wait", 28 * MS, 29 * MS, 5, 2),
    ]
    spans = {"solver.stats_wait": {"ms": 3.0, "self_ms": 3.0, "calls": 2},
             "epoch.symbolic": {"ms": 3.0, "self_ms": 3.0, "calls": 1},
             "graphs.dispatch": {"ms": 7.0, "self_ms": 2.0, "calls": 2}}
    return {"spans": spans, "records": recs, "counters": {}}


def records(**kw):
    rec = {"poses": 2, "counters": {"batch": 2}, "program": program()}
    rec.update(kw)
    return rec


def read(name, rec):
    return R.load_file("layer_metrics", name).read(rec)


def test_program_span_readers():
    rec = records()
    assert read("stats_wait_ms_per_pose", rec) == pytest.approx(1.5)
    # the one replaying dispatch: 3 ms, its upload and launch included
    assert read("dispatch_ms_per_replay", rec) == pytest.approx(3.0)
    assert read("epoch_symbolic_ms", rec) == pytest.approx(1.5)


@pytest.mark.parametrize("program_", [
    None, {"spans": {}, "records": [], "counters": {}}])
def test_program_span_readers_find_nothing(program_):
    """No recorder (an older program) or no span: every reader gives
    None; a pass without replays or epochs likewise."""
    for name in ("stats_wait_ms_per_pose", "dispatch_ms_per_replay",
                 "epoch_symbolic_ms"):
        assert read(name, records(program=program_)) is None, name
    rec = records(counters={"batch": 0})
    rec["program"]["records"] = [r for r in rec["program"]["records"]
                                 if r[0] != "graphs.replay"]
    assert read("dispatch_ms_per_replay", rec) is None
    assert read("epoch_symbolic_ms", rec) is None


def test_reader_collects_from_the_recorder():
    """Where the harness stored no program record, the first reader
    collects the port's recorder once, for every reader."""
    from aprilsam_tpu_torch.utils import trace as program_

    program_.collect()
    program_.enable()
    try:
        with program_.span("step", step=0):
            with program_.span("solver.stats_wait"):
                pass
    finally:
        program_.disable()
    rec = {"poses": 4, "counters": {"batch": 0}}
    assert read("stats_wait_ms_per_pose", rec) >= 0
    assert rec["program"]["spans"]["solver.stats_wait"]["calls"] == 1
    assert read("epoch_symbolic_ms", rec) is None
    assert program_.collect()["records"] == []


def _idle(spans):
    bs = np.array([0, 50, 200], np.int64)
    be = np.array([10, 60, 210], np.int64)
    return dict(trace.idle_by_span(bs, be, (0, 300), spans, offset=0,
                                   n=100, other=PT.HARNESS_OTHER))


HARNESS = [("step, other host work", 0, 100, 0), ("planning", 12, 40, 1),
           ("step, other host work", 100, 290, 0)]


def test_merge_without_program_spans_keeps_the_attribution():
    assert PT.merged(HARNESS, []) == HARNESS
    assert _idle(PT.merged(HARNESS, [])) == _idle(HARNESS)


def test_merge_puts_program_spans_innermost():
    prog = [("step", 0, 100, -1, 0), ("solver.plan", 11, 45, 0, 0),
            ("step", 100, 290, -1, 1), ("epoch", 120, 280, 2, 1),
            ("epoch.symbolic", 120, 150, 3, 1)]
    m = PT.merged(HARNESS, prog)
    assert [r[3] for r in m[3:]] == [2, 3, 2, 3, 4]
    got = _idle(m)
    # gaps 10-50 (middle 30: solver.plan over planning), 60-200 (130:
    # epoch.symbolic), 210-300 (255: epoch; 290-300 beyond every span)
    assert got == {"solver.plan": pytest.approx(40e-9),
                   "epoch.symbolic": pytest.approx(140e-9),
                   "epoch": pytest.approx(90e-9)}
    cov = PT.coverage(sorted(got.items()), {"planning"})
    assert cov["share"] == 0.0
    cov = PT.coverage([["step", 1.0], [PT.HARNESS_OTHER, 1.0],
                       ["epoch", 2.0]], set())
    assert cov["share"] == pytest.approx(0.5)


def test_idle_split_by_the_innermost_span():
    prog = [("step", 0, 100, -1, 0), ("solver.plan", 11, 45, 0, 0),
            ("step", 100, 290, -1, 1), ("epoch", 120, 280, 2, 1),
            ("epoch.symbolic", 120, 150, 3, 1)]
    bs = np.array([0, 50, 200], np.int64)
    be = np.array([10, 60, 210], np.int64)
    got = dict(PT.idle_split(bs, be, (0, 300), PT.merged(HARNESS, prog),
                             offset=0))
    assert got == {"step": pytest.approx(76e-9),
                   "solver.plan": pytest.approx(34e-9),
                   "epoch.symbolic": pytest.approx(30e-9),
                   "epoch": pytest.approx(120e-9),
                   PT.HARNESS_OTHER: pytest.approx(10e-9)}
    # the harness's spans alone: planning 12-40 of the first gap
    got = dict(PT.idle_split(bs, be, (0, 300), HARNESS, offset=0))
    assert got["planning"] == pytest.approx(28e-9)
    assert sum(got.values()) == pytest.approx(270e-9)
    assert PT.idle_split(bs[:0], be[:0], (0, 300), [], 0) == [
        [PT.HARNESS_OTHER, pytest.approx(300e-9)]]


def test_agreement_of_program_and_harness_spans():
    rec = {"spans": {"planning": [10.0, 5], "host epoch": [30.0, 1],
                     "device epoch": [10.0, 1]},
           "capture_s": 0.5,
           "program": {"spans": {"solver.plan": {"ms": 10.5},
                                 "epoch": {"ms": 40.0},
                                 "graphs.capture_graph": {"ms": 495.0}}}}
    got = PT.agreement(rec)
    assert got["planning"][2] == pytest.approx(0.05)
    assert got["epochs"][2] == pytest.approx(0.0)
    assert got["capture_graph"][2] == pytest.approx(-0.01)


def test_clock_offset_is_the_least_lag():
    """Each marker starts on the card its launch's latency after its host
    stamp: the least lag is the offset nearest the truth."""
    stamps = [1_000, 5_000, 9_000]
    starts = [s + 700 + lat for s, lat in zip(stamps, (6, 2, 40))]
    assert PT.clock_offset(starts, stamps) == 702
