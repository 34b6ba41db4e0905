"""Each per-layer metric's arithmetic on synthetic records, the trace's
interval arithmetic, and K1's operations and bytes from its shapes."""

from __future__ import annotations

import numpy as np
import pytest

import benchmark.run as R
from benchmark import roofline, trace


def records(**kw):
    rec = {"poses": 100, "pass_s": 2.0, "window_s": 2.0, "busy_s": 0.5,
           "spans": {"planning": [30.0, 99], "host epoch": [40.0, 2],
                     "device epoch": [20.0, 1]},
           "counters": {"batch": 3}, "growths": [{"ms": 5.0}, {"ms": 7.0}],
           "captures": 4, "capture_s": 0.25,
           "k1_launches": [[32, 384, "float64", 10]], "k1_device_s": 1e-3,
           "device_kind": "NVIDIA H100 80GB HBM3",
           "untraced_step_s": [np.arange(1, 51) * 1e-3,
                               np.arange(51, 101) * 1e-3]}
    rec.update(kw)
    return rec


def read(name, rec):
    return R.load_file("layer_metrics", name).read(rec)


def test_per_layer_arithmetic():
    rec = records()
    assert read("plan_ms_per_pose", rec) == pytest.approx(0.3)
    assert read("epoch_ms.perstep", rec) == pytest.approx(20.0)
    assert read("epoch_ms.stream", rec) == pytest.approx(20.0)
    # 1 .. 100 ms over two passes: numpy's 99th percentile, 99.01 ms
    assert read("step_ms_p99.perstep", rec) == pytest.approx(99.01)
    assert read("capture_ms_per_pass", rec) == pytest.approx(250.0)
    assert read("growth_ms_per_pass", rec) == pytest.approx(12.0)
    assert read("device_busy_ms_per_pose", rec) == pytest.approx(5.0)
    assert read("idle_share", rec) == pytest.approx(75.0)
    ops, nbytes = roofline.tri_inv_work(32, 384, "float64")
    least = 10 * max(ops / 67e12, nbytes / 3.35e12)
    assert read("k1_roofline", rec) == pytest.approx(100 * least / 1e-3)


def test_nothing_to_read_gives_nothing():
    """A reader that finds nothing returns None: the metric is left out
    of the line, never reported as 0."""
    rec = records(spans={}, counters={"batch": 0}, growths=[], captures=0,
                  k1_launches=[], busy_s=0.0, device_kind="another card",
                  untraced_step_s=[])
    for name in ("plan_ms_per_pose", "epoch_ms.perstep", "epoch_ms.stream",
                 "step_ms_p99.perstep",
                 "capture_ms_per_pass", "growth_ms_per_pass",
                 "device_busy_ms_per_pose", "idle_share", "k1_roofline"):
        assert read(name, rec) is None, name


def _naive_tri_inv_ops(N):
    """Operations of an inverse by back-substitution, counted one by one:
    one division per entry of X, one multiply and one add per term."""
    ops = 0
    for j in range(N):
        for i in range(j, -1, -1):
            ops += 1 + 2 * (j - i)
    return ops


@pytest.mark.parametrize("N", [1, 2, 3, 7, 16])
def test_tri_inv_work(N):
    ops, nbytes = roofline.tri_inv_work(3, N, "float64")
    assert ops == 3 * _naive_tri_inv_ops(N)
    assert nbytes == 3 * (N * (N + 1) // 2 + N * N) * 8
    assert roofline.tri_inv_work(3, N, "float32")[1] == nbytes // 2


def test_least_seconds_bound():
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    assert roofline.least_seconds(67e12, 1, "float64", peaks) == (
        pytest.approx(1.0), "operations")
    assert roofline.least_seconds(1, 3.35e12, "float32", peaks) == (
        pytest.approx(1.0), "bytes")


def test_busy_union():
    s = np.array([0, 5, 2, 20], np.int64)
    d = np.array([3, 5, 2, 1], np.int64)
    bs, be = trace.busy_intervals(s, d)
    assert bs.tolist() == [0, 5, 20] and be.tolist() == [4, 10, 21]


def test_idle_by_innermost_span():
    bs = np.array([0, 50], np.int64)
    be = np.array([10, 60], np.int64)
    spans = [("step", 0, 100, 0), ("planning", 12, 40, 1)]
    got = dict(trace.idle_by_span(bs, be, (0, 100), spans, offset=0))
    # gaps 10-50 (middle 30: planning) and 60-100 (middle 80: step)
    assert got == {"planning": pytest.approx(40e-9),
                   "step": pytest.approx(40e-9)}


def test_spans_label_and_restore():
    class Cache:
        captures = 0

        def run(self, capture):
            self.captures += capture

    targets = [(Cache, "run", "dispatch", "capture",
                lambda a: a[0].captures)]
    orig = Cache.run
    c = Cache()
    with trace.Spans(targets) as spans:
        c.run(0)
        c.run(1)
    assert Cache.run is orig
    assert [r[0] for r in spans.records] == ["dispatch", "capture"]
    assert spans.totals["capture"][1] == 1
