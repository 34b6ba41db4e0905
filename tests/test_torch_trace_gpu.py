"""On the card: the port's spans (utils/trace.py) share the device trace's
clock.  A span around a sleep kernel and its synchronize, placed on the
device clock by marker kernels as benchmark/program_trace.py places a
traced pass (a launch before them, the least lag of five markers behind
their host stamps), holds the kernel, and ends within 50 µs of the
kernel's end.  The test prints how far the session's first launch, as a
lone marker, would have placed it.

Needs an NVIDIA card; carries the `gpu` marker and skips without one.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -s \
        tests/test_torch_trace_gpu.py
"""

import pytest
import torch

from aprilsam_tpu_torch.utils import trace

SLEEP_CYCLES = 2_000_000      # about 1 ms at the H100's clock


@pytest.mark.gpu
def test_span_lies_on_the_device_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import program_trace as tool
    from benchmark import trace as bench

    torch.cuda._sleep(1000)                     # first launch, off the clock
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    trace.collect()
    trace.enable()
    try:
        with prof:
            first = tool.marks(torch, 1)        # the session's first launch
            stamps = tool.marks(torch)
            with trace.span("sleep"):
                torch.cuda._sleep(SLEEP_CYCLES)
                torch.cuda.synchronize()
    finally:
        got = trace.collect()
        trace.disable()
    names, starts, durs = bench.device_records(prof)
    sleeps = [(s, s + d) for n, s, d in zip(names, starts.tolist(),
                                            durs.tolist())
              if bench.MARKER in n]
    assert len(sleeps) == 2 + tool.MARKS, sleeps
    lone = sleeps[0][0] - first[0]
    offset = tool.clock_offset([s for s, _e in sleeps[1:-1]], stamps)
    k0, k1 = sleeps[-1]
    [(name, t0, t1, _parent, _step)] = got["records"]
    s0, s1 = t0 + offset, t1 + offset
    print(f"offset by the session's first launch {(lone - offset) / 1e3:.1f}"
          f" µs more; span {(s1 - s0) / 1e3:.1f} µs, kernel "
          f"{(k1 - k0) / 1e3:.1f} µs; kernel start {(k0 - s0) / 1e3:.1f} µs "
          f"after the span's, its end {(s1 - k1) / 1e3:.1f} µs before the "
          f"span's")
    assert s0 <= k0 and k1 <= s1
    assert s1 - k1 < 50_000
