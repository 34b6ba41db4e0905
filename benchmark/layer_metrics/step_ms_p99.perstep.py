"""The 99th percentile of the step time in ms over every step of the
traced run's untraced passes (the profiler lengthens the traced pass's
steps), each step timed by the host clock around Replay.step.  Its tail
is the host batch epochs' steps, whose time follows the host's CPU."""

import numpy as np


def read(rec: dict):
    steps = [s for s in rec.get("untraced_step_s", ()) if s is not None]
    if not steps:
        return None
    return float(np.percentile(np.concatenate(steps), 99)) * 1e3
