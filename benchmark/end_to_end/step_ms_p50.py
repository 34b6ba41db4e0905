"""The median step time in ms, over every step of every pass, each timed
by the host clock around Replay.step (at policy_lag 0 a step ends with
its stats read from the device)."""

import numpy as np


def read(run: dict) -> float:
    steps = np.concatenate([p["step_s"] for p in run["passes"]])
    return float(np.percentile(steps, 50)) * 1e3
