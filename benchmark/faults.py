"""Faults planted in the program from outside, to show that the check
catches them (benchmark/tests/test_bench_check.py; control.py reads them
at a cell's own size on the card).  Each is a context manager that
patches the program while it is open:

  unchanged   a step that returns its state unchanged, inside the
              solver: every device step (per-step, superstep, sweep)
              drops its update and leaves each pose at its linearization
              point, and every batch epoch leaves the states and
              linearization points as it found them; a new pose still
              gets its odometry seed, and every chi2 the solver returns
              is that of the states it leaves;
  altered     an answer altered where it is produced: the states the
              solver hands out (sync_states) with one pose moved by MOVE.
              At a pass's end the states lie near a stationary point of
              chi2, where a move d changes it by about W d^2 / 2 (W 2500
              per m^2 on an odometry edge): a move of 1e-6 m read 2.7e-12
              to 2.9e-12 of chi2 at the tests' size (less at the cells'),
              under the check's limit of 1e-10, so the fault moves a pose
              by 1e-4 m;
  half_edges  half of the input left out: every second loop closure never
              reaches the solver.

A fault of chips' exchanges has no place here: every cell runs on one
card.
"""

from __future__ import annotations

import contextlib

import numpy as np

MOVE = 1e-4


@contextlib.contextmanager
def _patched(owner, attr, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def unchanged():
    from aprilsam_tpu_torch.solver import incremental as inc
    from aprilsam_tpu_torch.solver.batch import BatchInfo
    from aprilsam_tpu_torch.solver.state import state_chi2

    def drop(ds):
        ds.state.copy_(ds.l_point)

    # the step bodies call these two after their updates, before their
    # chi2 (the per-step and superstep bodies, captured in the solver's
    # graphs)
    def step_chi2(orig):
        def wrapped(ds, ctl, log_chi2):
            drop(ds)
            return orig(ds, ctl, log_chi2)
        return wrapped

    def superstep_stats(orig):
        def wrapped(ds, stats, ctl, log_chi2):
            drop(ds)
            return orig(ds, stats, ctl, log_chi2)
        return wrapped

    def sweep_body(orig):
        def wrapped(ds, *args):
            out = orig(ds, *args)
            drop(ds)
            return out
        return wrapped

    def epoch(orig):
        def wrapped(self, g, nn, nf, log_mode):
            before = (self.ds.state[:nn].clone(),
                      self.ds.l_point[:nn].clone())
            info = orig(self, g, nn, nf, log_mode)
            self.ds.state[:nn] = before[0]
            self.ds.l_point[:nn] = before[1]
            return BatchInfo(chi2=float(state_chi2(self.ds)), spd=info.spd,
                             n=info.n)
        return wrapped

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(inc, "_step_chi2", step_chi2))
    stack.enter_context(_patched(inc, "_superstep_stats", superstep_stats))
    stack.enter_context(_patched(inc, "sweep_body", sweep_body))
    stack.enter_context(_patched(inc.IncrementalSolver, "_epoch", epoch))
    return stack


def altered():
    from aprilsam_tpu_torch.solver.incremental import IncrementalSolver

    def make(orig):
        def sync_states(self, g):
            orig(self, g)
            g.state[g.nnodes - 1, 0] += MOVE
        return sync_states
    return _patched(IncrementalSolver, "sync_states", make)


def half_edges():
    from aprilsam_tpu_torch.graph import FactorGraph

    def make(orig):
        def bulk(self, ab, z, W):
            ab = np.asarray(ab)
            closure = np.abs(ab[:, 0] - ab[:, 1]) != 1
            keep = ~closure | (np.cumsum(closure) % 2 == 1)
            return orig(self, ab[keep], np.asarray(z)[keep],
                        np.asarray(W)[keep])
        return bulk
    return _patched(FactorGraph, "add_factors_xyt_bulk", make)


FAULTS = {"unchanged": unchanged, "altered": altered,
          "half_edges": half_edges}
