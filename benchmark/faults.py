"""Faults planted in the program from outside, to show that the check
catches them (benchmark/tests/test_bench_check.py; control.py reads them
at a cell's own size on the card).  Each is a context manager that
patches the program while it is open; a driver names those it can have
(its FAULTS), and a world of several ranks opens the same on every rank:

  unchanged   a step that returns its state unchanged, inside the
              incremental solver: every device step (per-step, superstep,
              sweep) drops its update and leaves each pose at its
              linearization point, and every batch epoch leaves the
              states and linearization points as it found them; a new
              pose still gets its odometry seed, and every chi2 the solver
              returns is that of the states it leaves.  In a batch solve,
              schur_solve returns the states it was given (it still runs,
              so the ranks' collectives stay in step);
  altered     an answer altered where it is produced: the states the
              incremental solver hands out (sync_states), or those that
              schur_solve returns, with one pose moved by MOVE.
              At a pass's end the states lie near a stationary point of
              chi2, where a move d changes it by about W d^2 / 2 (W 2500
              per m^2 on an odometry edge): a move of 1e-6 m read 2.7e-12
              to 2.9e-12 of chi2 at the tests' size (less at the cells'),
              under the check's limit of 1e-10, so the fault moves a pose
              by 1e-4 m.  In a batch solve the port computes its chi2 of
              the moved states, and only grad_rel can see the move (a
              gradient of about 2 W d, 0.5, over the start's), where the
              sound solve reads below it;
  half_edges  half of the input left out: every second loop closure never
              reaches the solver;
  early_stop  a batch solve one Gauss-Newton iteration short of the
              configuration's (schur_solve called with gn_iters - 1);
  lost_rank   the exchange between ranks broken: the last rank's Schur
              complement and right-hand side left out of the separator's
              reduction (zeroed before schur.py's all-reduce or
              reduce-scatter of them; on one rank, all of the separator
              system).
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
    from aprilsam_tpu_torch.parallel import schur
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

    def schur_solve(orig):
        def wrapped(mesh, g, *args, **kw):
            orig(mesh, g, *args, **kw)
            return g.state[:g.nnodes].astype(np.float64)
        return wrapped

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(schur, "schur_solve", schur_solve))
    stack.enter_context(_patched(inc, "_step_chi2", step_chi2))
    stack.enter_context(_patched(inc, "_superstep_stats", superstep_stats))
    stack.enter_context(_patched(inc, "sweep_body", sweep_body))
    stack.enter_context(_patched(inc.IncrementalSolver, "_epoch", epoch))
    return stack


def altered():
    from aprilsam_tpu_torch.parallel import schur
    from aprilsam_tpu_torch.solver.incremental import IncrementalSolver

    def make(orig):
        def sync_states(self, g):
            orig(self, g)
            g.state[g.nnodes - 1, 0] += MOVE
        return sync_states

    def schur_solve(orig):
        def wrapped(*args, **kw):
            states = orig(*args, **kw)
            states[-1, 0] += MOVE
            return states
        return wrapped

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(IncrementalSolver, "sync_states", make))
    stack.enter_context(_patched(schur, "schur_solve", schur_solve))
    return stack


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


def early_stop():
    from aprilsam_tpu_torch.parallel import schur

    def make(orig):
        def solve(*args, gn_iters=2, **kw):
            return orig(*args, gn_iters=gn_iters - 1, **kw)
        return solve
    return _patched(schur, "schur_solve", make)


class _LastRankLost:
    """torch.distributed as schur.py calls it, with the last rank's part
    of every all-reduce and reduce-scatter zeroed before it is sent (the
    gathers pass)."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    def _lost(self, group) -> bool:
        return (self._real.get_rank(group)
                == self._real.get_world_size(group) - 1)

    def all_reduce(self, tensor, *args, group=None, **kw):
        if self._lost(group):
            tensor.zero_()
        return self._real.all_reduce(tensor, *args, group=group, **kw)

    def reduce_scatter_tensor(self, output, input, *args, group=None, **kw):
        if self._lost(group):
            input.zero_()
        return self._real.reduce_scatter_tensor(output, input, *args,
                                                group=group, **kw)


def lost_rank():
    from aprilsam_tpu_torch.parallel import schur

    return _patched(schur, "dist", _LastRankLost)


FAULTS = {"unchanged": unchanged, "altered": altered,
          "half_edges": half_edges, "early_stop": early_stop,
          "lost_rank": lost_rank}
