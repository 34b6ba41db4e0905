"""Pose-by-pose replay driver — the equivalent of the reference benchmark CLI
loop (reference: simulate_on_exist_graph / simulate_event,
examples/aprilsam_demo.c:119-234); counterpart of ``aprilsam_tpu/replay.py``.

Given a fully loaded dataset graph, replays it one pose at a time:
  * step 0: add node 0 plus the geopin prior W = diag(1e4, 1e4, 1e3) at the
    origin (aprilsam_demo.c:133-146), run a batch solve;
  * step k: add node k (state = loaded init), add every loaded factor whose
    maximum endpoint is k; for factors tagged "odom" seed the new node's
    state by composing the neighbor's current optimized state with the
    odometry measurement (aprilsam_demo.c:180-191);
  * optimize: incremental from step 1 on (batch when batch_update_only),
    then report chi2 and timing (aprilsam_demo.c:224-232).

Two execution modes:
  * synchronous (default): each step's chi2 comes back from the device, as
    the reference prints it step by step;
  * deferred (policy_lag > 0 or supersteps): no per-step wait for the
    device; update() returns None, the step's chi2 is NaN until finish()
    backfills it from the metric ring (per-step mode only: in superstep
    mode the ring holds one entry per superstep).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .graph import FactorGraph, FACTOR_XYT
from .geometry import np_xyt_inv, np_xyt_mul
from .solver import BatchSolver, SolverConfig
from .solver.incremental import IncrementalSolver, SeedSpec
from .utils import trace

GEOPIN_W = np.diag([10000.0, 10000.0, 1000.0])


@dataclass
class StepResult:
    step: int
    chi2: float
    step_ms: float
    total_ms: float
    path: str = ""        # fast | full | batch (solver path taken)
    naffected: int = 0    # tr->naffected equivalent for this step


class Replay:
    def __init__(
        self,
        loaded: FactorGraph,
        cfg: Optional[SolverConfig] = None,
        batch_update_only: bool = False,
        deferred: bool = False,
        device="cuda",
    ):
        self.loaded = loaded
        self.cfg = cfg or SolverConfig()
        self.batch_update_only = batch_update_only
        self.deferred = deferred and not batch_update_only
        self.graph = FactorGraph()
        self.event_idx = 0
        self.total_ms = 0.0
        self.results: List[StepResult] = []
        if self.cfg.show_timing:
            trace.enable()      # run(verbose=True) prints each step's spans

        # group loaded factors by their max endpoint (preserving file order,
        # aprilsam_demo.c:150-163), pre-sliced per step with the seed specs
        # (the reference also pre-groups its dataset before timing)
        by_max: List[List[int]] = [[] for _ in range(loaded.nnodes)]
        for f in range(loaded.nfactors):
            if loaded.ftype[f] != FACTOR_XYT:
                continue
            mx = int(max(loaded.fnodes[f]))
            if mx < loaded.nnodes:
                by_max[mx].append(f)
        self._events = []
        for fl in by_max:
            idx = np.asarray(fl, dtype=np.int64)
            ab = loaded.fnodes[idx] if len(fl) else np.zeros((0, 2), np.int32)
            z = loaded.fz[idx] if len(fl) else np.zeros((0, 3))
            W = loaded.fW[idx] if len(fl) else np.zeros((0, 3, 3))
            seeds: List[SeedSpec] = []
            for j, f in enumerate(fl):
                if self._factor_tag(f) != "odom":
                    continue
                a, b = int(ab[j, 0]), int(ab[j, 1])
                if a < b:
                    seeds.append(SeedSpec(src=a, dst=b, z=z[j], invert=False))
                else:
                    seeds.append(SeedSpec(src=b, dst=a, z=z[j], invert=True))
            self._events.append((ab, z, W, seeds))

        if batch_update_only:
            self.solver = BatchSolver(self.cfg, device=device)
        else:
            self.solver = IncrementalSolver(self.cfg, device=device)

    # ------------------------------------------------------------------

    def _factor_tag(self, f: int) -> str:
        attrs = self.loaded.factor_attrs.get(f)
        if attrs is not None:
            t = attrs.get("type")
            if t:
                return t
        a, b = self.loaded.fnodes[f]
        return "odom" if abs(int(a) - int(b)) == 1 else "scan"

    def _add_pose(self):
        """Add the next pose + its factors.  Returns the step's odometry seed
        specs, or None when the dataset is exhausted."""
        k = self.event_idx
        if k >= self.loaded.nnodes:
            return None
        g = self.graph
        init = self.loaded.init[k]
        truth = self.loaded.truth[k] if self.loaded.has_truth[k] else None
        g.add_node(init, init=init, truth=truth)
        self.event_idx += 1
        if k == 0:
            g.add_factor_xytpos(0, np.zeros(3), GEOPIN_W)
            return []
        ab, z, W, seeds = self._events[k]
        g.add_factors_xyt_bulk(ab, z, W)
        return seeds

    def _apply_seeds_host(self, seeds):
        """Batch mode composes seeds on the host from synced states."""
        g = self.graph
        for s in seeds:
            z = np_xyt_inv(s.z) if s.invert else s.z
            g.state[s.dst] = np_xyt_mul(g.state[s.src], z)
            g.l_point[s.dst] = g.state[s.dst]

    def step(self) -> Optional[StepResult]:
        trace.follow_profiler()
        with trace.span("step", step=self.event_idx):
            with trace.span("step.add_pose"):
                seeds = self._add_pose()
            if seeds is None:
                return None
            t0 = time.perf_counter()
            if self.batch_update_only:
                self._apply_seeds_host(seeds)
                info = self.solver.solve(self.graph)
            elif self.event_idx <= 1:
                # step 0 of incremental mode: batch (aprilsam_demo.c:224-228)
                info = self.solver.solve(self.graph)
            else:
                info = self.solver.update(self.graph, seeds=seeds)
            chi2 = info.chi2 if info is not None else math.nan
            ms = (time.perf_counter() - t0) * 1e3
            self.total_ms += ms
            if self.batch_update_only:
                self.solver.sync_states(self.graph)
            res = StepResult(
                step=self.event_idx - 1, chi2=chi2, step_ms=ms,
                total_ms=self.total_ms,
                path=getattr(self.solver, "last_path", "batch"),
                naffected=getattr(self.solver, "last_naffected", 0),
            )
            self.results.append(res)
            return res

    def run(self, max_steps: Optional[int] = None, verbose: bool = False):
        n = 0
        while max_steps is None or n < max_steps:
            res = self.step()
            if res is None:
                break
            if verbose:
                print(
                    f"Step: {res.step} / {self.loaded.nnodes}\n"
                    f"Chi squared error: {res.chi2:f} \n"
                    f"Step running time: {res.step_ms:.3f} ms, "
                    f"Total running time: {res.total_ms:.3f} ms"
                )
                if trace.ON:
                    print("\n".join(trace.lines(trace.collect())))
            n += 1
        self.finish()
        return self.results

    def finish(self):
        """End of replay: flush the solver's buffered steps and pending
        policy stats, and backfill any step chi2 it did not report from its
        metric ring."""
        if isinstance(self.solver, IncrementalSolver):
            self.solver.flush(self.graph)
            if self.cfg.superstep_size > 1:
                # the ring holds one entry per superstep, not per step
                return
            hist = self.solver.chi2_history()
            for r in self.results:
                if math.isnan(r.chi2) and r.step < len(hist):
                    r.chi2 = float(hist[r.step])


def replay_by_max_endpoint(loaded, solver, graph=FactorGraph, seed=SeedSpec,
                           first: int = 1, on_step=None) -> list:
    """Replay every factor of `loaded`, xytpos priors included, pose by
    pose into `solver` (tests/test_mixed_factors.py's loop): the factors
    grouped by their largest endpoint in file order, each odometry factor
    (|a - b| = 1) also a seed of its newer node, priors added as they
    arrive.  The first `first` poses are solved at once, then each further
    pose is an update; the solver is flushed at the end.  `graph` and
    `seed` are the live graph's and the seed's classes, so that another
    package's solver can replay the same input.  Returns one record per
    solve or update: the step (the newest pose), the path, the returned
    chi2 (NaN where the solver defers it) and the row block capacity after
    it, each also passed to `on_step` as it is made."""
    n = loaded.nnodes
    by_max = [[] for _ in range(n)]
    for f in range(loaded.nfactors):
        by_max[int(max(loaded.fnodes[f]))].append(f)
    live, out = graph(), []
    for k in range(n):
        live.add_node(loaded.init[k], init=loaded.init[k])
        seeds = []
        for f in by_max[k]:
            a, b = (int(v) for v in loaded.fnodes[f])
            if b < 0:
                live.add_factor_xytpos(a, loaded.fz[f], loaded.fW[f])
                continue
            if abs(a - b) == 1:
                seeds.append(seed(a, b, loaded.fz[f], False) if a < b
                             else seed(b, a, loaded.fz[f], True))
            live.add_factor_xyt(a, b, loaded.fz[f], loaded.fW[f])
        if k + 1 < first:
            continue
        info = (solver.solve(live) if k + 1 == first
                else solver.update(live, seeds=seeds))
        out.append({"step": k, "path": solver.last_path,
                    "chi2": math.nan if info is None else float(info.chi2),
                    "rows": int(solver.cfg.row_block_capacity)})
        if on_step is not None:
            on_step(out[-1])
    solver.flush(live)
    return out
