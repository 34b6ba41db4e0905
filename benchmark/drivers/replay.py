"""The replay driver: whole passes of a generated trajectory through the
program's ``Replay``, one pose per ``Replay.step``, in a closed loop (the
next pose goes in when the step returns).

A pass is the whole trajectory on a fresh solver.  Its clock starts at the
first pose handed to the constructed solver and stops after
``IncrementalSolver.flush`` and the device's finish.  Building the solver
(``Replay``), preparing it where the configuration says so (every step
signature and the batch epoch's ladder captured ahead), and freeing it
after the pass are what a user does once per session: they stay off the
clock, and the harness counts them as set-up for the first pass.

What the pass returns for the check is read off the clock: after the
pass, ``IncrementalSolver.chi2`` and the states of every pose; in the
per-step mode also, at the steps the harness asks for, the chi2 that
``Replay.step`` returned and the states of every pose the solver holds
then (a read that changes nothing the solver does next).  Where
``update`` defers its work (supersteps, a windowed sweep), a step returns
no answer, and a read mid-pass would have to dispatch the buffered steps
and sweep, changing the work the pass times: such a pass is read at its
end alone.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from aprilsam_tpu_torch.graph import FactorGraph
from aprilsam_tpu_torch.kernels import tri_inv
from aprilsam_tpu_torch.replay import Replay
from aprilsam_tpu_torch.solver import SolverConfig, host_batch, incremental
from aprilsam_tpu_torch.solver.batch import precompile_device_batch
from aprilsam_tpu_torch.solver.host_batch import precompile_expand
from aprilsam_tpu_torch.solver.incremental import IncrementalSolver
from aprilsam_tpu_torch.solver.panel_epoch import precompile_panel_epoch
from aprilsam_tpu_torch.utils.cache import GraphCache


# the faults (faults.py) that a replay can have
FAULTS = ("unchanged", "altered", "half_edges")


class _States:
    """What ``IncrementalSolver.sync_states`` writes into: the first
    `n` poses' states (a FactorGraph's fields of that name)."""

    def __init__(self, n: int):
        self.nnodes = n
        self.state = np.zeros((n, 3))
        self.l_point = np.zeros((n, 3))
        self.delta_X = np.zeros((n, 3))


def solver_config(solver: dict, dtype: str = None) -> SolverConfig:
    """The configuration file's solver settings as the program's
    SolverConfig (lists become tuples); `dtype` replaces the file's."""
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in solver.items()}
    kw["dtype"] = np.dtype(dtype or kw["dtype"]).type
    return SolverConfig(**kw)


def loaded_graph(graph: dict, upto: int = None) -> FactorGraph:
    """The generated arrays as the program's graph (the data set a replay
    reads): every pose's dead-reckoned and true state, every edge in
    order; the first `upto` poses only, where given."""
    n = len(graph["init"]) if upto is None else upto
    g = FactorGraph()
    for i in range(n):
        g.add_node(graph["init"][i], init=graph["init"][i],
                   truth=graph["truth"][i])
    keep = graph["b"] < n
    g.add_factors_xyt_bulk(np.stack([graph["a"][keep], graph["b"][keep]], 1),
                           graph["z"][keep], graph["W"][keep])
    return g


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def collect(device) -> None:
    """Free the last solver and its graphs, and the allocator's cache they
    held, so that every pass starts from the same process state."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Driver:
    """One cell's replays: `config` and `workload` are the cell's files,
    `warm` the first pass's graph (the warm-up replays its first poses),
    `dtype` a replacement of the configuration's (the check's control)."""

    def __init__(self, config: dict, workload: dict, device, warm: dict,
                 dtype: str = None):
        self.device = torch.device(device)
        self.config = config
        self.cfg = solver_config(config["solver"], dtype)
        # whether update() returns each step's chi2 (else it defers)
        self.per_step = self.cfg.superstep_size == 1 and \
            self.cfg.policy_lag == 0
        n = int(workload.get("warmup_poses", 0))
        if n:
            # library handles and first-use paths, on a throwaway solver
            rep = Replay(loaded_graph(warm, n), self.cfg, deferred=True,
                         device=self.device)
            self._prepare(rep.solver, n)
            rep.run()
            del rep
            collect(self.device)

    def _prepare(self, solver, nnodes: int) -> None:
        if not self.config.get("prepare"):
            return
        solver.precompile(nnodes=nnodes)
        ds, cfg, graphs = solver.ds, solver.cfg, solver.graphs
        if cfg.batch_backend in ("device", "panel"):
            precompile_device_batch(ds, cfg, nnodes, graphs)
            if cfg.batch_backend == "panel":
                precompile_panel_epoch(ds, cfg, nnodes, graphs)
        else:
            precompile_expand(ds, cfg, nnodes, graphs)
        sync(self.device)

    def span_targets(self) -> list:
        """The host spans of a traced pass (trace.Spans's targets): the
        step, planning, the epochs, the graph cache's dispatches (a
        capture where it captured) and the growths."""
        return [
            (Replay, "step", "step, other host work", None, None),
            (incremental, "plan_step", "planning", None, None),
            (host_batch, "host_batch_epoch", "host epoch", None, None),
            (incremental, "run_batch_epoch", "device epoch", None, None),
            (GraphCache, "run", "dispatch", "capture",
             lambda a: a[0].captures),
            (IncrementalSolver, "_maybe_grow_capacity", None, "growth",
             lambda a: len(a[0].growths)),
        ]

    def build(self, graph: dict) -> Replay:
        """A fresh solver for a pass over `graph`, prepared where the
        configuration says so."""
        rep = Replay(loaded_graph(graph), self.cfg, deferred=True,
                     device=self.device)
        self._prepare(rep.solver, rep.loaded.nnodes)
        return rep

    def run_pass(self, rep: Replay, checked=()) -> dict:
        """The whole trajectory through `rep`, on the clock; the answers
        at the steps in `checked` (per-step mode only) and at the end, off
        it.  Returns the pass's figures."""
        s = rep.solver
        poses = rep.loaded.nnodes
        checked = set(checked)
        if checked and not self.per_step:
            raise ValueError("a pass that defers its steps is read at its "
                             "end alone")
        g = s.graphs
        captured = (g.captures, sum(v["seconds"] for v in
                                    g.by_generation.values()))
        tri_inv.reset_launches()
        step_s, answers, off = [], [], 0.0
        sync(self.device)
        t0 = time.perf_counter()
        for k in range(poses):
            t = time.perf_counter()
            res = rep.step()
            step_s.append(time.perf_counter() - t)
            if k in checked:
                t = time.perf_counter()
                held = _States(k + 1)
                s.sync_states(held)
                answers.append({"step": k, "chi2": res.chi2,
                                "states": held.state})
                off += time.perf_counter() - t
        s.flush(rep.graph)
        sync(self.device)
        seconds = time.perf_counter() - t0 - off
        held = _States(poses)
        s.sync_states(held)
        answers.append({"step": poses - 1, "chi2": s.chi2(),
                        "states": held.state, "end": True})
        return {
            "seconds": seconds, "poses": poses,
            "step_s": step_s if self.per_step else None,
            "answers": answers, "counters": dict(s.counters),
            "growths": list(s.growths),
            "captures": g.captures - captured[0],
            "capture_s": sum(v["seconds"] for v in g.by_generation.values())
            - captured[1],
            "k1_launches": [[B, N, dt, c] for (B, N, dt), c in
                            sorted(tri_inv.launches_by_shape.items())]}
