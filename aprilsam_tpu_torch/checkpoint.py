"""Checkpoint / resume.

Counterpart of ``aprilsam_tpu/checkpoint.py``.  The reference's checkpoint
is the stype graph serialization, a complete snapshot of the problem with
the solver state rebuilt by a batch step on resume (april_graph_save /
april_graph_create_from_file, april_graph.c:377-426).  Two kinds here:

  * problem checkpoints: the reference-compatible binary `.graph` format
    (io/stype.py);
  * solver checkpoints: every DeviceState field plus the host symbolic
    state in an .npz, so an incremental session resumes exactly, with no
    batch replay.  The layout is the JAX package's (keys ``ds_<field>`` with
    its dtypes, ``sym_*``, ``meta_json``): a file written by either package
    loads into the other.

As in the JAX package, a save neither dispatches queued bundle slots or a
buffered superstep nor applies lagged policy stats: call it between
synchronous steps, or after flush().
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from .io import load_graph_file, save_graph_file
from .solver.config import SolverConfig
from .solver.incremental import IncrementalSolver, sym_patterns_list
from .solver.state import (FIELDS, state_from_numpy, state_to_numpy,
                           symbolic_from_numpy)

save_problem = save_graph_file
load_problem = load_graph_file


def _cfg_to_dict(cfg: SolverConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = np.dtype(cfg.dtype).name
    d["frontal_buckets"] = list(cfg.frontal_buckets)
    return d


def _cfg_from_dict(d: dict) -> SolverConfig:
    d = dict(d)
    d["dtype"] = np.dtype(d["dtype"])
    d["frontal_buckets"] = tuple(d["frontal_buckets"])
    if d.get("superstep_buckets") is not None:
        d["superstep_buckets"] = tuple(d["superstep_buckets"])
    return SolverConfig(**d)


def save_solver(solver: IncrementalSolver, path: str) -> None:
    """Snapshot the full solver (device state, host symbolic state, the
    policy's counters) to `path`."""
    arrays = {f"ds_{k}": v for k, v in state_to_numpy(solver.ds).items()}
    sym = solver.sym
    meta = {
        "factor_num": solver.factor_num,
        "node_num": solver.node_num,
        "batch_time_ms": solver.batch_time_ms,
        "has_sym": sym is not None,
        "cfg": _cfg_to_dict(solver.cfg),
    }
    if sym is not None:
        patterns = sym_patterns_list(sym)  # the native planner edits the pads
        arrays["sym_order"] = sym.order
        arrays["sym_pos"] = sym.pos
        arrays["sym_parents"] = sym.parents
        arrays["sym_pattern_flat"] = (np.concatenate(patterns) if patterns
                                      else np.zeros(0, np.int32))
        arrays["sym_pattern_lens"] = np.asarray([len(p) for p in patterns],
                                                dtype=np.int32)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_solver(path: str, device="cuda") -> IncrementalSolver:
    """A solver restored from a checkpoint of either package, on `device`.
    The native planner's padded mirror is not in the file: the first
    incremental step rebuilds it from the patterns."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
        solver = IncrementalSolver(_cfg_from_dict(meta["cfg"]), device=device)
        solver.ds = state_from_numpy(
            {name: data[f"ds_{name}"] for name in FIELDS}, solver.device,
            solver.cfg.torch_dtype)
        solver.factor_num = meta["factor_num"]
        solver.node_num = meta["node_num"]
        solver.batch_time_ms = meta["batch_time_ms"]
        solver._ingested_nodes = meta["node_num"]
        solver._ingested_factors = meta["factor_num"]
        if meta["has_sym"]:
            ends = np.cumsum(data["sym_pattern_lens"])
            solver.sym = symbolic_from_numpy({
                "order": data["sym_order"], "pos": data["sym_pos"],
                "parents": data["sym_parents"],
                "patterns": np.split(data["sym_pattern_flat"], ends)[:-1]})
    return solver


__all__ = ["load_problem", "load_solver", "save_problem", "save_solver"]
