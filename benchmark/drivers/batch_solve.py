"""The batch-solve driver: whole maps solved at once by the port's
keyframe-block Schur solve (``parallel/schur.py:schur_solve``, with the
distributed separator Cholesky of ``parallel/pchol.py``) on the world's
ranks: one NCCL rank per card, or one rank on one card, or gloo ranks on
the CPU.

A pass is one batch solve of a whole generated map.  The map is loaded as
the program's ``FactorGraph`` from the dead-reckoned start (the
generator's `init`: a map solved for the first time), with the
configuration's prior; its clock (started after the harness's barrier)
covers the partition into the configuration's keyframe blocks
(``partition_graph``) and ``schur_solve``'s Gauss-Newton iterations, up
to the rank's card's finish: a user pays for both.  The harness takes
the slowest rank's seconds.

The configuration's `solve` holds the solve's settings: `blocks`,
`gn_iters`, `dtype`, `tikhonov`, `sep_dist` (true: the block-cyclic
distributed separator; false: replicated; null: the program's choice),
and `block_chunk`.  What the pass returns for the check is read off the
clock: the returned states, the chi2 the port computes of them
(``scaling.graph_chi2``) and the rank's digest of the states' bytes.

Set-up solves the first map for one Gauss-Newton iteration: every shape a
pass uses (each iteration has the same), the libraries' handles and the
group's first collectives.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from aprilsam_tpu_torch.parallel import make_mesh, schur
from aprilsam_tpu_torch.scaling import graph_chi2

from .replay import collect, loaded_graph, sync

# the harness makes a process group for this driver, even on one card
GROUP = True
# the faults (faults.py) that a batch solve can have
FAULTS = ("unchanged", "altered", "half_edges", "early_stop", "lost_rank")


class Driver:
    """One cell's batch solves on this rank: `config` and `workload` are
    the cell's files, `warm` the first pass's graph, `dtype` a replacement
    of the configuration's (the check's control).  The harness's group is
    made before."""

    def __init__(self, config: dict, workload: dict, device, warm: dict,
                 dtype: str = None):
        self.device = torch.device(device)
        self.mesh = make_mesh(None, self.device)
        self.prior = config["prior"]
        solve = config["solve"]
        self.blocks = int(solve["blocks"])
        self.gn_iters = int(solve["gn_iters"])
        self.settings = {"tikhonov": float(solve["tikhonov"]),
                         "dtype": np.dtype(dtype or solve["dtype"]).type,
                         "sep_dist": solve["sep_dist"],
                         "block_chunk": int(solve["block_chunk"])}
        g = self.build(warm)
        schur.schur_solve(self.mesh, g, schur.partition_graph(g, self.blocks),
                          gn_iters=1, **self.settings)
        sync(self.device)
        del g
        collect(self.device)

    def span_targets(self) -> list:
        """The host spans of a traced pass: the partition and the solve."""
        return [(schur, "partition_graph", "partition", None, None),
                (schur, "schur_solve", "solve", None, None)]

    def build(self, graph: dict):
        """The map as the program's graph: every pose at its dead-reckoned
        start, every edge, and the configuration's prior."""
        g = loaded_graph(graph)
        p = self.prior
        g.add_factor_xytpos(int(p["node"]), np.asarray(p["z"], np.float64),
                            np.asarray(p["W"], np.float64))
        return g

    def run_pass(self, g, checked=()) -> dict:
        """The partition and the solve of `g`, on the clock; the answer
        off it."""
        if checked:
            raise ValueError("a batch solve is read at its end alone")
        sync(self.device)
        t0 = time.perf_counter()
        part = schur.partition_graph(g, self.blocks)
        t1 = time.perf_counter()
        states = schur.schur_solve(self.mesh, g, part, gn_iters=self.gn_iters,
                                   **self.settings)
        sync(self.device)
        seconds = time.perf_counter() - t0
        n = g.nnodes
        digest = hashlib.sha256(np.ascontiguousarray(states).tobytes())
        return {"seconds": seconds, "poses": n,
                "answers": [{"step": n - 1, "chi2": graph_chi2(g, states),
                             "states": states, "end": True,
                             "digest": digest.hexdigest()}],
                "info": {"partition_s": t1 - t0, "separator_nodes": part.ns}}
