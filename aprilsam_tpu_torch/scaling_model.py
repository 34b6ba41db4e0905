"""Communication-volume model of the distributed Schur solve: the
counterpart of ``scaling_model.py`` on PyTorch.

Runs one Gauss-Newton step of ``parallel/schur.py:schur_solve`` in float32
on the ``meta`` device (shapes only: no memory on any device, no process
group, so 100k-pose shapes cost nothing) as one rank of a mesh of `ndev`
ranks, with the collectives of ``parallel/schur.py`` and
``parallel/pchol.py`` replaced by a recorder for the length of the call,
as the JAX script swaps ``jax.jit``.  Each collective is recorded with its
kind and the bytes of its input (what the JAX script counts as a
primitive's invars: the local shard for an all-gather, the whole operand
for a reduce-scatter or an all-reduce).  The step stops at its last
collective, the all-gather of the interiors, as the JAX script stops at
its ``_Stop``.

The port moves what the JAX package moves, apart from two things:
  * the interiors' all-gather [B/D, ni_max, 3]: the JAX package returns
    the interiors sharded and gathers them outside its jaxpr, so its walk
    does not see that gather; it is listed apart here ("interiors");
  * one more element in each all-reduced flat vector of the separator
    system: the sentinel slot that takes the padding.

    python -m aprilsam_tpu_torch.scaling_model [--poses 100000]
        [--closure_prob 0.02]

prints one JSON row per (ndev, separator mode) for ndev 2, 4 and 8.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from collections import defaultdict

import numpy as np
import torch

NDEVS = (2, 4, 8)


class _Stop(Exception):
    """Raised by the interiors' all-gather: the step's last collective."""


@dataclasses.dataclass(frozen=True)
class MetaMesh:
    """A stand-in for parallel.dist.Mesh: rank `rank` of `size` ranks on
    the meta device, with no process group behind it."""

    size: int
    rank: int = 0
    device: torch.device = torch.device("meta")
    group: None = None


class _Recorder:
    """Stands in for torch.distributed inside one module of parallel/:
    adds each collective's count and input bytes to `hits` by kind, and
    where `real` is torch.distributed, runs the collective too."""

    def __init__(self, hits, gather_kind: str = "all-gather",
                 stop_at_gather: bool = False, real=None):
        self.hits = hits
        self.gather_kind = gather_kind
        self.stop_at_gather = stop_at_gather
        self.real = real

    def _add(self, kind: str, t: torch.Tensor) -> None:
        self.hits[kind][0] += 1
        self.hits[kind][1] += t.numel() * t.element_size()

    def all_reduce(self, tensor, group=None):
        self._add("all-reduce", tensor)
        if self.real is not None:
            self.real.all_reduce(tensor, group=group)

    def reduce_scatter_tensor(self, output, input, group=None):
        self._add("reduce-scatter", input)
        if self.real is not None:
            self.real.reduce_scatter_tensor(output, input, group=group)

    def all_gather_into_tensor(self, output, input, group=None):
        self._add(self.gather_kind, input)
        if self.stop_at_gather:
            raise _Stop
        if self.real is not None:
            self.real.all_gather_into_tensor(output, input, group=group)


@contextlib.contextmanager
def _recording(**kw):
    """{kind: [count, bytes]} of the collectives that parallel/schur.py
    and parallel/pchol.py issue inside the block, their `dist` swapped for
    recorders (schur.py's only all-gather is the interiors', kind
    "interiors"; pchol.py's are the separator's)."""
    from .parallel import pchol, schur

    hits = defaultdict(lambda: [0, 0])
    saved = schur.dist, pchol.dist
    schur.dist = _Recorder(hits, gather_kind="interiors", **kw)
    pchol.dist = _Recorder(hits, real=kw.get("real"))
    try:
        yield hits
    finally:
        schur.dist, pchol.dist = saved


@contextlib.contextmanager
def counted_collectives():
    """The collectives of the distributed solve run inside the block, as
    trace_collectives records them, counted as they run."""
    import torch.distributed as dist

    with _recording(real=dist) as hits:
        yield hits


def scaling_graph(poses: int, closure_prob: float = 0.02):
    """The graph of the JAX package's scaling tools (scaling_model.py,
    bench_scaling.py, profile_r5_schur_stages.py): manhattan_world(poses,
    seed=0, closure_prob, block=25, max_closures_per_pose=1)."""
    from .datasets import manhattan_world

    return manhattan_world(poses, seed=0, closure_prob=closure_prob,
                           block=25, max_closures_per_pose=1)


def trace_collectives(g, part, ndev: int, sep_dist: bool,
                      sep_block: int = 128, dtype=np.float32) -> dict:
    """{kind: [count, bytes]} of one Gauss-Newton step of schur_solve(g,
    part) in `dtype` (float32, the JAX script's) on rank 0 of `ndev`
    ranks.  The kinds are the JAX script's ("all-reduce", "all-gather",
    "reduce-scatter"), plus "interiors": the all-gather of the new
    interior states, which the JAX script's walk does not see."""
    from .parallel.schur import schur_solve

    with _recording(stop_at_gather=True) as hits:
        try:
            schur_solve(MetaMesh(ndev), g, part, gn_iters=1,
                        dtype=dtype, sep_dist=sep_dist,
                        sep_block=sep_block)
        except _Stop:
            pass
        else:
            raise RuntimeError("schur_solve ended without the interiors' "
                               "all-gather")
    return dict(hits)


def comm_volume(poses: int, ndev: int, sep_dist: bool, sep_block: int = 128,
                closure_prob: float = 0.02):
    """(partition, {kind: [count, bytes]}) per Gauss-Newton iteration on a
    mesh of `ndev` ranks, the graph partitioned into `ndev` blocks as the
    JAX script partitions it."""
    from .parallel.schur import partition_graph

    g = scaling_graph(poses, closure_prob)
    part = partition_graph(g, ndev)
    return part, trace_collectives(g, part, ndev, sep_dist, sep_block)


def row(poses: int, ndev: int, sep_dist: bool, part, hits: dict) -> dict:
    """The JAX script's JSON row, the interiors' gather apart; the totals
    without it are the JAX script's."""
    jax_kinds = {k: v for k, v in hits.items() if k != "interiors"}
    total = sum(b for _c, b in jax_kinds.values())
    ic, ib = hits.get("interiors", [0, 0])
    return {
        "poses": poses, "ndev": ndev,
        "sep": "pchol" if sep_dist else "replicated",
        "ns": part.ns, "ni_max": part.ni_max,
        "collectives": {k: {"count": c, "MB": round(b / 1e6, 2)}
                        for k, (c, b) in sorted(jax_kinds.items())},
        "interiors": {"kind": "all-gather", "count": ic,
                      "MB": round(ib / 1e6, 2)},
        "total_MB_per_gn": round(total / 1e6, 2),
        "total_MB_per_gn_with_interiors": round((total + ib) / 1e6, 2),
    }


def model_rows(g, ndevs=NDEVS, out=None) -> list:
    """The rows of graph g for each ndev and separator mode; each row is
    passed to `out` as it is made."""
    from .parallel.schur import partition_graph

    rows = []
    for ndev in ndevs:
        part = partition_graph(g, ndev)
        for sep_dist in (False, True):
            rows.append(row(g.nnodes, ndev, sep_dist, part,
                            trace_collectives(g, part, ndev, sep_dist)))
            if out is not None:
                out(rows[-1])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="aprilsam-torch-scaling-model",
        description="collectives and bytes per Gauss-Newton iteration of "
                    "the distributed Schur solve (no device)")
    ap.add_argument("--poses", type=int, default=100000)
    ap.add_argument("--closure_prob", type=float, default=0.02)
    args = ap.parse_args(argv)
    model_rows(scaling_graph(args.poses, args.closure_prob),
               out=lambda r: print(json.dumps(r), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
