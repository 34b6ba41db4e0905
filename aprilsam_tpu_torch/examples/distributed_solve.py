"""Distributed keyframe-block solve over a torch.distributed group, the
counterpart of the JAX package's examples/distributed_solve.py.

Generates a synthetic Manhattan-world graph, partitions the trajectory into
contiguous keyframe blocks, and runs the Schur-complement Gauss-Newton solve
over the ranks of the group: a world of one rank on --device when none is
initialized, or every rank that torchrun started (one card per rank).

Run:  python -m aprilsam_tpu_torch.examples.distributed_solve \
          [--poses 2000] [--blocks 16] [--device cpu]
      torchrun --nproc-per-node 4 -m aprilsam_tpu_torch.examples.distributed_solve
"""

import argparse
import contextlib
import copy
import os

import numpy as np
import torch
import torch.distributed as dist

from aprilsam_tpu_torch.datasets import manhattan_world
from aprilsam_tpu_torch.parallel import make_mesh, one_rank_group
from aprilsam_tpu_torch.parallel.schur import partition_graph, schur_solve


@contextlib.contextmanager
def _mesh(device: str):
    """The caller's group, torchrun's world, or a world of one rank."""
    if dist.is_initialized():
        yield make_mesh(device=device)
    elif "TORCHELASTIC_RUN_ID" in os.environ:        # started by torchrun
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        try:
            yield make_mesh(device=dev)
        finally:
            dist.destroy_process_group()
    else:
        with one_rank_group(device) as mesh:
            yield mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=2000)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with _mesh(args.device) as mesh:
        ndev = mesh.size
        show = print if mesh.rank == 0 else (lambda *a, **k: None)
        blocks = args.blocks - args.blocks % ndev or ndev
        show(f"ranks: {ndev}, blocks: {blocks}, device: {mesh.device}")

        g = manhattan_world(args.poses, seed=0, closure_prob=0.2)
        show(f"graph: {g.nnodes} poses, {g.nfactors} factors, "
             f"chi2 {g.chi2():.1f}")

        part = partition_graph(g, blocks)
        show(f"partition: interior<= {part.ni_max}, separator {part.ns}, "
             f"local-separator<= {part.nsl}")

        dtype = np.float64 if mesh.device.type == "cpu" else np.float32
        states = schur_solve(mesh, g, part, gn_iters=3, dtype=dtype)

        g2 = copy.deepcopy(g)
        g2.state[: g.nnodes] = states
        show(f"after 3 distributed GN iterations: chi2 {g2.chi2():.1f}")


if __name__ == "__main__":
    main()
