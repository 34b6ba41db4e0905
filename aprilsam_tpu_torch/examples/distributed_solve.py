"""Distributed keyframe-block solve over a torch.distributed group, the
counterpart of the JAX package's examples/distributed_solve.py.

Generates a synthetic Manhattan-world graph, partitions the trajectory into
contiguous keyframe blocks, and runs the Schur-complement Gauss-Newton solve
over the ranks of the group: a world of one rank on --device when none is
initialized, or every rank that torchrun started (one card per rank).

Run:  python -m aprilsam_tpu_torch.examples.distributed_solve \
          [--poses 2000] [--blocks 16] [--device cpu] [--dtype float64]
      torchrun --nproc-per-node 4 -m aprilsam_tpu_torch.examples.distributed_solve
"""

import argparse
import copy

import numpy as np

from aprilsam_tpu_torch.datasets import manhattan_world
from aprilsam_tpu_torch.parallel import launched_mesh
from aprilsam_tpu_torch.parallel.schur import partition_graph, schur_solve


def main(argv=None) -> float:
    """Solve on the launched ranks; returns the final chi2 (every rank)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=2000)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="default: float64 on the CPU, float32 on the card")
    args = ap.parse_args(argv)

    with launched_mesh(args.device) as mesh:
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

        name = args.dtype or ("float64" if mesh.device.type == "cpu"
                              else "float32")
        states = schur_solve(mesh, g, part, gn_iters=3,
                             dtype=getattr(np, name))

        g2 = copy.deepcopy(g)
        g2.state[: g.nnodes] = states
        chi2 = g2.chi2()
        show(f"after 3 distributed GN iterations ({name}): chi2 {chi2:.10g}")
        return chi2


if __name__ == "__main__":
    main()
