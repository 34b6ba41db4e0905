"""Scaling benchmark of the distributed keyframe-block Schur solve: the
counterpart of ``bench_scaling.py`` on PyTorch.

Solves ``manhattan_world(poses, seed=0, closure_prob, block=25,
max_closures_per_pose=1)`` in `blocks` keyframe blocks with
``parallel/schur.py:schur_solve`` at the mesh sizes {1, max(2, N // 4), N}
of a world of N ranks (each size that divides `blocks`; size k is the
sub-group of ranks 0..k-1, the others wait at a barrier) and reports the
scaling efficiency T(1) / (N T(N)).  Each size runs a warm
``gn_iters=1`` solve, then the timed solve (on the card,
``torch.cuda.synchronize()`` inside the clock); chi2 is read outside the
clock, as the JAX script times it.

Same flags and defaults as ``bench_scaling.py``, plus --device (default
cuda), --dtype (default float64 on the CPU, float32 on the card, as the
JAX script picks them by platform) and --ranks:

    python -m aprilsam_tpu_torch.scaling [--poses 20000] [--blocks 64]
        [--json] [--device cpu] [--ranks 8]
    torchrun --nproc-per-node 4 -m aprilsam_tpu_torch.scaling

The world is --ranks spawned processes (gloo on the CPU; NCCL on the
card, one card per rank: more ranks than cards raise), else the ranks
torchrun started, else one rank.  Each size's time is its slowest
rank's.  Under --json the last line is the JAX script's JSON; on the card
its unit adds the efficiency at the middle size, the card, its power
limit and the link between the cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

CPU_NOTE = (" [NOTE: virtual CPU mesh shares one physical socket; "
            "multi-device numbers here validate correctness, not real "
            "scaling]")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="aprilsam-torch-scaling",
        description="distributed Schur solve at several mesh sizes")
    ap.add_argument("--poses", type=int, default=20000)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--closure_prob", type=float, default=0.04)
    ap.add_argument("--gn_iters", type=int, default=2)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if no card)")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="default: float64 on the CPU, float32 on the card")
    ap.add_argument("--ranks", type=int, default=None,
                    help="spawn this many ranks (default: torchrun's world, "
                         "else one rank)")
    return ap


def mesh_sizes(world: int, blocks: int) -> list:
    """The JAX script's sizes {1, max(2, N // 4), N} that divide `blocks`,
    none above the world: the JAX script's make_mesh(2) on one device
    slices jax.devices()[:2] and silently solves on a mesh of one."""
    return [k for k in sorted({1, max(2, world // 4), world})
            if k <= world and blocks % k == 0]


def solve_dtype(args, device) -> type:
    name = args.dtype or ("float64" if device.type == "cpu" else "float32")
    return np.float64 if name == "float64" else np.float32


def graph_chi2(g, states) -> float:
    """g's chi2 at `states`, g's own states left as they were."""
    kept = g.state[: g.nnodes].copy()
    g.state[: g.nnodes] = states
    try:
        return g.chi2()
    finally:
        g.state[: g.nnodes] = kept


def timed_solve(mesh, g, part, gn_iters: int, dtype) -> dict:
    """A warm gn_iters=1 solve (the group's first collectives), then the
    timed solve, its clock started after a barrier and ended on each
    rank's card; the seconds are the slowest rank's (one all-reduce after
    the clock); chi2 off the clock."""
    from .parallel.dist import clocked, slowest
    from .parallel.schur import schur_solve

    schur_solve(mesh, g, part, gn_iters=1, dtype=dtype)
    secs, states = clocked(mesh, lambda: schur_solve(
        mesh, g, part, gn_iters=gn_iters, dtype=dtype))
    return {"seconds": slowest(mesh, [secs])[0],
            "chi2": graph_chi2(g, states), "states": states}


def bench_rank(mesh, args, meshes: dict = None) -> dict:
    """Run on each rank of the world `mesh`: the graph, its partition, and
    each mesh size's solve on the ranks of its sub-group (`meshes`, from
    parallel/dist.py:subgroups, made here when not given).  Returns the
    graph's figures and {size: timed_solve(...)} for the sizes this rank
    took part in."""
    from .parallel.dist import barrier, subgroups
    from .parallel.schur import partition_graph
    from .scaling_model import scaling_graph

    g = scaling_graph(args.poses, args.closure_prob)
    part = partition_graph(g, args.blocks)
    dtype = solve_dtype(args, mesh.device)
    out = {"nodes": g.nnodes, "factors": g.nfactors, "chi2_initial": g.chi2(),
           "ni_max": part.ni_max, "ns": part.ns, "world": mesh.size,
           "dtype": np.dtype(dtype).name, "sizes": {}}
    sizes = mesh_sizes(mesh.size, args.blocks)
    meshes = meshes or subgroups(mesh, sizes)
    for k in sizes:
        if meshes[k] is not None:
            out["sizes"][k] = timed_solve(meshes[k], g, part, args.gn_iters,
                                          dtype)
        barrier(mesh)
    return out


def efficiency(res: dict, k: int = None):
    """T(1) / (k T(k)) for k ranks (default: the world's N), or None where
    either size did not run."""
    k = k or res["world"]
    t = res["sizes"]
    if 1 in t and k in t:
        return t[1]["seconds"] / (t[k]["seconds"] * k)
    return None


def report(res: dict, args, device, card, link=None, out=print) -> None:
    """The JAX script's lines from rank 0's result, with the efficiency at
    every size above 1; on the card the JSON unit adds E at the middle
    size, the card and the link between the cards."""
    out(f"generated {args.poses}-pose Manhattan world: nodes={res['nodes']} "
        f"factors={res['factors']} initial chi2={res['chi2_initial']:.1f}")
    out(f"partition: {args.blocks} blocks, interior_max={res['ni_max']}, "
        f"separator={res['ns']}; {res['dtype']} on {device}"
        + (f" ({card})" if card else ""))
    c0 = res["chi2_initial"]
    for k, r in sorted(res["sizes"].items()):
        out(f"ndev={k}: {r['seconds']:.2f}s  chi2 {c0:.1f} -> "
            f"{r['chi2']:.1f}")
    n = res["world"]
    note = CPU_NOTE if device.type == "cpu" else ""
    mids = [k for k in sorted(res["sizes"]) if 1 < k < n]
    for k in mids:
        out(f"scaling efficiency at {k} devices: {efficiency(res, k):.2f}"
            f"{note}")
    eff = efficiency(res)
    if eff is None:
        return
    out(f"scaling efficiency at {n} devices: {eff:.2f}{note}")
    if args.json:
        unit = f"(poses={args.poses}, devices={n}"
        if card:
            unit += "".join(f", E({k})={efficiency(res, k):.3f}"
                            for k in mids)
            unit += f", card={card}" + (f", link={link}" if link else "")
        out(json.dumps({"metric": "schur_scaling_efficiency",
                        "value": round(eff, 3), "unit": unit + ")",
                        "vs_baseline": round(eff / 0.7, 3)}))


def run(args) -> list:
    """Every rank's bench_rank result, in rank order, from the world the
    arguments name (the caller's process is rank 0 unless --ranks
    spawns)."""
    from .parallel import launched_mesh
    from .parallel.dryrun import run_ranks
    from .utils import resolve_device

    device = resolve_device(args.device)
    if args.ranks is not None:
        if "TORCHELASTIC_RUN_ID" in os.environ:
            raise ValueError("--ranks spawns its own world; under torchrun "
                             "leave it unset")
        return run_ranks(bench_rank, args.ranks, args, timeout=3600.0,
                         device=device.type)
    with launched_mesh(device) as mesh:
        res = bench_rank(mesh, args)
        return [res] if mesh.rank == 0 else []


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .utils import resolve_device
    from .utils.card import card_line, link_line

    device = resolve_device(args.device)
    results = run(args)
    if results:
        cuda = device.type == "cuda"
        report(results[0], args, device, card_line() if cuda else None,
               link_line() if cuda else None,
               out=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
