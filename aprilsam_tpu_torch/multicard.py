"""The distributed solves across several ranks, held to the JAX package's
multi-device figures: what ``chip_smoke.py`` runs on every card of a
machine (one NCCL rank per card), the bench's 4-card cell
(``bench.py:run_schur``, one graph, dtype and mode) and
``tests/test_torch_multicard.py`` on gloo ranks of the CPU.

One world of N ranks runs, on the sub-groups of ranks 0..k-1 for each mesh
size k of ``Spec.sizes`` (``parallel/dist.py:subgroups``, made once and
shared by every part below; the others wait at a barrier):
  * with ``Spec.dryrun``, the dry run
    (``parallel/dryrun.py:dryrun_multichip``) at each k > 1,
    its 512*k-pose states and dp dx norm held to the JAX package's on its
    k-device mesh (``golden/multicard_jax.npz``, made by
    ``tests/make_multicard_golden.py``);
  * ``schur_solve`` of each graph of ``Spec.graphs`` in ``Spec.blocks``
    blocks, in each of ``Spec.dtypes`` and ``Spec.modes``, at every k:
    ms per Gauss-Newton iteration (``schur_stages.py:iteration_times``:
    the median of ``Spec.repeats`` 2-iteration solves minus 1-iteration
    ones, each clock started after a barrier and the slowest rank's,
    after a warm solve that makes the group's first collectives), each
    rank's peak device memory, and the states held to the one-rank
    solve's and, in float64, chi2 to the host BatchSolver's; with
    ``Spec.profile``, one more 1-iteration solve under torch.profiler
    (each rank's stage table and collectives);
  * ``scaling.py:bench_rank`` (bench_scaling.py at its defaults) in each
    dtype of ``Spec.bench_dtypes``, chi2 at each size held to the
    golden's;
  * where ``Spec.stages`` is set, ``schur_stages.py:stages_rank`` (every
    rank profiled at every size, collectives counted).
Every rank's states are compared by their bytes: NCCL's and gloo's
all-reduce and all-gather hand every rank the same bytes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "multicard_jax.npz")
# The dry run's float32 states against the JAX package's, per separator
# mode: twice the JAX package's own float32 error at 2048 poses on four
# devices (tests/test_torch_parallel.py::test_schur_float32_matches_jax:
# 0.0164 in xy, 4.9e-4 in theta against the float64 solve); the dp solve's
# dx norm relative.
DRYRUN_TOL = {"xy": 0.033, "theta": 1e-3, "dx_rel": 1e-3}
# schur_solve on k ranks against one rank, norm-wise (max |a - b| / (1 +
# max |b|), angles mod 2pi; chip_smoke.py's SCHUR_TOL["float64_modes"] as
# phase 12 reads it) and chi2 relative: the ranks' sums of the separator
# system meet float64 rounding in another order; float32 as its separator
# modes are held to each other.  Float64 chi2 against the host
# BatchSolver's, relative (tests/test_distributed.py's 1e-5).
SOLVE_TOL = {"float64": {"states": 1e-8, "chi2_rel": 1e-9},
             "float32": {"states": 5e-2, "chi2_rel": 1e-2}}
BATCH_CHI2_REL = 1e-5
# The bench's final chi2 against the JAX package's CPU figure at each mesh
# size (chip_smoke.py's SCALING_TOL: the card's cuSOLVER rounds otherwise
# than the CPU's LAPACK; float32's damping leaves the port's CPU float32
# 0.56 % from JAX's)
BENCH_TOL = {"float64": 1e-7, "float32": 5e-2}
MODES = {"replicated": False, "distributed": True}
DTYPES = ("float64", "float32")


@dataclasses.dataclass(frozen=True)
class Spec:
    """What one world runs.  `graphs` maps a name to manhattan_world's
    arguments, solved in each of `dtypes` and `modes` (keys of MODES) at
    each of `sizes` (ascending: 1 first, the reference of the others),
    timed over `repeats` pairs and, with `profile`, once more under
    torch.profiler (schur_stages.profile_iteration); no dry run without
    `dryrun`, no bench dtypes, no bench."""

    sizes: tuple = (1, 2, 4)
    graphs: tuple = (
        ("manhattan", dict(n_poses=100000, seed=0, closure_prob=0.02)),
        ("scaling", dict(n_poses=100000, seed=0, closure_prob=0.02,
                         block=25, max_closures_per_pose=1)),
    )
    blocks: int = 64
    dtypes: tuple = DTYPES
    modes: tuple = tuple(MODES)
    dryrun: bool = True
    repeats: int = 3               # schur_stages.REPEATS
    profile: bool = False
    bench_dtypes: tuple = ("float64", "float32")
    stages: bool = True


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def state_diff(a: np.ndarray, b: np.ndarray) -> dict:
    """The largest xy and theta (mod 2pi) differences of two state tables,
    and the norm-wise one, max |a - b| / (1 + max |b|)."""
    from .geometry import np_mod2pi

    d = np.abs(a - b)
    d[:, 2] = np.abs(np_mod2pi(a[:, 2] - b[:, 2]))
    return {"xy": float(np.max(d[:, :2])), "theta": float(np.max(d[:, 2])),
            "norm": float(np.max(d) / (1.0 + np.max(np.abs(b))))}


def _graph(kw: dict):
    from .datasets import manhattan_world

    return manhattan_world(**kw)


def multicard_rank(mesh, spec: Spec) -> dict:
    """Run on each rank of the world `mesh` (see the module's docstring).
    Returns host values only: every rank the digests of its states, its
    times and memory, and the K1 launches of its process by shape; rank 0
    also the dry run's states, the differences of each solve from the
    one-rank solve, the chi2 of each and the BatchSolver's."""
    from . import scaling, schur_stages
    from .kernels import tri_inv
    from .parallel.dist import barrier, subgroups
    from .parallel.dryrun import dryrun_multichip
    from .parallel.schur import partition_graph
    from .scaling import graph_chi2

    r = mesh.rank
    out = {"rank": r, "world": mesh.size, "device": str(mesh.device),
           "dryrun": {}, "solves": {}, "batch": {}, "seconds": {}}
    dev = ["--device", mesh.device.type]
    bench_args = [scaling.build_parser().parse_args(dev + ["--dtype", dt])
                  for dt in spec.bench_dtypes]
    stages_args = schur_stages.build_parser().parse_args(dev)
    sizes = [k for k in spec.sizes if k <= mesh.size]
    tools = bench_args + ([stages_args] if spec.stages else [])
    meshes = subgroups(mesh, sizes + [
        k for a in tools for k in scaling.mesh_sizes(mesh.size, a.blocks)])

    t = time.perf_counter()
    for k in sizes if spec.dryrun else ():
        if k > 1 and r < k:
            states = {}
            dry = dryrun_multichip(meshes[k], states)
            out["dryrun"][k] = {
                "result": dry,
                "digests": {m: _digest(s) for m, s in states.items()}}
            if r == 0:
                out["dryrun"][k]["states"] = states
        barrier(mesh)
    out["seconds"]["dryrun"] = time.perf_counter() - t

    for name, kw in spec.graphs:
        t = time.perf_counter()
        g = _graph(kw)
        part = partition_graph(g, spec.blocks)
        out["seconds"][f"graph {name}"] = time.perf_counter() - t
        out[f"partition {name}"] = {"nodes": g.nnodes, "ns": part.ns,
                                    "ni_max": part.ni_max, "nsl": part.nsl,
                                    "chi2_initial": g.chi2()}
        t = time.perf_counter()
        one = {}
        for k in sizes:
            if r < k:
                for dt in spec.dtypes:
                    for mode in spec.modes:
                        args = (meshes[k], g, part, getattr(np, dt),
                                MODES[mode])
                        it = schur_stages.iteration_times(
                            *args, repeats=spec.repeats)
                        st = it["states"]
                        res = {"ms_per_iter": it["t_per_gn_s"] * 1e3,
                               "runs_s": it["runs_s"],
                               "t_gn1_s": it["t_gn1_s"],
                               "peak_bytes": it["max_memory_allocated"],
                               "digest": _digest(st),
                               "finite": bool(np.all(np.isfinite(st)))}
                        if spec.profile:
                            res["profile"], res["counted"], \
                                res["profiled_s"] = \
                                schur_stages.profile_iteration(*args)
                        if r == 0:
                            res["chi2"] = graph_chi2(g, st)
                            if k == 1:
                                one[dt, mode] = st
                            res["vs_one_rank"] = state_diff(st,
                                                            one[dt, mode])
                        out["solves"][name, dt, mode, k] = res
            barrier(mesh)
        out["seconds"][f"solves {name}"] = time.perf_counter() - t
        del one
        if r == 0:
            t = time.perf_counter()
            out["batch"][name] = _batch_chi2(g, mesh.device)
            out["seconds"][f"batch {name}"] = time.perf_counter() - t
        barrier(mesh)

    if bench_args:
        out["bench"] = {}
        for args in bench_args:
            t = time.perf_counter()
            res = scaling.bench_rank(mesh, args, meshes)
            for v in res["sizes"].values():
                v["digest"] = _digest(v.pop("states"))
            out["bench"][args.dtype] = res
            out["seconds"][f"bench {args.dtype}"] = time.perf_counter() - t
    if spec.stages:
        t = time.perf_counter()
        out["stages"] = schur_stages.stages_rank(mesh, stages_args, meshes)
        out["seconds"]["stages"] = time.perf_counter() - t
    out["tri_inv_launches"] = dict(tri_inv.launches_by_shape)
    return out


def _batch_chi2(g, device) -> float:
    """chi2 of the host BatchSolver's float64 solve of g (two Gauss-Newton
    iterations, as schur_solve's timed solve)."""
    from .solver import BatchSolver, SolverConfig

    cap = 1 << max(10, int(np.ceil(np.log2(max(g.nnodes, g.nfactors)))))
    mono = BatchSolver(SolverConfig(node_capacity=cap, factor_capacity=cap,
                                    gn_iters=2), device=device)
    mono.solve(g)
    return float(mono.chi2())


def read_golden(path: str = GOLDEN) -> dict:
    """The golden's arrays, and its meta under "meta"."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files if k != "meta_json"}
        out["meta"] = json.loads(str(z["meta_json"]))
    return out


def check(results: list, golden: dict) -> tuple:
    """Hold a world's results (every rank's multicard_rank, in rank order)
    to the golden and to each other.  Returns (summary, failures): the
    summary holds every figure compared, each beside its bound."""
    from .schur_stages import combine

    head = results[0]
    bad, summary = [], {"world": head["world"], "dryrun": {}, "solves": {},
                        "bench": {}}

    cards = [r["device"] for r in results if r["device"] != "cpu"]
    if cards and cards != [f"cuda:{r}" for r in range(len(results))]:
        bad.append(f"the ranks ran on {cards}, not rank r on card r")

    def same(digests, what):
        if len(set(digests)) != 1:
            bad.append(f"{what}: the ranks' states differ")
        return len(set(digests)) == 1

    for k, dry in head["dryrun"].items():
        row = {"dp_dx_norm": dry["result"]["dp_dx_norm"],
               "dp_dx_norm_jax": float(golden[f"dryrun{k}_dp_dx_norm"])}
        row["dx_rel"] = (abs(row["dp_dx_norm"] - row["dp_dx_norm_jax"])
                         / row["dp_dx_norm_jax"])
        if not row["dx_rel"] <= DRYRUN_TOL["dx_rel"]:
            bad.append(f"dry run at {k}: dx norm {row}")
        for mode, st in dry["states"].items():
            d = state_diff(st, golden[f"dryrun{k}_{mode}"].astype(
                np.float64))
            row[mode] = d
            if not (d["xy"] <= DRYRUN_TOL["xy"]
                    and d["theta"] <= DRYRUN_TOL["theta"]):
                bad.append(f"dry run at {k}, {mode}: {d} against JAX")
            row[f"{mode}_ranks_identical"] = same(
                [r["dryrun"][k]["digests"][mode] for r in results
                 if k in r["dryrun"]], f"dry run at {k}, {mode}")
        summary["dryrun"][k] = row

    for key, res in head["solves"].items():
        name, dt, mode, k = key
        row = {"ms_per_iter": res["ms_per_iter"], "runs_s": res["runs_s"],
               "peak_bytes": [r["solves"][key]["peak_bytes"]
                              for r in results if key in r["solves"]],
               "chi2": res["chi2"],
               "ranks_identical": same(
                   [r["solves"][key]["digest"] for r in results
                    if key in r["solves"]], f"{key}")}
        if not all(r["solves"][key]["finite"] for r in results
                   if key in r["solves"]):
            bad.append(f"{key}: states not finite")
        t1 = head["solves"][name, dt, mode, 1]
        row["E"] = t1["ms_per_iter"] / (k * res["ms_per_iter"])
        if k > 1:
            row["vs_one_rank"] = res["vs_one_rank"]
            row["chi2_rel_vs_one_rank"] = (abs(res["chi2"] - t1["chi2"])
                                           / t1["chi2"])
            tol = SOLVE_TOL[dt]
            if not (res["vs_one_rank"]["norm"] <= tol["states"]
                    and row["chi2_rel_vs_one_rank"] <= tol["chi2_rel"]):
                bad.append(f"{key}: {row} against one rank, bound {tol}")
        if dt == "float64" and name in head["batch"]:
            row["chi2_rel_vs_batch"] = (abs(res["chi2"] - head["batch"][name])
                                        / head["batch"][name])
            if not row["chi2_rel_vs_batch"] <= BATCH_CHI2_REL:
                bad.append(f"{key}: chi2 {res['chi2']} against the batch "
                           f"solve's {head['batch'][name]}")
        summary["solves"]["-".join(map(str, key))] = row

    if "bench" in head:
        ndev = [int(k) for k in golden["bench_ndev"]]
        for dt, res in head["bench"].items():
            want = golden[f"bench_chi2_{dt}"]
            row = {}
            for k, v in res["sizes"].items():
                jax = float(want[ndev.index(k)])
                rel = abs(v["chi2"] - jax) / jax
                row[k] = {"seconds": v["seconds"], "chi2": v["chi2"],
                          "chi2_jax": jax, "chi2_rel": rel,
                          "ranks_identical": same(
                              [r["bench"][dt]["sizes"][k]["digest"]
                               for r in results
                               if k in r["bench"][dt]["sizes"]],
                              f"bench {dt} at {k}")}
                if not rel <= BENCH_TOL[dt]:
                    bad.append(f"bench {dt} at {k}: chi2 {v['chi2']} "
                               f"against JAX's {jax}")
            sizes = sorted(res["sizes"])
            t1 = res["sizes"][1]["seconds"]
            row["E"] = {k: t1 / (k * res["sizes"][k]["seconds"])
                        for k in sizes}
            summary["bench"][dt] = row

    if "stages" in head:
        comb = combine([r["stages"] for r in results])
        summary["stages"] = comb
        for k, ranks in comb["sizes"].items():
            if not all(r["finite"] for r in ranks):
                bad.append(f"stages at {k}: states not finite")
            if not comb["collectives"][k]["equal"]:
                bad.append(f"stages at {k}: counted collectives differ "
                           "from scaling_model's")
    return summary, bad
