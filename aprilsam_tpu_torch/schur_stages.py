"""Single-card stage costs of the distributed Schur solve at 100k poses: the
counterpart of ``profile_r5_schur_stages.py`` on PyTorch.

Runs ``parallel/schur.py:schur_solve`` on one rank (all B blocks on one
device: the per-rank work of a B/k-blocks-per-rank deployment times k) on
the JAX script's graph, ``manhattan_world(poses, seed=0, closure_prob,
block=25, max_closures_per_pose=1)`` in `blocks` blocks, in the JAX
script's order: two full solves (the first warm), a warm ``gn_iters=1``
solve, the per-Gauss-Newton-iteration time from their difference, and the
final chi2.  Then one more iteration under ``torch.profiler``, its device
time summed by stage (``STAGES``): each kernel is placed by the profiler
range of ``schur_solve`` it ran under (``schur.assemble``,
``schur.eliminate``, ``schur.separator``, ``schur.backsub``, inside
``schur.gn_step``) and by the torch operation that launched it.  Printed
beside it: the host time outside any kernel (the device's idle share),
the peak device memory, the least time the card could take for the
iteration (the bound) and its share, and the projection of SCALING.md
section 4 from these stages, with the bytes per iteration of
``scaling_model`` on this partition.  No link between cards has been
measured, so the projection leaves communication time out.

On the CPU the same table sums the host time of each torch operation
(there are no kernels); its numbers are CPU times, not device times.

    python -m aprilsam_tpu_torch.schur_stages [--poses 100000]
        [--blocks 64] [--dtype float64] [--device cpu]

The last line is the JAX script's JSON, with the card's name and power
limit; the line before it holds every figure, unrounded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

STAGES = ("assembly", "interior Cholesky", "triangular solves",
          "Schur update", "separator reduction", "separator solve",
          "back-substitution", "other")
# the stages that divide by the rank count, and those that do not
BLOCK_STAGES = ("assembly", "interior Cholesky", "triangular solves",
                "Schur update", "back-substitution")
SEP_STAGES = ("separator reduction", "separator solve")
STEP = "schur.gn_step"
RANGES = (STEP, "schur.eliminate", "schur.assemble", "schur.separator",
          "schur.backsub")
# operations of the Schur update inside schur.eliminate: the GEMMs, their
# subtraction from A_SS and b_S, the scatter-add into the flat system
SCHUR_OPS = ("aten::matmul", "aten::bmm", "aten::mm", "aten::baddbmm",
             "aten::sub", "aten::index_add_")
COLLECTIVE_MARKS = ("nccl", "gloo", "c10d::", "record_param_comms",
                    "allreduce", "all_reduce", "allgather", "all_gather",
                    "reduce_scatter", "reducescatter")
PROJECT_NDEVS = (2, 4, 8)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="aprilsam-torch-schur-stages",
        description="single-card stage costs of the distributed Schur solve")
    ap.add_argument("--poses", type=int, default=100000)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--closure_prob", type=float, default=0.02)
    ap.add_argument("--gn_iters", type=int, default=2)
    ap.add_argument("--dtype", choices=["float32", "float64"],
                    default="float32")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if no card)")
    return ap


def _collective(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in COLLECTIVE_MARKS)


def classify(rng: str, op: str, name: str) -> str:
    """The stage of work named `name` (a kernel, or an operation on the
    CPU) launched by the top-level torch operation `op` under the range
    `rng` of schur_solve."""
    if rng == "schur.assemble":
        return "assembly"
    if rng == "schur.eliminate":
        if "cholesky" in op:
            return "interior Cholesky"
        if "solve_triangular" in op:
            return "triangular solves"
        return "Schur update" if op in SCHUR_OPS else "other"
    if rng == "schur.separator":
        if _collective(name) or _collective(op):
            return "separator reduction"
        return "separator solve"
    if rng == "schur.backsub" and not (_collective(name)
                                       or _collective(op)):
        return "back-substitution"
    return "other"          # the interiors' all-gather, copies to the host


def _place(evt):
    """(range, top-level operation) of a profiler event: the nearest
    enclosing range of RANGES, and the operation just below it; None
    outside schur.gn_step."""
    chain = []
    e = evt
    while e is not None:
        chain.append(e)
        e = e.cpu_parent
    names = [c.name for c in chain]
    if STEP not in names:
        return None
    i = next(i for i, n in enumerate(names) if n in RANGES)
    return names[i], (names[i - 1] if i > 0 else names[0])


def stage_table(prof, cuda: bool) -> dict:
    """Time and launches by stage within schur.gn_step, the iteration's
    length, and the ten kernels (CPU: operations) that took longest.  On
    the card a stage's time is the device time of its kernels; on the CPU
    the host time of its operations (self time, so nesting is counted
    once)."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    steps = [e for e in cpu if e.name == STEP]
    if len(steps) != 1:
        raise RuntimeError(f"expected one {STEP} range, found {len(steps)}")
    step = steps[0]
    iteration_us = step.time_range.end - step.time_range.start
    ms = dict.fromkeys(STAGES, 0.0)
    launches = dict.fromkeys(STAGES, 0)
    by_name = {}
    ambiguous = 0      # kernels whose id names operations placed apart

    def add(stage, name, us):
        ms[stage] += us / 1e3
        launches[stage] += 1
        t = by_name.setdefault(name, [0.0, 0, stage])
        t[0] += us / 1e3
        t[1] += 1

    if cuda:
        # each kernel once, from the profiler's raw device records, placed
        # by the operation its linked correlation id names; the CUDA
        # runtime's own records (cudaLaunchKernel, ...) number from another
        # counter, so an operation is known by its id and its name
        raw = prof.profiler.kineto_results.events()
        ops = {(k.correlation_id(), k.name()) for k in raw
               if k.device_type() == DeviceType.CPU
               and k.linked_correlation_id() == 0}
        owners = {}
        for e in cpu:
            if e.name not in RANGES and (e.id, e.name) in ops:
                owners.setdefault(e.id, []).append(e)
        for k in raw:
            name = k.name()
            if k.device_type() != DeviceType.CUDA or name in RANGES:
                continue
            cands = owners.get(k.linked_correlation_id(), [])
            places = {_place(e) for e in cands}
            if len(places) > 1:
                ambiguous += 1
            where = _place(cands[0]) if cands else None
            if where is not None:
                add(classify(*where, name), name, k.duration_ns() / 1e3)
    else:
        for e in cpu:
            if e.name in RANGES or e.self_cpu_time_total <= 0:
                continue
            where = _place(e)
            if where is not None:
                add(classify(*where, e.name), e.name, e.self_cpu_time_total)
    busy = sum(ms.values())
    if cuda and busy == 0.0:
        raise RuntimeError("torch.profiler recorded no device time inside "
                           f"{STEP}")
    iteration = iteration_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "iteration_ms": iteration, "busy_ms": busy,
        "idle_ms": iteration - busy, "idle_share": 1.0 - busy / iteration,
        "ambiguous_kernels": ambiguous,
        "stages": {s: {"ms": ms[s], "launches": launches[s],
                       "share": ms[s] / iteration} for s in STAGES},
        "top": [{"name": n, "ms": v[0], "launches": v[1], "stage": v[2]}
                for n, v in top],
    }


def bound(part, dtype, peaks) -> dict:
    """The least time one Gauss-Newton iteration could take on the card,
    from the interior eliminations of all B blocks at their padded shapes
    (nI = 3 ni_max, nS = 3 nsl): per block the Cholesky nI^3/3, W = L^-1
    A_IS nI^2 nS and the Schur update 2 nS^2 nI operations, against the
    kept factors L [B, nI, nI] written once and read once."""
    nI, nS, B = 3 * part.ni_max, 3 * part.nsl, part.B
    ops = B * (nI ** 3 / 3 + nI ** 2 * nS + 2 * nS ** 2 * nI)
    nbytes = 2 * B * nI ** 2 * np.dtype(dtype).itemsize
    out = {"operations": ops, "bytes": nbytes}
    if peaks is None:
        return out
    t_ops = ops / peaks[np.dtype(dtype).name] * 1e3
    t_bytes = nbytes / peaks["bytes_per_s"] * 1e3
    out.update(ms=max(t_ops, t_bytes),
               by="operations" if t_ops >= t_bytes else "bytes")
    return out


def projection(table: dict, g, part) -> list:
    """SCALING.md section 4 from the profiled stages: T(k) = T_blocks / k
    + T_sep and E(k) = T(1) / (k T(k)); beside it E with the rest (other
    stages and host time outside kernels) counted as not dividing, and the
    bytes per iteration of scaling_model on this partition (MB, the
    interiors' gather included).  No communication time: no link between
    cards has been measured."""
    from .scaling_model import row, trace_collectives

    st = table["stages"]
    t_blocks = sum(st[s]["ms"] for s in BLOCK_STAGES)
    t_sep = sum(st[s]["ms"] for s in SEP_STAGES)
    t_rest = table["iteration_ms"] - t_blocks - t_sep
    t1 = t_blocks + t_sep
    rows = []
    for k in (1,) + PROJECT_NDEVS:
        if part.B % k:
            continue
        t = t_blocks / k + t_sep
        r = {"ndev": k, "T_blocks_ms": t_blocks, "T_sep_ms": t_sep,
             "T_ms": t, "E": t1 / (k * t),
             "E_with_rest": (t1 + t_rest) / (k * (t + t_rest))}
        if k > 1:
            for sep_dist in (False, True):
                m = row(g.nnodes, k, sep_dist, part,
                        trace_collectives(g, part, k, sep_dist))
                r[f"MB_{m['sep']}"] = m["total_MB_per_gn_with_interiors"]
        rows.append(r)
    return rows


def profile_stages(mesh, g, part, gn_iters: int = 2, dtype=np.float32,
                   peaks=None, out=print) -> dict:
    """The JAX script's timings, then the profiled iteration, on `mesh`
    (one rank).  `peaks` are the card's published rates (None on the CPU:
    no bound).  Returns every figure and the final states."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .parallel.schur import schur_solve
    from .scaling import graph_chi2

    cuda = mesh.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(mesh.device)

    for attempt in range(2):
        if cuda and attempt == 1:
            torch.cuda.reset_peak_memory_stats(mesh.device)
        sync()
        t0 = time.perf_counter()
        states = schur_solve(mesh, g, part, gn_iters=gn_iters, dtype=dtype)
        sync()
        t_total = time.perf_counter() - t0
        out(f"attempt {attempt}: full solve {t_total:.2f}s")
    peak = torch.cuda.max_memory_allocated(mesh.device) if cuda else None
    chi2 = graph_chi2(g, states)
    sync()
    t0 = time.perf_counter()
    schur_solve(mesh, g, part, gn_iters=1, dtype=dtype)
    sync()
    t_gn1 = time.perf_counter() - t0
    per_gn = (t_total - t_gn1) / max(1, gn_iters - 1)
    out(f"gn_iters=1 (warm): {t_gn1:.2f}s -> per-GN-iteration "
        f"{per_gn:.2f}s")

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        schur_solve(mesh, g, part, gn_iters=1, dtype=dtype)
        sync()
    table = stage_table(prof, cuda)
    b = bound(part, dtype, peaks)
    if "ms" in b:
        b["share_of_gn_iteration"] = b["ms"] / (per_gn * 1e3)
    sizes = [len(i) for i in part.interiors]
    return {
        "states": states, "chi2_initial": g.chi2(), "chi2": chi2,
        "t_total_s": t_total,
        "t_gn1_s": t_gn1, "t_per_gn_s": per_gn,
        "max_memory_allocated": peak, "profile": table, "bound": b,
        "ni_max": part.ni_max, "ni_mean": float(np.mean(sizes)),
        "imbalance": part.ni_max / float(np.mean(sizes)),
        "ns": part.ns, "nsl": part.nsl,
        "projection": projection(table, g, part),
    }


def report(res: dict, out=print) -> None:
    """The stage table, the idle share, the memory, the bound and the
    projection."""
    p = res["profile"]
    out(f"profiled iteration: {p['iteration_ms']:.3f} ms "
        f"(per-GN-iteration unprofiled {res['t_per_gn_s'] * 1e3:.3f} ms)")
    out(f"{'stage':<22}{'ms':>12}{'launches':>10}{'share':>8}")
    for s, v in p["stages"].items():
        out(f"{s:<22}{v['ms']:>12.3f}{v['launches']:>10}"
            f"{v['share']:>8.3f}")
    out(f"{'outside any kernel':<22}{p['idle_ms']:>12.3f}{'':>10}"
        f"{p['idle_share']:>8.3f}")
    if p["ambiguous_kernels"]:
        out(f"({p['ambiguous_kernels']} kernels placed by one of several "
            "operations that share their correlation id)")
    mem = res["max_memory_allocated"]
    out("peak memory: " + (f"{mem / 1e9:.3f} GB" if mem is not None
                           else "not measured (CPU)"))
    b = res["bound"]
    if "ms" in b:
        out(f"bound: {b['ms']:.3f} ms by {b['by']} ({b['operations']:.4g} "
            f"operations, {b['bytes']:.4g} bytes); share of the "
            f"iteration {b['share_of_gn_iteration']:.4f}")
    else:
        out("bound: not measured (no card)")
    out(f"imbalance ni_max / ni_mean: {res['ni_max']} / "
        f"{res['ni_mean']:.1f} = {res['imbalance']:.3f}")
    out("projection (no communication time: no link measured):")
    for r in res["projection"]:
        mb = "".join(f"  {k[3:]} {v:.2f} MB" for k, v in r.items()
                     if k.startswith("MB_"))
        out(f"  ndev={r['ndev']}: T {r['T_ms']:.3f} ms  E {r['E']:.4f}  "
            f"E with the rest {r['E_with_rest']:.4f}{mb}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .parallel import one_rank_group
    from .parallel.schur import partition_graph
    from .scaling_model import scaling_graph
    from .utils import resolve_device
    from .utils.card import card_line, card_peaks

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    card = card_line() if cuda else None
    print(f"platform: {'gpu' if cuda else 'cpu'}"
          + (f" ({card})" if card else ""), flush=True)
    t0 = time.perf_counter()
    g = scaling_graph(args.poses, args.closure_prob)
    print(f"generated {g.nnodes}/{g.nfactors} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    part = partition_graph(g, args.blocks)
    print(f"partition: B={part.B} ni_max={part.ni_max} ns={part.ns} "
          f"nsl={part.nsl} ({time.perf_counter() - t0:.1f}s host)",
          flush=True)
    dtype = np.float64 if args.dtype == "float64" else np.float32
    with one_rank_group(device) as mesh:
        peaks = (card_peaks(torch.cuda.get_device_name(mesh.device))
                 if cuda else None)
        res = profile_stages(mesh, g, part, args.gn_iters, dtype, peaks,
                             out=lambda m: print(m, flush=True))
    report(res, out=lambda m: print(m, flush=True))
    print(json.dumps({k: v for k, v in res.items() if k != "states"}),
          flush=True)
    print(json.dumps({
        "poses": args.poses, "blocks": args.blocks, "ns": part.ns,
        "ni_max": part.ni_max, "platform": "gpu" if cuda else "cpu",
        "card": card, "dtype": args.dtype,
        "t_total_s": round(res["t_total_s"], 2),
        "t_per_gn_s": round(res["t_per_gn_s"], 2),
        "final_chi2": round(float(res["chi2"]), 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
