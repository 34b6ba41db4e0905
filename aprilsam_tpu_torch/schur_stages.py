"""Stage costs of the distributed Schur solve at 100k poses: the
counterpart of ``profile_r5_schur_stages.py`` on PyTorch.

Runs ``parallel/schur.py:schur_solve`` on the JAX script's graph,
``manhattan_world(poses, seed=0, closure_prob, block=25,
max_closures_per_pose=1)`` in `blocks` blocks, in the JAX script's order
(``iteration_times``): a warm full solve, then a full and a
``gn_iters=1`` solve three times over, the per-Gauss-Newton-iteration
time the median of their differences, and the final chi2.  Then one
more iteration under ``torch.profiler``, its device time summed by stage
(``STAGES``): each kernel is placed by the profiler range
of ``schur_solve`` it ran under (``schur.assemble``, ``schur.eliminate``,
``schur.separator``, ``schur.backsub``, inside ``schur.gn_step``) and by
the torch operation that launched it.  Printed beside it: the host time
outside any kernel (the device's idle share), the peak device memory, the
least time the card could take for the iteration (the bound) and its
share, and the projection of SCALING.md section 4 from the one-rank
stages, with the bytes per iteration of ``scaling_model`` on this
partition.

With ``--ranks N`` the same runs on a spawned world of N ranks (NCCL, one
card per rank; gloo on the CPU) at each mesh size of ``scaling.py``
({1, max(2, N // 4), N} dividing `blocks`; size k is the sub-group of
ranks 0..k-1, the others wait at a barrier), every rank profiled.  The
tables then gain what one rank never has: the collectives' kernels
(``separator reduction``, ``interiors gather``), and of their time the
part each rank waited for the last rank to reach the collective (from the
ranks' kernel start times on the host's clock).  Printed beside the
projection: the measured T(k), the slowest rank's, and E(k) = T(1) /
(k T(k)); and the collectives and bytes each rank issued in the profiled
iteration, counted by wrapping the real ``torch.distributed`` calls,
beside ``scaling_model``'s for the same size and separator mode.

On the CPU the same table sums the host time of each torch operation
(there are no kernels); its numbers are CPU times, not device times, and
waiting is not measured.

    python -m aprilsam_tpu_torch.schur_stages [--poses 100000]
        [--blocks 64] [--dtype float64] [--device cpu] [--ranks N]

The last line is the JAX script's JSON (at the largest size), with the
card's name and power limit; the line before it holds every figure,
unrounded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

STAGES = ("assembly", "interior Cholesky", "triangular solves",
          "Schur update", "separator reduction", "separator solve",
          "back-substitution", "interiors gather", "other")
# the stages that divide by the rank count, and those that do not
BLOCK_STAGES = ("assembly", "interior Cholesky", "triangular solves",
                "Schur update", "back-substitution")
SEP_STAGES = ("separator reduction", "separator solve")
# the stages made of collectives, whose time holds the waiting for the
# other ranks
COMM_STAGES = ("separator reduction", "interiors gather")
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
# timed solve pairs per Gauss-Newton-iteration time, of which the median
REPEATS = 3


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
    ap.add_argument("--ranks", type=int, default=None,
                    help="spawn this many ranks (NCCL: one card each) and "
                         "profile every mesh size of scaling.py")
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
    if rng == "schur.backsub":
        if _collective(name) or _collective(op):
            return "interiors gather"
        return "back-substitution"
    return "other"          # copies to the host, the states' update


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
    once).  On the card, "collectives" lists the collectives' kernels in
    the order they started: [start ns, duration ns, stage]."""
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
    comms = []

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
                stage = classify(*where, name)
                add(stage, name, k.duration_ns() / 1e3)
                if stage in COMM_STAGES:
                    comms.append([k.start_ns(), k.duration_ns(), stage])
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
        "collectives": sorted(comms),
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


def iteration_times(mesh, g, part, dtype, sep_dist=None,
                    gn_iters: int = 2) -> dict:
    """The JAX script's timings of schur_solve on `mesh`, REPEATS times
    over: after a warm full solve (the group's first collectives), a full
    `gn_iters` solve and a gn_iters=1 solve, each clock started after a
    barrier and ended on every rank's card.  Per Gauss-Newton iteration:
    the median over the repeats of (T(gn_iters) - T(1)) / (gn_iters - 1),
    each T the slowest rank's, so the same on every rank.  Also the
    medians of the two solves, every repeat's pair ("runs_s"), this
    rank's peak device memory over the timed solves (None on the CPU) and
    the last full solve's states."""
    import torch

    from .parallel.dist import clocked, slowest
    from .parallel.schur import schur_solve

    def solve(n):
        return schur_solve(mesh, g, part, gn_iters=n, dtype=dtype,
                           sep_dist=sep_dist)

    cuda = mesh.device.type == "cuda"
    solve(gn_iters)
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    full, one = [], []
    for _ in range(REPEATS):
        t, states = clocked(mesh, lambda: solve(gn_iters))
        full.append(t)
        one.append(clocked(mesh, lambda: solve(1))[0])
    peak = torch.cuda.max_memory_allocated(mesh.device) if cuda else None
    both = slowest(mesh, full + one)
    full, one = both[:REPEATS], both[REPEATS:]
    per_gn = [(a - b) / max(1, gn_iters - 1) for a, b in zip(full, one)]
    return {"t_total_s": float(np.median(full)),
            "t_gn1_s": float(np.median(one)),
            "t_per_gn_s": float(np.median(per_gn)),
            "runs_s": [list(p) for p in zip(full, one)],
            "max_memory_allocated": peak, "states": states}


def profile_stages(mesh, g, part, gn_iters: int = 2, dtype=np.float32,
                   peaks=None, out=print) -> dict:
    """iteration_times, then the profiled iteration, on this rank of
    `mesh`.  `peaks` are the card's published rates (None on the CPU: no
    bound).  Returns every figure, the final states, the collectives this
    rank issued in the profiled iteration ({kind: [count, bytes]}, kinds
    as scaling_model's) and, on a mesh of one rank, the projection."""
    from torch.profiler import ProfilerActivity, profile

    from .parallel.dist import clocked
    from .parallel.schur import schur_solve
    from .scaling import graph_chi2
    from .scaling_model import counted_collectives

    cuda = mesh.device.type == "cuda"
    res = iteration_times(mesh, g, part, dtype, gn_iters=gn_iters)
    for i, (full, one) in enumerate(res["runs_s"]):
        out(f"run {i}: full solve {full:.2f}s, gn_iters=1 {one:.2f}s")
    out(f"per-GN-iteration {res['t_per_gn_s']:.2f}s (the median of "
        f"{len(res['runs_s'])})")

    # the barrier's kernel and its wait stay out of the profiled iteration
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with counted_collectives() as counted:
        with profile(activities=acts) as prof:
            clocked(mesh, lambda: schur_solve(mesh, g, part, gn_iters=1,
                                              dtype=dtype))
    table = stage_table(prof, cuda)
    b = bound(part, dtype, peaks)
    if "ms" in b:
        b["share_of_gn_iteration"] = b["ms"] / (res["t_per_gn_s"] * 1e3)
    sizes = [len(i) for i in part.interiors]
    res.update({
        "chi2_initial": g.chi2(), "chi2": graph_chi2(g, res["states"]),
        "profile": table, "bound": b,
        "ni_max": part.ni_max, "ni_mean": float(np.mean(sizes)),
        "imbalance": part.ni_max / float(np.mean(sizes)),
        "ns": part.ns, "nsl": part.nsl, "counted": dict(counted),
    })
    if mesh.size == 1:
        res["projection"] = projection(table, g, part)
    return res


def stages_rank(mesh, args, meshes: dict = None) -> dict:
    """Run on each rank of the world `mesh`: the graph, its partition and
    profile_stages at each mesh size this rank takes part in (`meshes`,
    from parallel/dist.py:subgroups, made here when not given; the ranks
    outside a size wait at a barrier).  Rank 0 adds scaling_model's
    collectives for each size on this partition.  Returns {"rank",
    "sizes": {k: profile_stages(...) without the states, with "finite"},
    "model": {k: {kind: [count, bytes]}}}."""
    import torch

    from .parallel.dist import barrier, subgroups
    from .parallel.schur import default_sep_dist, partition_graph
    from .scaling import mesh_sizes
    from .scaling_model import scaling_graph, trace_collectives
    from .utils.card import card_peaks

    cuda = mesh.device.type == "cuda"
    g = scaling_graph(args.poses, args.closure_prob)
    part = partition_graph(g, args.blocks)
    dtype = np.float64 if args.dtype == "float64" else np.float32
    peaks = (card_peaks(torch.cuda.get_device_name(mesh.device))
             if cuda else None)
    out = {"rank": mesh.rank, "sizes": {}, "model": {}}
    sizes = mesh_sizes(mesh.size, args.blocks)
    meshes = meshes or subgroups(mesh, sizes)
    for k in sizes:
        if meshes[k] is not None:
            res = profile_stages(meshes[k], g, part, args.gn_iters, dtype,
                                 peaks, out=lambda m: None)
            res["finite"] = bool(np.all(np.isfinite(res.pop("states"))))
            out["sizes"][k] = res
        barrier(mesh)
    if mesh.rank == 0:
        for k in sizes:
            out["model"][k] = trace_collectives(
                g, part, k, default_sep_dist(part, k), dtype=dtype)
    return out


def waiting(timelines: list) -> list:
    """Each rank's waiting in its collectives, by stage (ms), from the
    ranks' collective kernels ([start ns, duration ns, stage] in order of
    start, the same collectives in the same order on every rank): in
    collective i a rank waits from its own kernel's start until the last
    rank's kernel starts, at most the kernel's length.  None where the
    ranks' lists do not pair up (or hold no kernels: on the CPU)."""
    n = {len(t) for t in timelines}
    if len(n) != 1 or 0 in n or any(
            len({t[i][2] for t in timelines}) != 1
            for i in range(len(timelines[0]))):
        return [None] * len(timelines)
    out = [dict.fromkeys(COMM_STAGES, 0.0) for _ in timelines]
    for i in range(len(timelines[0])):
        last = max(t[i][0] for t in timelines)
        for r, t in enumerate(timelines):
            start, dur, stage = t[i]
            out[r][stage] += min(max(last - start, 0), dur) / 1e6
    return out


def combine(results: list) -> dict:
    """Every rank's figures by size, the waiting in each rank's
    collectives, the measured T(k) (the slowest rank's per-GN-iteration
    time) and E(k) = T(1) / (k T(k)) beside the projection from the
    one-rank stages, and the collectives counted on each rank beside
    scaling_model's."""
    sizes = sorted(results[0]["sizes"])
    by_size = {k: [r["sizes"][k] for r in results if k in r["sizes"]]
               for k in sizes}
    for k, ranks in by_size.items():
        waits = waiting([r["profile"].pop("collectives") for r in ranks])
        for r, w in zip(ranks, waits):
            r["profile"]["waiting_ms"] = w
    T = {k: max(r["t_per_gn_s"] for r in ranks) * 1e3
         for k, ranks in by_size.items()}
    proj = {p["ndev"]: p for p in by_size[1][0].get("projection", [])}
    measured = []
    for k in sizes:
        row = {"ndev": k, "T_ms": T[k], "E": T[1] / (k * T[k])}
        if k in proj:
            row.update(projected_E=proj[k]["E"],
                       projected_E_with_rest=proj[k]["E_with_rest"])
        measured.append(row)
    model = results[0]["model"]
    collectives = {k: {"counted": [r["counted"] for r in ranks],
                       "model": model[k],
                       "equal": all(r["counted"] == model[k]
                                    for r in ranks)}
                   for k, ranks in by_size.items()}
    return {"sizes": by_size, "measured": measured,
            "collectives": collectives}


def report(res: dict, out=print) -> None:
    """The stage table (with the waiting in the collectives where it was
    measured), the idle share, the memory, the bound and, for one rank,
    the projection."""
    p = res["profile"]
    waits = p.get("waiting_ms")
    out(f"profiled iteration: {p['iteration_ms']:.3f} ms "
        f"(per-GN-iteration unprofiled {res['t_per_gn_s'] * 1e3:.3f} ms)")
    out(f"{'stage':<22}{'ms':>12}{'launches':>10}{'share':>8}"
        + (f"{'waiting ms':>12}" if waits else ""))
    for s, v in p["stages"].items():
        w = f"{waits[s]:>12.3f}" if waits and s in waits else ""
        out(f"{s:<22}{v['ms']:>12.3f}{v['launches']:>10}"
            f"{v['share']:>8.3f}{w}")
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
    if "projection" not in res:
        return
    out("projection from one rank's stages (no communication time):")
    for r in res["projection"]:
        mb = "".join(f"  {k[3:]} {v:.2f} MB" for k, v in r.items()
                     if k.startswith("MB_"))
        out(f"  ndev={r['ndev']}: T {r['T_ms']:.3f} ms  E {r['E']:.4f}  "
            f"E with the rest {r['E_with_rest']:.4f}{mb}")


def _hits_line(hits: dict) -> str:
    return ", ".join(f"{kind} {c} x, {b / 1e6:.4f} MB"
                     for kind, (c, b) in sorted(hits.items()))


def report_ranks(comb: dict, out=print) -> None:
    """Each size's table for each rank, the measured efficiency beside the
    projection, and the counted collectives beside the model's."""
    for k, ranks in comb["sizes"].items():
        for r, res in enumerate(ranks):
            out(f"--- {k} rank{'s' if k > 1 else ''}, rank {r}:")
            report(res, out)
    out("measured (the slowest rank) against the projection:")
    for m in comb["measured"]:
        proj = (f"  projected E {m['projected_E']:.4f}, with the rest "
                f"{m['projected_E_with_rest']:.4f}"
                if "projected_E" in m else "")
        out(f"  ndev={m['ndev']}: T {m['T_ms']:.3f} ms  E {m['E']:.4f}"
            f"{proj}")
    for k, c in comb["collectives"].items():
        out(f"collectives per iteration at {k} rank{'s' if k > 1 else ''}"
            f" ({'equal to' if c['equal'] else 'NOT equal to'} the "
            "model's on every rank):")
        out(f"  counted on rank 0: {_hits_line(c['counted'][0])}")
        out(f"  scaling_model:     {_hits_line(c['model'])}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .parallel import one_rank_group
    from .parallel.dryrun import run_ranks
    from .utils import resolve_device
    from .utils.card import card_line, link_line

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    card = card_line() if cuda else None
    link = link_line() if cuda and args.ranks else None
    print(f"platform: {'gpu' if cuda else 'cpu'}"
          + (f" ({card}; {link})" if link else
             f" ({card})" if card else ""), flush=True)
    t0 = time.perf_counter()
    if args.ranks:
        results = run_ranks(stages_rank, args.ranks, args, timeout=3600.0,
                            device=device.type)
    else:
        with one_rank_group(device) as mesh:
            results = [stages_rank(mesh, args)]
    print(f"{len(results)} rank{'s' if len(results) > 1 else ''} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    comb = combine(results)
    report_ranks(comb, out=lambda m: print(m, flush=True))
    one = comb["sizes"][1][0]
    top = comb["measured"][-1]["ndev"]
    last = comb["sizes"][top][0]
    print(json.dumps({**one, "ranks": args.ranks or 1, "link": link,
                      "measured": comb["measured"],
                      "collectives": comb["collectives"],
                      "by_size": comb["sizes"]}), flush=True)
    print(json.dumps({
        "poses": args.poses, "blocks": args.blocks, "ns": last["ns"],
        "ni_max": last["ni_max"], "platform": "gpu" if cuda else "cpu",
        "card": card, "dtype": args.dtype, "ranks": top,
        "t_total_s": round(last["t_total_s"], 2),
        "t_per_gn_s": round(comb["measured"][-1]["T_ms"] / 1e3, 2),
        "final_chi2": round(float(last["chi2"]), 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
