"""One run of one benchmark cell of the PyTorch and CUDA port
(aprilsam_tpu_torch) on the cards of this machine.

    python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout that holds BENCHMARK.json.  Everything a
cell is made of is found by name:

  BENCHMARK.json                 the cells, their end-to-end and per-layer
                                 metrics, and each configuration's file;
  benchmark/configs/C.json       a configuration: the generator's
                                 parameters, the prior the replay adds and
                                 the solver's settings;
  benchmark/workloads/W.json     a cell: its configuration, its traffic
                                 (driver, arrivals, warm-up) and the
                                 check's sampling and limits;
  benchmark/drivers/D.py         a driver (class Driver: build, run_pass,
                                 span_targets; GROUP where it runs on a
                                 process group even on one card);
  benchmark/gen/G.py             a generator of inputs from the seed;
  benchmark/end_to_end/M.py      an end-to-end metric (read(run));
  benchmark/layer_metrics/M.py   a per-layer metric (read(records)), which
                                 returns None where it finds nothing.

A run: the first pass's graph from --seed, the driver's set-up (a
throwaway warm-up where the cell asks for one), then whole passes
back to back until their timed seconds reach --seconds (the last pass
completes), each on a graph of its own (pass_graph).  Set-up is
everything from the process's start to the first pass's clock.  A cell
of N > 1 chips runs as N ranks, one process and one card each
(ranks.py): this process is rank 0 and starts the others, every rank
runs the same passes, a pass's seconds are the slowest rank's, and only
rank 0 prints and runs the check.  With
--trace 1 the first pass runs under torch.profiler with host spans around
the program's layers, and the run reports the per-layer metrics; with
--trace 0 the end-to-end ones.  After the window the program's state is
freed and the plain reference judges every answer the run read
(check.py).  The last line of standard output is the result; the last
lines of standard error each number compared, beside its limit.

Exits 3 without a result when the machine has no card or fewer than the
cell asks for, 4 when JAX or the JAX package is loaded in a rank's
process after the window, and 5 (ranks.RANK_FAILED) or 1 when a rank
fails.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import trace  # noqa: E402
from .check import judge  # noqa: E402
from .roofline import K1_KERNELS  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "aprilsam_tpu")
# build and kernel caches, at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module."""
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, root: str = ROOT) -> dict:
    """The cell `name` of BENCHMARK.json with everything it names: its
    configuration and workload files, and its metrics (a per-layer metric
    is read in the cells its `workloads` lists)."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json; cells: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return {"cell": cell, "end_to_end": e2e, "per_layer": layer,
            "config": load_json(root, configs[cell["config"]]["file"]),
            "workload": load_json(BENCH, "workloads", name + ".json")}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def checked_steps(seed: int, poses: int, per_pass: int) -> list:
    """The steps whose answers every pass reads besides its end:
    `per_pass` steps drawn from the seed among 1 .. poses - 2 (none in a
    mode that defers its steps, whose answers are read at pass ends
    alone)."""
    n = min(per_pass, max(poses - 2, 0))
    rng = np.random.default_rng([seed, 0xC4EC])
    return sorted(rng.choice(np.arange(1, poses - 1), n,
                             replace=False).tolist()) if n else []


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def host_line() -> str:
    """The host's processor, its cores and their current clocks (the
    host-bound cells' rates follow them), and the load average."""
    model, mhz = "unknown", []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key.strip() == "model name":
                    model = val.strip()
                elif key.strip() == "cpu MHz":
                    mhz.append(float(val))
        load = os.getloadavg()
    except OSError:
        load = ()
    clocks = (f"{min(mhz):.0f}-{max(mhz):.0f} MHz" if mhz
              else "clocks unknown")
    return (f"{model}; {os.cpu_count()} cores, {len(os.sched_getaffinity(0))}"
            f" usable; {clocks}; load {' '.join(f'{v:.2f}' for v in load)}")


def traced_pass(driver, rep, checked, world) -> tuple:
    """One pass under torch.profiler (device activity) with host spans
    around the program's layers (the driver's span_targets).  Returns the
    pass and its records.  The traced window is the world's: from the
    first rank's start to the last rank's finish, on the host's monotonic
    clock, which every rank of the machine shares; each rank's busy time
    is read inside it."""
    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with trace.Spans(driver.span_targets()) as spans, prof:
        torch.cuda.synchronize()
        mark = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        w0 = time.perf_counter_ns()
        res = driver.run_pass(rep, checked)
        w1 = time.perf_counter_ns()
    ends = world.gather((w0, w1))
    w0, w1 = min(e[0] for e in ends), max(e[1] for e in ends)
    names, starts, durs = trace.device_records(prof)
    offset = trace.clock_offset(names, starts, mark)
    keep = np.asarray([trace.MARKER not in n for n in names], dtype=bool)
    names = [n for n, k in zip(names, keep) if k]
    starts, durs = starts[keep], durs[keep]
    bs, be = trace.busy_intervals(starts, durs)
    if offset is not None:
        lo, hi = w0 + offset, w1 + offset
        busy = int(np.sum(np.clip(be, lo, hi) - np.clip(bs, lo, hi)))
        idle = trace.idle_by_span(bs, be, (lo, hi), spans.records, offset,
                                  other="harness, between steps")
    else:
        busy, idle = int(np.sum(be - bs)), None
    k1 = np.asarray([any(k in n for k in K1_KERNELS) for n in names],
                    dtype=bool)
    rec = {"poses": res["poses"], "pass_s": res["seconds"],
           "window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
           "spans": {k: list(v) for k, v in spans.totals.items()},
           "counters": res.get("counters", {}),
           "growths": res.get("growths", []),
           "captures": res.get("captures", 0),
           "capture_s": res.get("capture_s", 0.0),
           "k1_launches": res.get("k1_launches", []),
           "k1_device_s": float(np.sum(durs[k1])) / 1e9,
           "device_kind": torch.cuda.get_device_name(0),
           "device_ops": trace.by_name(names, durs), "idle_gaps": idle}
    return res, rec


def pass_graph(config: dict, seed: int, j: int, pool: dict = None) -> dict:
    """Pass j's graph: the configuration's world, measured with noise
    drawn from (seed, j).  A run's passes are that many sessions in one
    world, so that a run's figures average over as many draws of the
    noise, on which a replay's work depends (the affected sets the
    relinearization makes).

    Where the cell names a `pool` ({"seed": s, "draws": P}), every run
    replays the same P draws of the noise, those of (s, 0) .. (s, P - 1),
    in an order drawn from `seed` (pass j takes the order's j mod P-th):
    so that a run of P passes does the same work whatever its seed."""
    gen = load_file("gen", config["graph"]["generator"])
    params = {k: v for k, v in config["graph"].items() if k != "generator"}
    if pool is None:
        return gen.generate(seed=[seed, j], **params)
    order = np.random.default_rng([seed, 0x9001]).permutation(pool["draws"])
    return gen.generate(seed=[pool["seed"], int(order[j % len(order)])],
                        **params)


def run_cell(args, spec: dict, device: str = "cuda", world=None) -> dict:
    """The run: set-up, the window, and the check.  Returns the result
    line's parts on rank 0 (None on the others); `device` "cpu" is the
    tests' (no trace there).  `world` is this process's place in the
    cell's world (ranks.py), None on rank 0, which launches it."""
    from . import ranks

    wl = spec["workload"]
    drivers = load_file("drivers", wl["driver"])
    if world is None:
        world = ranks.World.launch(
            spec["cell"]["chips"], device, getattr(drivers, "GROUP", False),
            run_rank, {"args": vars(args), "spec": spec, "device": device},
            wl.get("collective_timeout_s"))
    try:
        return _run(args, spec, drivers, world)
    except BaseException:
        world.abort()
        raise


def run_rank(world, args: dict, spec: dict, device: str) -> None:
    """run_cell on rank 1..N-1 of a world that rank 0 launched."""
    run_cell(argparse.Namespace(**args), spec, device, world)


def _run(args, spec: dict, drivers, world) -> dict:
    import torch

    config, wl = spec["config"], spec["workload"]
    pool = wl.get("noise_pool")
    graphs = [pass_graph(config, args.seed, 0, pool)]
    world.join()
    driver = drivers.Driver(config, wl, world.device, graphs[0])
    steps = checked_steps(args.seed, len(graphs[0]["truth"]),
                          wl["check"]["steps_per_pass"])
    rep = driver.build(graphs[0])
    world.barrier()
    setup_s = time.perf_counter() - T0
    passes, between, rec = [], [], None
    window = 0.0
    while True:
        if args.trace and not passes:
            res, rec = traced_pass(driver, rep, steps, world)
        else:
            res = driver.run_pass(rep, steps)
        del rep
        drivers.collect(driver.device)
        res["seconds"] = world.slowest(res["seconds"])
        for a in res["answers"]:
            if "digest" in a:
                a["digests"] = world.gather(a.pop("digest"))
            if world.rank:
                a["states"] = None
        passes.append(res)
        window += res["seconds"]
        if window >= args.seconds:
            break
        t = time.perf_counter()
        graphs.append(pass_graph(config, args.seed, len(passes), pool))
        rep = driver.build(graphs[-1])
        between.append(time.perf_counter() - t)
        world.barrier()
    if rec is not None:
        rec["untraced_step_s"] = [p.get("step_s") for p in passes[1:]]
    cuda = driver.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(driver.device) if cuda else 0
    found = forbidden_modules()
    answers = [dict(a, graph=j) for j, p in enumerate(passes)
               for a in p.pop("answers")]
    del driver
    drivers.collect(world.device)
    each = world.gather({"peak": peak, "forbidden": found,
                         "busy_s": rec and rec["busy_s"]})
    world.close()
    if world.rank:
        return None
    out = {"setup_s": setup_s, "passes": passes, "between_s": between,
           "records": rec, "memory_peak_bytes": peak, "forbidden": found,
           "digests": [a["digests"] for a in answers if "digests" in a]}
    if world.size > 1:
        out["memory_peak_bytes"] = max(r["peak"] for r in each)
        out["memory_peak_bytes_by_rank"] = [r["peak"] for r in each]
        out["forbidden"] = sorted({m for r in each for m in r["forbidden"]})
        if rec is not None:
            # one window, the world's; each card's busy time in it
            rec["busy_s_by_rank"] = [r["busy_s"] for r in each]
            rec["busy_s"] = statistics.mean(rec["busy_s_by_rank"])
    out["verdict"] = judge(graphs, config["prior"], answers,
                           wl["check"]["limits"], world.device,
                           wl["check"].get("reference", "posegraph"))
    return out


def metrics_of(spec: dict, run: dict, traced: bool) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer ones
    (traced), each read by its file; a per-layer reader that finds
    nothing leaves its metric out."""
    out = {}
    if traced:
        for m in spec["per_layer"]:
            v = load_file("layer_metrics", m["name"]).read(run["records"])
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            v = load_file("end_to_end", m["name"]).read(run)
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(spec: dict, run: dict, traced: bool, kind: str) -> dict:
    """The result: correct, attempted (poses stepped), failed (answers
    out of a limit), the metrics, the device, with --trace 1 the
    breakdown, and last the numbers compared beside their limits."""
    v = run["verdict"]
    line = {"correct": v["correct"],
            "attempted": sum(p["poses"] for p in run["passes"]),
            "failed": v["failed"],
            "metrics": metrics_of(spec, run, traced),
            "device": {"platform": "gpu", "kind": kind,
                       "count": spec["cell"]["chips"],
                       "memory_peak_bytes": run["memory_peak_bytes"]}}
    if "memory_peak_bytes_by_rank" in run:
        line["device"]["memory_peak_bytes_by_rank"] = \
            run["memory_peak_bytes_by_rank"]
    if traced:
        rec = run["records"]
        line["device"].update(busy_s=rec["busy_s"],
                              window_s=rec["window_s"])
        if "busy_s_by_rank" in rec:
            line["device"]["busy_s_by_rank"] = rec["busy_s_by_rank"]
        line["breakdown"] = {"device_ops": rec["device_ops"]}
        if rec["idle_gaps"] is not None:
            line["breakdown"]["idle_gaps"] = rec["idle_gaps"]
    line["check"] = v["numbers"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)

    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; host: {host_line()}", flush=True)
    return report(args, spec, run_cell(args, spec), card,
                  torch.cuda.get_device_name(0))


def report(args, spec: dict, run: dict, card: str, kind: str) -> int:
    """Rank 0's output after a run: what the passes did, the answers
    judged, with --trace 1 the traced pass's figures, and last the result
    line; the numbers compared, beside their limits, last on standard
    error.  Returns the exit code (4 where JAX was loaded)."""
    passes = run["passes"]
    info = {"passes_s": [p["seconds"] for p in passes],
            "between_passes_s": run["between_s"],
            "setup_s": run["setup_s"],
            "poses_per_pass": passes[0]["poses"],
            "counters": passes[-1].get("counters"),
            "captures_in_passes": [p.get("captures") for p in passes]}
    if any("info" in p for p in passes):
        info["pass_info"] = [p.get("info") for p in passes]
    if "memory_peak_bytes_by_rank" in run:
        info["memory_peak_bytes_by_rank"] = run["memory_peak_bytes_by_rank"]
    print(json.dumps(info), flush=True)
    print(json.dumps({"answers": run["verdict"]["answers"]}), flush=True)
    found = run["forbidden"] or forbidden_modules()
    if found:
        print(f"loaded in the run's process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    if args.trace:
        rec = run["records"]
        untraced = [p["seconds"] for p in passes[1:]]
        print(json.dumps({
            "traced_pass_s": rec["pass_s"],
            "untraced_pass_s_median": (statistics.median(untraced)
                                       if untraced else None),
            "power_limit": card, "spans_ms": rec["spans"],
            "k1_launches": rec["k1_launches"],
            "k1_device_s": rec["k1_device_s"]}), flush=True)
    line = result_line(spec, run, bool(args.trace), kind)
    print(json.dumps(line), flush=True)
    for name, n in line["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr, flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
