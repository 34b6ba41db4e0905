"""Smoke run of the PyTorch port (aprilsam_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):
  1. device: the card's name and power limit (nvidia-smi); exits 1 when
     torch.cuda.is_available() is False;
  2. build: the CUDA kernel tri_inv (nvcc, sm_90a) and the native C runtime,
     in parallel, from the sources in this checkout, into
     aprilsam_tpu_torch/build/ (gitignored);
  3. kernel K1 (tri_inv) against its plain PyTorch version on the card at
     [32,384,384], [8,96,96] and [1,48,48] in float64 and float32, with the
     kernel's, the plain version's and the torch.linalg.solve_triangular
     yardstick's times (CUDA events, after warm-up) beside the bound;
  4. the tutorial dogleg through IncrementalSolver on the card (chi2
     7.805041);
  5. the main path: Replay(manhattan_world(3500, seed=0)) on the card in
     float64 with the default SolverConfig and the wall-clock gate off,
     held against the JAX package's golden (aprilsam_tpu_torch/golden/):
     per-step chi2 and the fast/full/batch census; the tri_inv launch
     count of that run equals its full-path dispatches;
  6. one JSON line listing every ported kernel; the card's line; and the
     result line {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "aprilsam_tpu_torch", "golden",
                      "manhattan3500_seed0.txt")

# Published peaks (NVIDIA data sheets, dense), keyed by the exact name
# torch.cuda.get_device_name reports: memory bytes/s, and the float64 (FP64
# tensor core) and float32 (non-tensor) operation rates.
CARDS = {
    "NVIDIA H100 80GB HBM3":               # SXM5
        {"bytes_per_s": 3.35e12, "float64": 67e12, "float32": 67e12},
    "NVIDIA H100 PCIe":
        {"bytes_per_s": 2.0e12, "float64": 51e12, "float32": 51e12},
    "NVIDIA H100 NVL":
        {"bytes_per_s": 3.9e12, "float64": 60e12, "float32": 60e12},
}
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
SHAPES = [(32, 384, 384), (8, 96, 96), (1, 48, 48)]


def card_peaks(name: str) -> dict:
    if name not in CARDS:
        raise RuntimeError(f"no published peaks for {name!r}; add the card to "
                           "chip_smoke.CARDS")
    return CARDS[name]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def tri_inv_bound_ms(B: int, N: int, dtype, peaks) -> tuple:
    """Least time for X = T^-1 on this card: read the upper triangle of T
    once (nothing below the diagonal is read) and write all of X once,
    against N^3/3 operations (exactly 2*(N-1)N(N+1)/6 multiply-adds plus
    N(N+1)/2 divisions per matrix; no early exit, so no data dependence)."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = B * (N * (N + 1) // 2 + N * N) * elt
    ops = B * (2 * (N - 1) * N * (N + 1) // 6 + N * (N + 1) // 2)
    t_bytes = nbytes / peaks["bytes_per_s"] * 1e3
    t_ops = ops / peaks["float64" if dtype == torch.float64
                        else "float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def panel_like_triangles(B: int, N: int, dtype, seed: int) -> torch.Tensor:
    """Seeded well-conditioned upper triangles; the last matrix has its
    trailing quarter identity-padded as panel_backsub pads inactive rows."""
    rng = np.random.default_rng(seed)
    T = np.triu(rng.standard_normal((B, N, N)) * (0.5 / np.sqrt(N)), 1)
    T[:, np.arange(N), np.arange(N)] = 1.0 + rng.random((B, N))
    k = N - N // 4
    T[-1, k:, :] = 0.0
    T[-1, :, k:] = 0.0
    T[-1, np.arange(k, N), np.arange(k, N)] = 1.0
    return torch.from_numpy(T).to(dtype=dtype, device="cuda").contiguous()


def check_tri_inv(K, peaks) -> dict:
    """Phase 3.  Returns the [32,384,384] float64 measurement (the main
    path's shape and type) for the kernels line."""
    main = None
    for (B, N, _) in SHAPES:
        for dtype in (torch.float64, torch.float32):
            T = panel_like_triangles(B, N, dtype, seed=B * 1000 + N)
            X = K.tri_inv(T)
            torch.cuda.synchronize()
            ref = K.tri_inv_plain(T)
            abs_err = (X - ref).abs().max().item()
            rel_err = abs_err / ref.abs().max().item()
            if not torch.isfinite(X).all() or rel_err > TOL[dtype]:
                raise AssertionError(
                    f"tri_inv [{B},{N},{N}] {dtype}: max relative error "
                    f"{rel_err} > {TOL[dtype]}")
            if torch.tril(X, -1).abs().max().item() != 0.0:
                raise AssertionError("tri_inv wrote below the diagonal")
            eye = torch.eye(N, dtype=dtype, device="cuda")
            kernel_ms = cuda_ms(lambda: K.tri_inv(T))
            plain_ms = cuda_ms(lambda: K.tri_inv_plain(T))
            library_ms = cuda_ms(lambda: torch.linalg.solve_triangular(
                T, eye.expand(T.shape), upper=True))
            bound_ms, bound_by = tri_inv_bound_ms(B, N, dtype, peaks)
            row = {"kernel": "tri_inv", "shape": [B, N, N],
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": abs_err, "max_rel_err": rel_err,
                   "tol_rel": TOL[dtype], "kernel_ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_us": bound_ms * 1e3, "bound_by": bound_by}
            print(json.dumps(row), flush=True)
            if (B, N, dtype) == (32, 384, torch.float64):
                main = row
    return main


def run_tutorial() -> None:
    """Phase 4 (tests/test_incremental.py's tutorial dogleg)."""
    from aprilsam_tpu_torch.geometry import np_xyt_inv_mul
    from aprilsam_tpu_torch.graph import FactorGraph
    from aprilsam_tpu_torch.solver import IncrementalSolver, SolverConfig

    cfg = SolverConfig(node_capacity=512, factor_capacity=2048,
                       row_block_capacity=64, panel_nodes=32,
                       wallclock_gate=False)
    s = IncrementalSolver(cfg, device="cuda")
    g = FactorGraph()
    g.add_node([0, 0, 0], init=[0, 0, 0])
    g.add_factor_xytpos(0, [0, 0, 0], np.diag([1e4, 1e4, 1e3]))
    s.solve(g)
    W = np.diag([1 / 0.1 ** 2, 1 / 0.1 ** 2, 1 / np.radians(1.0) ** 2])
    for i in range(1, 6):
        g.add_node([i, 0, 0], init=[i, 0, 0])
        g.add_factor_xyt(i - 1, i, np_xyt_inv_mul(g.init[i - 1], g.init[i]), W)
        if i == 5:
            g.add_factor_xyt(0, 5, np_xyt_inv_mul(np.zeros(3),
                                                  np.array([5.0, 1, 0])), W)
        info = s.update(g)
    if abs(info.chi2 - 7.805041) >= 1e-4:
        raise AssertionError(f"tutorial chi2 {info.chi2} != 7.805041")
    ys = s.ds.state[:6, 1].cpu().numpy()
    want = [0.0, 0.156098, 0.323291, 0.496825, 0.671944, 0.843894]
    if np.max(np.abs(ys - want)) >= 1e-4:
        raise AssertionError(f"tutorial y values {ys} != {want}")
    print(json.dumps({"phase": "tutorial", "chi2": info.chi2,
                      "y": ys.tolist()}), flush=True)


def read_golden():
    steps, paths, chi2 = [], [], []
    with open(GOLDEN) as f:
        for line in f:
            if line.startswith("#"):
                continue
            k, p, c = line.split()
            steps.append(int(k))
            paths.append(p)
            chi2.append(float(c))
    if steps != list(range(len(steps))):
        raise AssertionError("golden file steps are not 0..n-1")
    return paths, np.asarray(chi2)


def run_main_path(K, card: str) -> int:
    """Phase 5.  Returns the tri_inv launches of the run."""
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.replay import Replay
    from aprilsam_tpu_torch.solver import SolverConfig

    gold_paths, gold_chi2 = read_golden()
    n = len(gold_paths)
    loaded = manhattan_world(n, seed=0)
    rep = Replay(loaded, SolverConfig(wallclock_gate=False), device="cuda")
    if rep.solver.ds.state.dtype != torch.float64:
        raise AssertionError("the main path runs in float64")
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rep.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = K.launches

    hist = rep.solver.chi2_history()
    paths = [r.path for r in res]
    if len(res) != n or hist.shape != (n,):
        raise AssertionError(f"{len(res)} steps, {hist.shape} chi2 entries; "
                             f"golden has {n}")
    if not np.all(np.isfinite(hist)):
        raise AssertionError("non-finite chi2 in the replay")
    # relative 1e-6; chi2 values at rounding level of zero (the first steps,
    # ~1e-28) are compared absolutely
    diff = np.abs(hist - gold_chi2)
    bad = np.nonzero(diff > 1e-6 * np.abs(gold_chi2) + 1e-12)[0]
    census = {p: paths.count(p) for p in ("fast", "full", "batch")}
    gold_census = {p: gold_paths.count(p) for p in ("fast", "full", "batch")}
    path_mismatch = sum(a != b for a, b in zip(paths, gold_paths))
    full_dispatches = rep.solver.counters["full"]
    summary = {
        "phase": "replay", "graph": f"manhattan_world({n}, seed=0)",
        "dtype": "float64", "card": card, "steps": n,
        "seconds": secs, "poses_per_s": n / secs,
        "mean_step_ms": secs * 1e3 / n,
        "final_chi2": float(hist[-1]), "golden_final_chi2": gold_chi2[-1],
        "max_rel_chi2_err": float(np.max(diff / np.maximum(
            np.abs(gold_chi2), 1e-12))),
        "census": census, "golden_census": gold_census,
        "per_step_path_mismatches": path_mismatch,
        "full_dispatches": full_dispatches, "tri_inv_launches": launches,
    }
    print(json.dumps(summary), flush=True)
    if len(bad):
        k = int(bad[0])
        raise AssertionError(
            f"chi2 differs from the golden at {len(bad)} steps; first at "
            f"step {k}: {hist[k]!r} vs {gold_chi2[k]!r}")
    if census != gold_census:
        raise AssertionError(f"census {census} != golden {gold_census}")
    if launches != full_dispatches or launches < gold_census["full"]:
        raise AssertionError(
            f"tri_inv launched {launches} times for {full_dispatches} "
            "full-path dispatches")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script "
            "needs an NVIDIA card")
        return 1
    sys.path.insert(0, REPO)
    from aprilsam_tpu_torch import native
    from aprilsam_tpu_torch.kernels import tri_inv as K
    from aprilsam_tpu_torch.utils import setup_precision

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    setup_precision()
    log(f"chip_smoke: {kind} ({smi}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 2. build, one compiler process per source, started together
    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    with ThreadPoolExecutor(2) as ex:
        f_kernel = ex.submit(timed, K.build)
        f_native = ex.submit(timed, native.build)
        build_s = {"tri_inv.cu (nvcc sm_90a)": f_kernel.result(),
                   "sam_native.c (cc)": f_native.result()}
    print(json.dumps({"phase": "build", "seconds": build_s}), flush=True)

    # 3. the kernel against its plain version
    main_row = check_tri_inv(K, peaks)

    # 4-5. the tutorial, then the main path
    run_tutorial()
    launches = run_main_path(K, smi)
    if launches == 0:
        raise AssertionError("the main path never launched tri_inv")

    # 6. the kernels line, the card, the result
    print(json.dumps({"kernels": [{
        "name": "tri_inv", "route": "cuda",
        "source": "aprilsam_tpu_torch/csrc/tri_inv.cu",
        "replaces": K.REPLACES, "launches": launches,
        "max_abs_err": main_row["max_abs_err"],
        "max_rel_err": main_row["max_rel_err"],
        "shape": main_row["shape"], "dtype": main_row["dtype"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_us"] / 1e3,
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
