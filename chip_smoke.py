"""Smoke run of the PyTorch port (aprilsam_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):
  1. device: the card's name and power limit (nvidia-smi); exits 1 when
     torch.cuda.is_available() is False;
  2. build: the CUDA kernels tri_inv and frontal_qr (nvcc, sm_90a) and the
     native C runtime, in parallel, from the sources in this checkout, into
     aprilsam_tpu_torch/build/ (gitignored); the compiler's registers,
     static shared memory and spills for each kernel (-Xptxas -v);
  3. kernel K1 (tri_inv) against its plain PyTorch version on the card at
     [32,384,384], [8,96,96] and [1,48,48] in float64 and float32, at
     the main path's [B,384,384] float64, B = 1, 2, 4, 8, 16, and at the
     large-N replay's [16,768,768] and [128,768,768] in both, with the
     kernel's, the plain version's and the torch.linalg.solve_triangular
     yardstick's call times (CUDA events, after warm-up) beside the bound,
     and the device time of each CUDA kernel the kernel and the library
     launch (torch.profiler);
  3b. kernel K2 (frontal_qr, the frontal QR update) against its plain
     version (torch.linalg.qr, the sign flip, Q^T d; cuSOLVER on the card)
     at the per-step buckets' live fronts of an M3500 pass and at superstep
     shapes, float64 and float32: K2's device time (CUDA graph replays),
     the plain version's call time (CUDA events) and device time by kernel
     (torch.profiler), and the bound (its flops at the float64 peak, or the
     live triangle's bytes);
Every replay below runs on CUDA graphs: the solver first runs precompile
(its step, superstep and bundle signatures at 3500 poses) and the ladder
of its batch epoch's expansion or dense fallback, and after the replay each
phase prints its dispatches and graph replays by kind ("graphs"), which
must be equal: one replay per dispatch, none eager.
  4. the tutorial dogleg through IncrementalSolver on the card (chi2
     7.805041);
  5. the main path: Replay(manhattan_world(3500, seed=0)) on the card in
     float64 with the default SolverConfig and the wall-clock gate off,
     step by step, held against the JAX package's golden
     (aprilsam_tpu_torch/golden/): per-step chi2, path and the
     fast/full/batch census; the tri_inv launch count of that run, and the
     sum of its counts by shape, equal its full-path dispatches, and K2's
     its fast and full dispatches (its live columns beside them); after
     step CHECKPOINT_AT it saves the solver (checkpoint.save_solver);
  6. the throughput replays of the same graph, float64, in deferred mode
     at superstep_size=96 with the bench's union buckets, held against the
     JAX package's superstep golden: at policy_lag=0 (log_chi2 on) every
     metric-ring entry within relative 1e-6 and the counters equal; the
     bench config (policy_lag=3, policy_poll=2, log_chi2 off), then with
     the windowed sweep (8 panels, a full sweep every 8th), final chi2
     within 0.05 of the JAX package's; poses/s, the counters, and the
     synchronizing CUDA calls inside each superstep dispatch
     (torch.cuda.set_sync_debug_mode), listed by call site, which must be
     none; tri_inv launches equal the swept supersteps plus flush()'s
     sweeps;
  7. the CLI on the card: the graph written with the port's binary writer,
     then cli.main --graphpath --superstep 96 (the CLI's config:
     policy_lag=2, the default ladder), final chi2 within 0.05 of the JAX
     package's;
  8. the device batch epochs: BatchSolver on manhattan_world(3500, seed=0),
     float64, with batch_backend="device" (dense) and "panel", each held
     against the host epoch on the same graph (same ordering, chi2, R, y
     and states within EPOCH_TOL) and timed beside it (median of 3 after a
     warm-up, host clock ending in torch.cuda.synchronize(); the epochs
     replay the graphs their first solve captured), the host's
     time to plan and enqueue a lazy epoch, and its symbolic phase and
     panel plan alone; the panel epoch's back-substitution launches K1
     once at [32,384,384];
  9. the superstep replays of phase 6 with batch_backend="panel", against
     the JAX package's panel golden: at policy_lag=0 every ring entry
     within relative 1e-6 and the counters equal, the bench config's final
     chi2 within 0.05; both with the golden's epochs by backend, no
     synchronizing call inside a superstep dispatch, and K1 launched once
     per swept superstep, flush() sweep and panel epoch;
 10. two per-step replays in bundles (bundle_size=8, policy_lag=8, mixed
     bundles; then with coalesce_full_solves), final chi2 within 0.05 of
     the JAX package's bundled golden, no synchronizing call inside a
     bundle dispatch, and K1 launched once per full step whose sweep was
     not coalesced plus once per coalesced sweep;
 11. checkpoint resume: a fresh solver loaded on the card from phase 5's
     file replays the remaining steps, held to the same golden lines and
     census; the file's bytes, the save and load ms, and K1's launches
     (path "checkpoint-resume");
 12. the distributed solves on a one-rank NCCL group: the multi-rank dry
     run (parallel/dryrun.py), then schur_solve on
     manhattan_world(100000, seed=0, closure_prob=0.02) in 64 blocks, two
     Gauss-Newton iterations, with the replicated and the block-cyclic
     separator, float64 (held to each other and to the host BatchSolver,
     SCHUR_TOL) and float32 (to each other), each held to the JAX
     package's solve of the graph (golden/schur100k_jax.npz: chi2, and in
     float64 the states of every 100th pose; multicard.JAX_TOL); the
     partition's sizes, ms per iteration and peak device memory of each
     run;
 13. the ahead-of-time surface: precompile for the per-step, S = 96
     bench, windowed and bundled configs, and the dense epoch's, the
     panel epoch's and the expansion's ladders, at 3500 poses:
     signatures, graphs, capture seconds by signature and in all, and the
     device memory they hold;
     then AOT_POSES poses per step, at S = 96 (bench config), at S = 96
     with panel epochs (the ring and the bench configs of phase 9) and in
     bundles of 8, eager (solver.graphs.enabled = False) and on graphs in
     the same call (the superstep replays three times each, in turn):
     poses/s, host ms per dispatch and per batch epoch, device operations
     per dispatch and the device's idle share (torch.profiler over a
     window), synchronizing calls per dispatch, K1's launches by shape
     and the chi2 ring: at policy_lag=0 equal in every run (the ring to
     relative 1e-9), lagged the final chi2 within CHI2_BAND (the lagged
     policy's reads depend on timing);
 14. float32 on the card: the per-step replay of 3500 poses in float32
     on graphs against golden/manhattan3500_seed0_f32.txt (the JAX
     package's float32 replay): the first step whose path differs and the
     first whose chi2 differs by more than relative 1e-4, recorded, not
     held to;
 15. the large-N replay (aprilsam_tpu_torch/large_inc.py, the counterpart
     of bench_large_inc.py) with its graphs captured in-run (no
     precompile) across its capacity growths: float64 at the size and
     config of golden/manhattan20000_large.txt, at policy_lag=0 every ring
     entry within relative 1e-6 and the counters, growths, capacities and
     epochs by backend equal to the JAX package's, and at the script's lag
     (each superstep dispatch waited for) the final chi2 within 0.05; then
     the script's defaults (float32, 20 000 poses, start capacity 4096 ->
     32768) with every checkpoint finite and the final chi2 within
     the bench's GATE_TOL["large"] of the float64 lagged one (relative;
     aprilsam_tpu_torch/bench.py); each replay's growths (step,
     capacities, host ms, memory reserved before and after), graphs
     captured and capture seconds per generation, epochs by backend (the
     step of each that was not a panel epoch) and K1's launches by shape
     (paths large-n-f64 and large-n-f32);
 16. scaling, on a one-rank NCCL group, after collecting the earlier
     phases' objects: the scaling bench (aprilsam_tpu_torch/scaling.py,
     the counterpart of bench_scaling.py) at its defaults (20 000 poses,
     64 blocks, closure 0.04, two Gauss-Newton iterations), float64 and
     float32, each final chi2 held to the JAX package's CPU figure
     (SCALING_CHI2); the stage profile (schur_stages.py, the counterpart
     of profile_r5_schur_stages.py) at its defaults (100 000 poses, 64
     blocks, SCALING.md's graph), float32 and float64: ms per iteration,
     device time by stage, idle share, peak memory, bound share and the
     projection, the states finite and the float64 chi2 held to the
     host BatchSolver's (SCHUR_TOL["chi2_rel_vs_batch"]), both dtypes'
     chi2 and the float64 sampled states to the JAX package's solve
     (golden/schur100k_jax.npz, multicard.JAX_TOL); and the
     communication model (scaling_model.py) at 100 000 poses on the host,
     its six rows;
 17. multicard, on every card of the machine, one NCCL rank per card in
     one spawned world (aprilsam_tpu_torch/multicard.py; mesh sizes 1, 2
     and, with four cards, 4, each the sub-group of the first ranks):
     the dry run at each size above 1 held to the JAX package's
     multi-device golden (golden/multicard_jax.npz: each separator mode
     within twice JAX's own float32 error, the dp dx norm within relative
     1e-3); schur_solve on phase 12's and phase 16's 100 000-pose graphs
     in 64 blocks, float64 and float32, both separator modes, at every
     size against one rank (float64 norm-wise 1e-8 and chi2 1e-9; float32
     5e-2 and 1e-2), in float64 against the host BatchSolver (chi2
     1e-5) and against the JAX package's solve (golden/schur100k_jax.npz,
     multicard.JAX_TOL), with ms per iteration, E(k) and each rank's peak
     memory; the
     scaling bench at its defaults in float64 and float32, chi2 at every
     size within SCALING_TOL of the golden; the stage profile at every
     size with every rank profiled, the waiting in the collectives, the
     measured E(k) beside the projection, and the collectives each rank
     issued against scaling_model's; every rank's states bit-identical;
     then examples/distributed_solve.py in float64 under torchrun on
     every card, its final chi2 within relative 1e-9 of the same example
     on one rank.  On a machine with one card it prints that it needs two
     and runs nothing;
 18. row-capacity growth on graphs (aprilsam_tpu_torch/replay_checks.py):
     row_growth_world (40 poses, 80 closures) solved at 20 poses, then
     updated pose by pose at row_block_capacity=8 (8 -> 12 -> 18), per
     step and in supersteps of 4, the graphs prepared again after each
     growth; each held to the JAX package's golden
     (golden/rowgrowth40_jax.txt: row capacity and path per step, chi2
     within relative 1e-6), one cache generation per growth, one graph
     replay per dispatch but for the captures of the growing step, and K1
     launched once per sweep;
 19. the mixed-factor replay (BASELINE.json config 3) on graphs after
     precompile: manhattan_world(3500, seed=0, geopin_every=25), its 140
     xytpos priors added as they arrive, per step at the default
     SolverConfig, held to golden/manhattan3500_seed0_geopin25.txt as
     phase 5 is (chi2 per step, paths, census, K1 once per full-path
     dispatch, one graph replay per dispatch, with the largest frontal
     bucket precompiled at every panel count: the priors reach it at 4 and
     8 active panels, which default_signatures leaves to the run);
     poses/s;
 20. the benchmark (aprilsam_tpu_torch/bench.py) as a user runs it, one
     process per cell with one timed run and its traced run: the per-step,
     S = 96 and large-N cells, and on a machine with four cards the 4-card
     cell; each exits 0 with its gate passed (the per-step census, the
     goldens' chi2), and K1's launches of each timed run join the kernels
     line (paths bench-<cell>);
 21. one JSON line listing every ported kernel, with K1's launches on each
     path and by shape, and their launch-weighted kernel and library
     times, and K2's launches on the main path by shape with their
     launch-weighted kernel and cuSOLVER (plain) device times: the split of
     the QR's time by bucket; the card's line; and the result line
     {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from statistics import median
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "aprilsam_tpu_torch", "golden",
                      "manhattan3500_seed0.txt")
SUPER_GOLDEN = os.path.join(REPO, "aprilsam_tpu_torch", "golden",
                            "manhattan3500_seed0_super96.txt")
PANEL_GOLDEN = os.path.join(REPO, "aprilsam_tpu_torch", "golden",
                            "manhattan3500_seed0_super96_panel.txt")
BUNDLED_GOLDEN = os.path.join(REPO, "aprilsam_tpu_torch", "golden",
                              "manhattan3500_seed0_bundled8.txt")
F32_GOLDEN = os.path.join(REPO, "aprilsam_tpu_torch", "golden",
                          "manhattan3500_seed0_f32.txt")
LARGE_GOLDEN = os.path.join(REPO, "aprilsam_tpu_torch", "golden",
                            "manhattan20000_large.txt")
# phase 13: graphs against eager on AOT_POSES poses, the profiler over
# steps AOT_WINDOW of the per-step and bundled replays
AOT_POSES = 3500
AOT_WINDOW = (1000, 1100)
CHI2_BAND = 0.05   # the JAX package's own band for lagged superstep runs
# A device epoch against the host epoch on manhattan_world(3500) from its
# initial states (chi2 ~1e5): the three factorizations agree to float64
# rounding amplified by the system's conditioning, measured on the CPU at
# 4.6e-9 relative in chi2, 1.9e-8 in R, 2.9e-8 in y and 1.3e-7 in the
# states (the panel epoch; the dense one is closer)
EPOCH_TOL = {"chi2_rel": 1e-7, "R_blocks": 1e-6, "y": 1e-6, "state": 1e-6}
# phase 5 saves the solver after this many steps; phase 11 resumes there
CHECKPOINT_AT = 1750
# phase 12: manhattan_world(100000, seed=0, closure_prob=0.02) at the
# generator's defaults (block=10, up to two closures per pose: ns 1667,
# nsl 96 in 64 blocks; SCALING.md's tools use block=25 and one closure per
# pose, phase 16's graph) in 64 keyframe blocks, two Gauss-Newton
# iterations.
# The separator modes solve the same system: held to each other to the JAX
# package's figures, float64 1e-8 (assert_allclose(rtol=1e-8, atol=1e-8),
# tests/test_pchol.py:77, at 400 poses) and float32 5e-2 (its dry run, at
# 2048 poses), each read in the infinity norm, |a - b| / (1 + |b|).  Entry
# by entry, two roundings drift apart as the graph and its coordinates
# grow: here, 1e-8 to 2e-8 in float64 and 0.08 in float32, in xy, while
# the norm-wise difference is near 1e-11 in float64 (PERF.md section 6).
# The decomposition matches the monolithic host batch solve in float64
# (tests/test_distributed.py's 1e-5).  Angles are compared mod 2pi.
# Each solve's chi2 (both dtypes) and float64 states of every 100th pose
# are also held to the JAX package's solve of the same graph on the CPU
# (golden/schur100k_jax.npz; multicard.JAX_TOL, where the bounds' reasons
# are).
SCHUR_POSES, SCHUR_BLOCKS, SCHUR_GN = 100000, 64, 2
SCHUR_GRAPH = dict(n_poses=SCHUR_POSES, seed=0, closure_prob=0.02)
SCHUR_TOL = {"float64_modes": 1e-8, "float32_modes": 5e-2,
             "chi2_rel_vs_batch": 1e-5, "xy_vs_batch": 1e-5}

# phase 16: the final chi2 of the scaling bench at bench_scaling.py's
# defaults (manhattan_world(20000, seed=0, closure_prob=0.04, block=25,
# max_closures_per_pose=1) in 64 blocks, two Gauss-Newton iterations, one
# rank) from the JAX package's schur_solve on the CPU, printed by
#   JAX_PLATFORMS=cpu python -c '
#   import jax, numpy as np; jax.config.update("jax_enable_x64", True)
#   from aprilsam_tpu.datasets import manhattan_world
#   from aprilsam_tpu.parallel.dist import make_mesh
#   from aprilsam_tpu.parallel.schur import partition_graph, schur_solve
#   g = manhattan_world(20000, seed=0, closure_prob=0.04, block=25,
#                       max_closures_per_pose=1)
#   p, s0 = partition_graph(g, 64), g.state.copy()
#   for d in (np.float64, np.float32):
#       g.state[:g.nnodes] = schur_solve(make_mesh(1), g, p, gn_iters=2,
#                                        dtype=d)
#       print(d.__name__, repr(g.chi2())); g.state[:] = s0'
# (the float32 figure rounded to 0.01).  The card's cuSOLVER rounds
# otherwise than the CPU's LAPACK, so float64 is held to 1e-7 relative; the
# float32 solve's eq_jitter (1e-5) leaves chi2 7.9x above float64's after
# two iterations in both packages, and the port's CPU float32 lands 0.56 %
# from the JAX figure: held within 5 %.
SCALING_CHI2 = {"float64": 92747.40863341012, "float32": 736753.71}
SCALING_TOL = {"float64": 1e-7, "float32": 5e-2}
# phase 16's stage profile: schur_stages.py's defaults, its chi2 held to
# the JAX package's solve as phase 12's are
STAGES_POSES, STAGES_BLOCKS, STAGES_GN = 100000, 64, 2
STAGES_GRAPH = dict(n_poses=STAGES_POSES, seed=0, closure_prob=0.02,
                    block=25, max_closures_per_pose=1)
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# (B, N, dtype) of T [B, N, N]: the first slice's shapes, then the B the
# main path launches at N = 3 * panel_nodes = 384 (float64)
SHAPES = [(B, N, dtype) for B, N in ((32, 384), (8, 96), (1, 48))
          for dtype in (torch.float64, torch.float32)]
SHAPES += [(B, 384, torch.float64) for B in (1, 2, 4, 8, 16)]
# the large-N replay's sweeps (panel_nodes=256: N = 768), both dtypes
SHAPES += [(B, 768, dtype) for B in (16, 128)
           for dtype in (torch.float64, torch.float32)]

# K2: (M, live nodes, xyt factors, position factors, K) per shape: the
# per-step buckets at the mean live front of an M3500 per-step pass (2, 45,
# 126, 303 nodes; 1-4 factors), the largest at M = 256 and at M = 1024,
# then the streaming cell's superstep signatures (S = 64: K = 128, a few
# hundred live rows) and S = 96's (K = 192)
FRONTAL_SHAPES = [(16, 2, 1, 0, 16), (64, 45, 2, 0, 16),
                  (256, 126, 3, 0, 16), (256, 247, 4, 0, 16),
                  (1024, 303, 4, 0, 16), (1024, 350, 4, 0, 16),
                  (256, 200, 64, 4, 128), (384, 300, 100, 8, 128),
                  (1024, 700, 128, 8, 128), (384, 300, 150, 4, 192)]


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


def device_us(fn, iters: int = 20) -> dict:
    """Mean device time in microseconds of each CUDA kernel that fn
    launches, by the kernel's name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = e.cuda_time_total
        if total:
            name = re.sub(r"\(.*", "", e.key.replace(
                "(anonymous namespace)::", "")).replace("void ", "")
            out[name] = total / iters
    return out


def ptxas_figures(log: str) -> list:
    """Registers, static shared memory and spill bytes of each kernel in
    nvcc's -Xptxas -v output."""
    rows, name, spills = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # _ZN..strip_kernelIdLi48ELb0E..: strip_kernel<double, 48, false>
            name, spills = m.group(1), None
            k = re.search(r"([a-z_]+_kernel)I([df])E?(?:Li(\d+)ELb([01]))?",
                          name)
            if k:
                args = ["double" if k.group(2) == "d" else "float"]
                if k.group(3):
                    args += [k.group(3), ("false", "true")[int(k.group(4))]]
                name = f"{k.group(1)}<{', '.join(args)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = [int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append({"kernel": name, "registers": int(m.group(1)),
                         "static_smem": int(smem.group(1)) if smem else 0,
                         "spill_stores_loads": spills})
            name = None
    return rows


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


def measure_tri_inv(K, peaks, B: int, N: int, dtype) -> dict:
    """K1 at one shape: checked against its plain version, then timed
    beside the plain version, the library call and the bound."""
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
           "kernel_over_library": kernel_ms / library_ms,
           "bound_us": bound_ms * 1e3, "bound_by": bound_by,
           "bound_share": bound_ms / kernel_ms,
           "kernel_device_us": device_us(lambda: K.tri_inv(T)),
           "library_device_us": device_us(lambda: torch.linalg.solve_triangular(
               T, eye.expand(T.shape), upper=True))}
    print(json.dumps(row), flush=True)
    return row


def check_tri_inv(K, peaks) -> dict:
    """Phase 3.  Returns the measurements keyed (B, N, dtype name), as
    K.launches_by_shape keys them."""
    rows = {}
    for B, N, dtype in SHAPES:
        row = measure_tri_inv(K, peaks, B, N, dtype)
        rows[(B, N, row["dtype"])] = row
    return rows


def frontal_bound_ms(m: int, p: int, n: int, dtype, peaks) -> tuple:
    """Least time for the live frontal update of m slots under p live rows
    (the kernel's useful work): reflector k updates the 3m - k - 1 later
    columns and the right-hand side, a dot product and an update of p + 1
    entries each, 4 (p + 1) flops, against the live triangle of R read and
    written once and A's live rows read once."""
    nl = 3 * m
    elt = torch.finfo(dtype).bits // 8
    flops = 4 * (p + 1) * nl * (nl + 1) // 2
    nbytes = (nl * (nl + 1) + p * (nl + 1)) * elt
    t_ops = flops / peaks["float64"] * 1e3
    t_bytes = nbytes / peaks["bytes_per_s"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms per call of fn: `reps` calls captured in one CUDA graph,
    replayed twice between CUDA events, best of three."""
    from aprilsam_tpu_torch.kernels import frontal_qr as K2
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        K2.capture_record = {}
        try:
            with torch.cuda.graph(g, stream=s):
                for _ in range(reps):
                    fn()
        finally:
            K2.capture_record = None
    torch.cuda.synchronize()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / (2 * reps))
    return best


def measure_frontal_qr(K2, peaks, shape: tuple, dtype) -> dict:
    """K2 at one shape: checked against its plain version, then its device
    time beside the plain version's (the cuSOLVER QR the main path ran
    before) and the bound."""
    M, nodes, nx, npos, Kf = shape
    R, y, A, rhs, ctl = K2.example(M, nodes, nx, npos, Kf, seed=M + nodes,
                                   dtype=dtype, device="cuda")
    ref_R, ref_y = K2.frontal_qr_plain(R, y, A, rhs)
    got_R, got_y = K2.frontal_qr(R.clone(), y.clone(), A, rhs, ctl)
    torch.cuda.synchronize()
    rel_err = max(((got_R - ref_R).abs().max() / ref_R.abs().max()).item(),
                  ((got_y - ref_y).abs().max() / ref_y.abs().max()).item())
    if not (torch.isfinite(got_R).all() and rel_err <= TOL[dtype]):
        raise AssertionError(f"frontal_qr {shape} {dtype}: max relative "
                             f"error {rel_err} > {TOL[dtype]}")
    # in place: each timed call updates the last one's triangle by the same
    # rows, the same work
    Rk, yk = got_R, got_y
    kernel_ms = graph_ms(lambda: K2.frontal_qr(Rk, yk, A, rhs, ctl))
    plain = lambda: K2.frontal_qr_plain(R, y, A, rhs)
    plain_dev = device_us(plain, iters=5)
    bound_ms, bound_by = frontal_bound_ms(nodes, 3 * (nx + npos), 3 * M,
                                          dtype, peaks)
    row = {"kernel": "frontal_qr", "shape": [3 * M, 6 * Kf],
           "live": {"nodes": nodes, "xyt": nx, "pos": npos},
           "dtype": str(dtype).replace("torch.", ""), "max_rel_err": rel_err,
           "tol_rel": TOL[dtype], "kernel_ms": kernel_ms,
           "plain_ms": cuda_ms(plain, iters=5, warmup=1),
           "plain_device_ms": sum(plain_dev.values()) / 1e3,
           "bound_us": bound_ms * 1e3, "bound_by": bound_by,
           "bound_share": bound_ms / kernel_ms,
           "plain_device_us": plain_dev}
    row["plain_over_kernel"] = row["plain_device_ms"] / kernel_ms
    print(json.dumps(row), flush=True)
    return row


def check_frontal_qr(K2, peaks) -> dict:
    """Phase 3b.  Returns the float64 rows keyed (3M, p, dtype name), as
    K2.launches_by_shape keys them (the first shape of each key)."""
    rows = {}
    for dtype in (torch.float64, torch.float32):
        for shape in FRONTAL_SHAPES:
            row = measure_frontal_qr(K2, peaks, shape, dtype)
            rows.setdefault((*row["shape"], row["dtype"]), row)
    return rows


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


def read_golden(path: str = GOLDEN):
    from aprilsam_tpu_torch.bench import read_golden as read

    return read(path)


def check_replay(K, name: str, card: str, rep, res, secs: float,
                 first: int, extra: dict) -> dict:
    """Hold steps first.. of a per-step replay of the golden's graph to the
    golden (the bench's gate, aprilsam_tpu_torch/bench.py:hold_per_step):
    chi2 per step from the metric ring, the path per step, the census; and
    tri_inv launched once per full-path dispatch.  Returns the launches by
    (B, N, dtype name)."""
    from aprilsam_tpu_torch.bench import hold_per_step
    from aprilsam_tpu_torch.kernels import frontal_qr as K2

    gold_paths, gold_chi2 = read_golden()
    n = len(gold_paths)
    launches = K.launches
    by_shape = dict(K.launches_by_shape)
    hist = rep.solver.chi2_history()
    if len(res) != n - first or hist.shape != (n,):
        raise AssertionError(f"{name}: {len(res)} steps, {hist.shape} chi2 "
                             f"entries; golden has {n}")
    held = hold_per_step(hist[first:], [r.path for r in res],
                         gold_chi2[first:], gold_paths[first:])
    bad = held.pop("bad")
    full_dispatches = rep.solver.counters["full"]
    frontal = dict(K2.launches_by_shape)
    frontal_dispatches = rep.solver.counters["fast"] + full_dispatches
    steps = n - first
    summary = {
        "phase": name, "graph": f"manhattan_world({n}, seed=0)",
        "dtype": "float64", "card": card, "steps": f"{first}..{n - 1}",
        "seconds": secs, "poses_per_s": steps / secs,
        "mean_step_ms": secs * 1e3 / steps, **extra, **held,
        "full_dispatches": full_dispatches, "tri_inv_launches": launches,
        "tri_inv_launches_by_shape": [
            {"shape": [B, N, N], "dtype": dt, "launches": c}
            for (B, N, dt), c in sorted(by_shape.items())],
        "frontal_dispatches": frontal_dispatches,
        "frontal_qr_launches": K2.launches,
        "frontal_live_columns": rep.solver.counters["frontal_live_columns"],
        "frontal_qr_launches_by_shape": [
            {"shape": [n3, p], "dtype": dt, "launches": c}
            for (n3, p, dt), c in sorted(frontal.items())],
    }
    print(json.dumps(summary), flush=True)
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad))
    if K2.launches != frontal_dispatches or \
            sum(frontal.values()) != K2.launches:
        raise AssertionError(
            f"{name}: frontal_qr launched {K2.launches} times ({frontal}) "
            f"for {frontal_dispatches} frontal dispatches")
    if launches != full_dispatches or launches < held["census"]["full"] \
            or launches == 0:
        raise AssertionError(
            f"{name}: tri_inv launched {launches} times for "
            f"{full_dispatches} full-path dispatches")
    if sum(by_shape.values()) != launches:
        raise AssertionError(f"{name}: tri_inv launches by shape {by_shape} "
                             f"do not sum to {launches}")
    return by_shape


def prepare_graphs(solver, nnodes: int = 3500) -> dict:
    """Capture the solver's graphs for an nnodes-pose replay
    (aprilsam_tpu_torch/bench.py:prepare: precompile, and the ladder of
    its batch epoch's expansion (host epochs) or dense epoch (device
    backends)); then zero its dispatch counts.  First frees the solvers
    and graphs of earlier replays (the phases' wrappers make reference
    cycles), so that every timed replay starts from the same process
    state.  Returns the counts and seconds."""
    from aprilsam_tpu_torch.bench import prepare

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out = prepare(solver, nnodes)
    g = solver.graphs
    g.calls.clear()
    g.replayed.clear()
    return out


def graph_use(solver, name: str, prepared: dict) -> dict:
    """The replay's dispatches and graph replays by kind since
    prepare_graphs; raises unless every dispatch replayed a graph."""
    g = solver.graphs
    use = {"precompile": prepared, "dispatches": dict(g.calls),
           "replays": dict(g.replayed), "graphs_after": len(g.graphs)}
    if not g.enabled or not g.calls or g.calls != g.replayed:
        raise AssertionError(f"{name}: dispatches {dict(g.calls)} are not "
                             f"all graph replays {dict(g.replayed)}")
    return use


def run_main_path(K, card: str, ckpt_path: str) -> tuple:
    """Phase 5.  Saves the solver to ckpt_path after CHECKPOINT_AT steps
    and goes on.  Returns the tri_inv launches by (B, N, dtype name) and
    what phase 11 resumes from."""
    from aprilsam_tpu_torch.checkpoint import save_solver
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.kernels import frontal_qr as K2
    from aprilsam_tpu_torch.replay import Replay
    from aprilsam_tpu_torch.solver import SolverConfig

    n = len(read_golden()[0])
    loaded = manhattan_world(n, seed=0)
    rep = Replay(loaded, SolverConfig(wallclock_gate=False), device="cuda")
    if rep.solver.ds.state.dtype != torch.float64:
        raise AssertionError("the main path runs in float64")
    prepared = prepare_graphs(rep.solver, n)
    K.reset_launches()
    K2.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = []
    for k in range(n):
        res.append(rep.step())
        if k + 1 == CHECKPOINT_AT:
            t = time.perf_counter()
            save_solver(rep.solver, ckpt_path)
            ckpt = {"graph": copy.deepcopy(rep.graph),
                    "event_idx": rep.event_idx,
                    "save_ms": (time.perf_counter() - t) * 1e3}
    rep.finish()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0 - ckpt["save_ms"] / 1e3
    return check_replay(K, "replay", card, rep, res, secs, 0, {
        "checkpoint_save_ms": ckpt["save_ms"],
        "graphs": graph_use(rep.solver, "replay", prepared)}), ckpt


def run_checkpoint_resume(K, card: str, ckpt_path: str, ckpt: dict) -> dict:
    """Phase 11: a fresh solver loaded on the card from phase 5's
    checkpoint replays the second half of the golden's steps, held to the
    golden as phase 5 is.  Returns the tri_inv launches by shape."""
    from aprilsam_tpu_torch.checkpoint import load_solver
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.kernels import frontal_qr as K2
    from aprilsam_tpu_torch.replay import Replay
    from aprilsam_tpu_torch.solver import SolverConfig

    n = len(read_golden()[0])
    rep = Replay(manhattan_world(n, seed=0), SolverConfig(
        wallclock_gate=False), device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep.solver = load_solver(ckpt_path, device="cuda")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t) * 1e3
    rep.graph, rep.event_idx = ckpt["graph"], ckpt["event_idx"]
    prepared = prepare_graphs(rep.solver, n)
    K.reset_launches()
    K2.reset_launches()
    t0 = time.perf_counter()
    res = [rep.step() for _ in range(n - ckpt["event_idx"])]
    rep.finish()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rep.solver.python_planner or getattr(rep.solver.sym, "pad_idx",
                                            None) is None:
        raise AssertionError("the resumed replay did not plan natively")
    return check_replay(K, "checkpoint-resume", card, rep, res, secs,
                        ckpt["event_idx"], {
                            "file_bytes": os.path.getsize(ckpt_path),
                            "save_ms": ckpt["save_ms"], "load_ms": load_ms,
                            "graphs": graph_use(rep.solver,
                                                "checkpoint-resume",
                                                prepared)})


def run_distributed(card: str) -> None:
    """Phase 12, on a one-rank NCCL group: the multi-rank dry run, then the
    keyframe-block Schur solve of manhattan_world(100000, seed=0,
    closure_prob=0.02) in float64 with both separator modes, held to each
    other and to the host BatchSolver, and in float32 with both modes, held
    to each other; each held to the JAX package's solve (chi2, and the
    float64 states of every 100th pose)."""
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.geometry import np_mod2pi
    from aprilsam_tpu_torch.multicard import (SAMPLE_EVERY, hold_to_jax,
                                              jax_entry, read_schur_golden)
    from aprilsam_tpu_torch.parallel import one_rank_group
    from aprilsam_tpu_torch.parallel.dryrun import dryrun_multichip
    from aprilsam_tpu_torch.parallel.schur import partition_graph, schur_solve
    from aprilsam_tpu_torch.solver import BatchSolver, SolverConfig

    with one_rank_group("cuda") as mesh:
        t = time.perf_counter()
        dry = dryrun_multichip(mesh)
        print(json.dumps({"phase": "dryrun_multichip", "card": card,
                          "backend": torch.distributed.get_backend(), **dry,
                          "seconds": time.perf_counter() - t}), flush=True)

        t = time.perf_counter()
        g = manhattan_world(**SCHUR_GRAPH)
        gen_s = time.perf_counter() - t
        entry = jax_entry(read_schur_golden(), SCHUR_GRAPH, SCHUR_BLOCKS,
                          SCHUR_GN)
        t = time.perf_counter()
        part = partition_graph(g, SCHUR_BLOCKS)
        part_s = time.perf_counter() - t
        runs = {}
        for dtype in (np.float64, np.float32):
            for mode, sep_dist in (("replicated", False),
                                   ("distributed", True)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                st = schur_solve(mesh, g, part, gn_iters=SCHUR_GN,
                                 dtype=dtype, sep_dist=sep_dist)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                runs[np.dtype(dtype).name, mode] = (
                    st, secs * 1e3 / SCHUR_GN,
                    torch.cuda.max_memory_allocated())

        cfg = SolverConfig(node_capacity=1 << 17, factor_capacity=1 << 17,
                           gn_iters=SCHUR_GN)
        mono = BatchSolver(cfg, device="cuda")
        t = time.perf_counter()
        mono.solve(g)
        torch.cuda.synchronize()
        mono_s = time.perf_counter() - t
        st_mono = mono.ds.state[:g.nnodes].cpu().numpy()
        chi2_mono = mono.chi2()

        def chi2_of(states):
            h = copy.deepcopy(g)
            h.state[:g.nnodes] = states
            return h.chi2()

        def diff(a, b):
            """The largest difference of two state tables in xy and in
            theta (mod 2pi: an angle near +-pi lands on either side); the
            largest relative to 1 + |b| entry by entry (numpy's
            assert_allclose(rtol=t, atol=t) in the form of one number), and
            in the infinity norm, |a - b| / (1 + |b|)."""
            d = np.abs(a - b)
            d[:, 2] = np.abs(np_mod2pi(a[:, 2] - b[:, 2]))
            return {"xy": float(np.max(d[:, :2])),
                    "theta": float(np.max(d[:, 2])),
                    "allclose": float(np.max(d / (1.0 + np.abs(b)))),
                    "norm": float(np.max(d) / (1.0 + np.max(np.abs(b))))}

        st = {k: v[0] for k, v in runs.items()}
        vs_jax, jax_bad = {}, []
        for (d, m), states in st.items():
            vs_jax[f"{d}-{m}"], fails = hold_to_jax(
                entry, d, chi2_of(states), states[::SAMPLE_EVERY])
            jax_bad += [f"{d}-{m}: {f}" for f in fails]
        rep64 = st["float64", "replicated"]
        chi2_dd = chi2_of(rep64)
        modes64 = diff(st["float64", "distributed"], rep64)
        modes32 = diff(st["float32", "distributed"],
                       st["float32", "replicated"])
        err = {
            "float64_modes": modes64["norm"],
            "float32_modes": modes32["norm"],
            "chi2_rel_vs_batch": abs(chi2_dd - chi2_mono) / chi2_mono,
            "xy_vs_batch": float(np.max(np.abs(rep64[:, :2]
                                               - st_mono[:, :2])))}
        print(json.dumps({
            "phase": "schur", "card": card,
            "graph": f"manhattan_world({SCHUR_POSES}, seed=0, "
                     "closure_prob=0.02)",
            "blocks": SCHUR_BLOCKS, "gn_iters": SCHUR_GN,
            "ns": part.ns, "ni_max": part.ni_max, "nsl": part.nsl,
            "generate_s": gen_s, "partition_s": part_s,
            "ms_per_gn_iter": {f"{d}-{m}": v[1] for (d, m), v in runs.items()},
            "max_memory_allocated": {f"{d}-{m}": v[2]
                                     for (d, m), v in runs.items()},
            "kept_Ls_bytes_float64": SCHUR_BLOCKS * (3 * part.ni_max) ** 2 * 8,
            "host_batch_s": mono_s, "chi2_initial": g.chi2(),
            "chi2": {f"{d}-{m}": chi2_of(s) for (d, m), s in st.items()},
            "chi2_batch": chi2_mono, "errors": err,
            "xy_theta_modes": {"float64": modes64, "float32": modes32},
            "xy_theta_float32_vs_float64": diff(st["float32", "replicated"],
                                                rep64),
            "tol": SCHUR_TOL, "vs_jax": vs_jax}), flush=True)
        bad = [k for k, v in err.items() if not v <= SCHUR_TOL[k]]
        if bad or jax_bad or not all(np.all(np.isfinite(v[0]))
                                     for v in runs.values()):
            raise AssertionError(f"schur_solve at {SCHUR_POSES} poses: "
                                 f"{err} against {SCHUR_TOL}; {jax_bad}")



def read_super_golden(path: str = SUPER_GOLDEN):
    from aprilsam_tpu_torch.bench import read_super_golden as read

    return read(path)


def golden_config(entry: dict):
    from aprilsam_tpu_torch.solver import SolverConfig

    kw = dict(entry["config"])
    if "superstep_buckets" in kw:
        kw["superstep_buckets"] = tuple(kw["superstep_buckets"])
    return SolverConfig(**kw)


# the solver method of one dispatch, by mode, and whether it has work;
# "epochs" are the batch epochs (DispatchTimer only)
DISPATCH = {"superstep": ("_dispatch_superstep", lambda s: s._sbuf),
            "bundles": ("_dispatch_queue", lambda s: s._queue),
            "per-step": ("_dispatch_one", lambda s: True),
            "epochs": ("_run_batch", lambda s: True)}


class SyncCounter:
    """Records every synchronizing CUDA call (torch.cuda.set_sync_debug_mode
    "warn") made inside the solver's dispatches of `mode` (DISPATCH:
    superstep, bundle or per-step dispatches), by call site; batch epochs
    (a union-overflow fallback, or one the policy fires) and the policy's
    reads of the stats are not counted."""

    def __init__(self, solver, mode: str = "superstep"):
        self.dispatches = 0
        self.sites = Counter()
        name, busy = DISPATCH[mode]
        dispatch, batch = getattr(solver, name), solver._run_batch

        def counted_dispatch(*args):
            if not busy(solver):
                return dispatch(*args)
            self.dispatches += 1
            mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = dispatch(*args)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            for w in caught:
                if "synchroniz" in str(w.message):
                    site = os.path.relpath(w.filename, REPO)
                    self.sites[f"{site}:{w.lineno}"] += 1
            return out

        def uncounted_batch(*args, **kw):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return batch(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        setattr(solver, name, counted_dispatch)
        solver._run_batch = uncounted_batch
        self.restore = lambda: (setattr(solver, name, dispatch),
                                setattr(solver, "_run_batch", batch))

    def summary(self) -> dict:
        total = sum(self.sites.values())
        return {"dispatches": self.dispatches, "syncs": total,
                "syncs_per_dispatch": total / max(self.dispatches, 1),
                "sites": dict(self.sites)}


class DispatchTimer:
    """Host seconds spent inside the solver's dispatches of `mode`
    (DISPATCH), and their count."""

    def __init__(self, solver, mode: str):
        name, busy = DISPATCH[mode]
        inner = getattr(solver, name)
        self.seconds, self.count = 0.0, 0

        def timed(*args, **kw):
            if not busy(solver):
                return inner(*args, **kw)
            t = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t
                self.count += 1
        setattr(solver, name, timed)


def device_window(fn) -> dict:
    """fn() under torch.profiler: its wall seconds (ending in a
    synchronize), the device-side time summed over the device records
    (kernels, copies, sets; one stream), the idle share, and the device
    events."""
    from torch.profiler import ProfilerActivity, profile

    from aprilsam_tpu_torch.utils.trace import device_rows

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev = device_rows(prof)
    busy_us = sum(us for _n, us, _c in dev)
    return {"wall_s": wall, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_events": sum(c for _n, _us, c in dev)}


def aot_replay(K, cfg, deferred: bool, mode: str, graphs: bool) -> dict:
    """Phase 13, one timed replay of AOT_POSES poses, on graphs (after
    prepare_graphs) or eager: poses/s, host ms per dispatch and per batch
    epoch (a lazy epoch's enqueue; at policy_lag=0 up to the read of its
    chi2), K1's launches by shape, the chi2 ring."""
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.replay import Replay

    # the previous replay's solver and graphs (its timers make a cycle;
    # prepare_graphs frees them too, for the replays on graphs)
    gc.collect()
    torch.cuda.empty_cache()
    rep = Replay(manhattan_world(AOT_POSES, seed=0), cfg, deferred=deferred,
                 device="cuda")
    rep.solver.graphs.enabled = graphs
    prep = prepare_graphs(rep.solver, AOT_POSES) if graphs else None
    timer = DispatchTimer(rep.solver, mode)
    epochs = DispatchTimer(rep.solver, "epochs")
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rep.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    s = rep.solver
    out = {"graphs": graphs, "seconds": secs,
           "poses_per_s": AOT_POSES / secs, "dispatches": timer.count,
           "host_ms_per_dispatch": timer.seconds * 1e3 / max(timer.count, 1),
           "epochs": epochs.count,
           "host_ms_per_epoch": epochs.seconds * 1e3 / max(epochs.count, 1),
           "tri_inv_launches": K.launches,
           "by_shape": dict(K.launches_by_shape),
           "census": {p: sum(r.path == p for r in res)
                      for p in ("fast", "full", "batch", "super")},
           "counters": dict(s.counters), "ring": s.chi2_history(),
           "final_chi2": s.chi2()}
    if graphs:
        out["graph_use"] = graph_use(s, f"aot-{mode}", prep)
    return out


def aot_window(cfg, deferred: bool, mode: str, graphs: bool) -> dict:
    """Phase 13: the replay again up to the end of AOT_WINDOW (the whole
    replay for supersteps) with the profiler and the sync counter on over
    the window: device busy ms, idle share, device events per dispatch,
    synchronizing calls per dispatch."""
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.replay import Replay

    # the previous replay's solver and graphs (its timers make a cycle;
    # prepare_graphs frees them too, for the replays on graphs)
    gc.collect()
    torch.cuda.empty_cache()
    rep = Replay(manhattan_world(AOT_POSES, seed=0), cfg, deferred=deferred,
                 device="cuda")
    rep.solver.graphs.enabled = graphs
    if graphs:
        prepare_graphs(rep.solver, AOT_POSES)
    lo, hi = (0, AOT_POSES) if mode == "superstep" else AOT_WINDOW
    for _ in range(lo):
        rep.step()
    timer = DispatchTimer(rep.solver, mode)
    syncs = SyncCounter(rep.solver, mode)

    def window():
        for _ in range(hi - lo):
            rep.step()
        if hi == AOT_POSES:
            rep.finish()
    win = device_window(window)
    syncs.restore()
    win.update(steps=[lo, hi], dispatches=timer.count,
               device_events_per_dispatch=win["device_events"]
               / max(timer.count, 1),
               sync_debug=syncs.summary())
    return win


# phase 13's replays: config name -> (deferred, dispatch mode, timed
# replays of each kind); the short superstep replays run eager and on
# graphs in turn (eager, graphs, graphs, eager, eager, graphs), so that a
# drift of the host's speed within the call falls on both alike
AOT_MODES = {"per-step": (False, "per-step", 1),
             "superstep96": (True, "superstep", 3),
             "panel-ring": (True, "superstep", 3),
             "panel-bench": (True, "superstep", 3),
             "bundled8": (True, "bundles", 1)}


def run_aot(K, card: str) -> None:
    """Phase 13: precompile at 3500 poses, then graphs against eager."""
    from aprilsam_tpu_torch.solver import IncrementalSolver, SolverConfig
    from aprilsam_tpu_torch.solver.batch import precompile_device_batch
    from aprilsam_tpu_torch.solver.host_batch import precompile_expand
    from aprilsam_tpu_torch.solver.panel_epoch import precompile_panel_epoch

    head, _ring, _ = read_super_golden()
    bhead, _ring, _ = read_super_golden(BUNDLED_GOLDEN)
    phead, _ring, _ = read_super_golden(PANEL_GOLDEN)
    configs = {"per-step": SolverConfig(wallclock_gate=False),
               "superstep96": golden_config(head["bench"]),
               "windowed": golden_config(head["windowed"]),
               "bundled8": golden_config(bhead["bundled"]),
               "panel-ring": golden_config(phead),
               "panel-bench": golden_config(phead["bench"])}

    def reserved():
        return torch.cuda.memory_stats().get("reserved_bytes.all.current", 0)

    ladders = {"dense-epoch": ("device", precompile_device_batch),
               "panel-epoch": ("panel", precompile_panel_epoch),
               "expand": ("auto", precompile_expand)}
    total = {"signatures": 0, "graphs": 0, "seconds": 0.0,
             "capture_s": 0.0}
    for name in ["per-step", "superstep96", "windowed", "bundled8",
                 *ladders]:
        gc.collect()
        torch.cuda.empty_cache()
        if name in ladders:
            backend, fn = ladders[name]
            s = IncrementalSolver(SolverConfig(wallclock_gate=False,
                                               batch_backend=backend),
                                  device="cuda")
        else:
            s = IncrementalSolver(configs[name], device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r0 = reserved()
        t = time.perf_counter()
        n = (ladders[name][1](s.ds, s.cfg, 3500, s.graphs) if name in ladders
             else s.precompile(nnodes=3500))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        caps = {" ".join(map(str, k)): c.seconds * 1e3
                for k, c in s.graphs.graphs.items()}
        line = {"phase": "precompile", "config": name, "card": card,
                "nnodes": 3500, "signatures": n,
                "graphs": len(s.graphs.graphs), "seconds": secs,
                "capture_s": sum(caps.values()) / 1e3,
                "capture_ms_by_signature": caps,
                "reserved_bytes_added": reserved() - r0,
                "peak_reserved_bytes": torch.cuda.memory_stats().get(
                    "reserved_bytes.all.peak", 0)}
        print(json.dumps(line), flush=True)
        if len(s.graphs.graphs) == 0:
            raise AssertionError(f"precompile {name}: no graph captured")
        for k in total:
            total[k] += line[k]
        del s
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "precompile", "config": "all",
                      "card": card, **total}), flush=True)

    for name, (deferred, mode, repeats) in AOT_MODES.items():
        cfg = configs[name]
        order = [False, True, True, False, False, True][:2 * repeats]
        runs = [aot_replay(K, cfg, deferred, mode, g) for g in order]
        eager = [r for r in runs if not r["graphs"]]
        graph = [r for r in runs if r["graphs"]]
        windows = {g: aot_window(cfg, deferred, mode, g)
                   for g in (False, True)}
        e0 = eager[0]
        ring_ok = all(
            r["ring"].shape == e0["ring"].shape and bool(np.all(
                np.abs(r["ring"] - e0["ring"])
                <= 1e-9 * np.abs(e0["ring"]) + 1e-12)) for r in runs)
        line = {"phase": f"graphs-vs-eager-{name}", "card": card,
                "graph": f"manhattan_world({AOT_POSES}, seed=0)",
                "config": name, "ring_equal_1e-9": ring_ok}
        for key, rs in (("eager", eager), ("graphs", graph)):
            line[key] = {k: v for k, v in rs[0].items()
                         if k not in ("ring", "by_shape", "graphs")}
            line[key]["tri_inv_launches_by_shape"] = [
                {"shape": [B, N, N], "dtype": dt, "launches": c}
                for (B, N, dt), c in sorted(rs[0]["by_shape"].items())]
            for k in ("poses_per_s", "host_ms_per_dispatch",
                      "host_ms_per_epoch"):
                line[key][k + "_runs"] = [r[k] for r in rs]
                line[key][k] = median(r[k] for r in rs)
            line[key]["window"] = windows[key == "graphs"]
        print(json.dumps(line), flush=True)
        bad = []
        if cfg.policy_lag == 0:
            # synchronous policy: the same trajectory to rounding
            if not ring_ok:
                bad.append("chi2 rings differ")
            for r in runs[1:]:
                if (r["census"], r["counters"], r["by_shape"]) != \
                        (e0["census"], e0["counters"], e0["by_shape"]):
                    bad.append(
                        f"census, counters or K1 launches by shape differ "
                        f"(graphs={r['graphs']}: {r['by_shape']}, eager "
                        f"{e0['by_shape']})")
        else:
            # lagged: the policy reads the newest stats that are ready,
            # which depends on timing (tests/test_torch_graphs_gpu.py holds
            # the two to each other with the device waited for)
            off = [r["final_chi2"] for r in runs
                   if not abs(r["final_chi2"] - e0["final_chi2"]) < CHI2_BAND]
            if off:
                bad.append(f"final chi2 {off} against "
                           f"{e0['final_chi2']!r} eager")
        if mode != "per-step":
            for g, win in windows.items():
                if win["sync_debug"]["syncs"]:
                    bad.append(f"synchronizing calls in {mode} dispatches "
                               f"(graphs={g}): {win['sync_debug']['sites']}")
        if bad:
            raise AssertionError(f"graphs vs eager, {name}: "
                                 + "; ".join(bad))


def run_float32(K, card: str) -> dict:
    """Phase 14: the per-step replay in float32 on graphs against the JAX
    package's float32 golden.  Recorded, not held to: the first step whose
    path differs and the first whose chi2 differs by more than relative
    1e-4 (absolute 1e-6 near zero).  Raises on a non-finite chi2 or where
    K1 did not launch once per full-path dispatch.  Returns K1's launches
    by shape."""
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.replay import Replay
    from aprilsam_tpu_torch.solver import SolverConfig

    gold_paths, gold = read_golden(F32_GOLDEN)
    n = len(gold_paths)
    rep = Replay(manhattan_world(n, seed=0), SolverConfig(
        wallclock_gate=False, dtype=np.float32), device="cuda")
    if rep.solver.ds.state.dtype != torch.float32:
        raise AssertionError("the float32 replay runs in float32")
    prepared = prepare_graphs(rep.solver, n)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = [rep.step() for _ in range(n)]
    rep.finish()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    hist = rep.solver.chi2_history()
    paths = [r.path for r in res]
    by_shape = dict(K.launches_by_shape)
    diff_path = [k for k in range(n) if paths[k] != gold_paths[k]]
    off = np.abs(hist - gold) > 1e-4 * np.abs(gold) + 1e-6
    diff_chi2 = np.nonzero(off)[0]
    first = int(diff_path[0]) if diff_path else n
    # relative error where the golden chi2 is above rounding level (the
    # first steps' ~1e-14 in float32)
    big = np.abs(gold) > 1e-6
    rel = np.where(big, np.abs(hist - gold) / np.where(big, np.abs(gold),
                                                       1.0), 0.0)
    c = rep.solver.counters
    print(json.dumps({
        "phase": "float32", "card": card,
        "graph": f"manhattan_world({n}, seed=0)", "dtype": "float32",
        "golden": os.path.relpath(F32_GOLDEN, REPO), "seconds": secs,
        "poses_per_s": n / secs,
        "first_path_divergence": int(diff_path[0]) if diff_path else None,
        "path_mismatches": len(diff_path),
        "first_chi2_divergence_1e-4": (int(diff_chi2[0]) if len(diff_chi2)
                                       else None),
        "chi2_mismatches_1e-4": int(len(diff_chi2)),
        "max_rel_chi2_err_before_path_divergence":
            float(np.max(rel[:first])) if first else None,
        "final_chi2": float(hist[-1]), "golden_final_chi2": float(gold[-1]),
        "census": {p: paths.count(p) for p in ("fast", "full", "batch")},
        "golden_census": {p: gold_paths.count(p)
                          for p in ("fast", "full", "batch")},
        "tri_inv_launches": K.launches,
        "tri_inv_launches_by_shape": [
            {"shape": [B, N, N], "dtype": dt, "launches": k}
            for (B, N, dt), k in sorted(by_shape.items())],
        "graphs": graph_use(rep.solver, "float32", prepared)}), flush=True)
    if not np.all(np.isfinite(hist)) or len(hist) != n:
        raise AssertionError(f"float32: {len(hist)} chi2 entries, finite "
                             f"{bool(np.all(np.isfinite(hist)))}")
    if K.launches != c["full"] or sum(by_shape.values()) != K.launches:
        raise AssertionError(f"float32: tri_inv launched {K.launches} times "
                             f"for {c['full']} full-path dispatches")
    return by_shape


def record_epochs(rep) -> list:
    """[step, nodes, backend] of every batch epoch of rep's replay that did
    not run on the panel backend, filled as the replay runs."""
    s = rep.solver
    epoch = s._epoch
    steps = []

    def recorded(g, nn, nf, log_mode):
        before = epochs_of(s.counters)
        info = epoch(g, nn, nf, log_mode)
        after = epochs_of(s.counters)
        kind = [k for k in after if after[k] != before[k]][0]
        if kind != "panel":
            steps.append([rep.event_idx - 1, nn, kind])
        return info
    s._epoch = recorded
    return steps


def run_large(K, card: str) -> dict:
    """Phase 15: the large-N replay (aprilsam_tpu_torch/large_inc.py) on
    graphs captured in-run, across its capacity growths.  Float64 at the
    golden's size and config: at policy_lag=0 every ring entry within
    relative 1e-6, the counters, growths, final capacities and epochs by
    backend equal to the golden's; the script's lag (each superstep
    dispatch waited for) within CHI2_BAND of the golden's lagged final.
    Then the script's own defaults (float32, 20 000 poses): every
    checkpoint finite, final ncap 32768, final chi2 within the bench's
    large-N bound (relative) of the golden's lagged final.  Returns K1's
    launches by shape of the float64 ring replay and of the float32 one."""
    from aprilsam_tpu_torch import large_inc
    from aprilsam_tpu_torch.bench import GATE_TOL

    head, ring, _ = read_super_golden(LARGE_GOLDEN)
    gold, lagged = head["ring"], head["lagged"]
    base = ["--poses", str(head["graph"]["nnodes"]), "--start_capacity",
            str(gold["config"]["node_capacity"]), "--panel_nodes",
            str(gold["config"]["panel_nodes"]), "--dtype", "float64",
            "--batch_backend", "panel"]

    def replay(name, argv, wait=False, **overrides):
        """One replay on graphs from a collected allocator; returns its
        figures, what failed, K1's launches by shape and the metric ring
        (None without log_chi2)."""
        gc.collect()
        torch.cuda.empty_cache()
        args = large_inc.build_parser().parse_args(argv)
        rep = large_inc.make_replay(args, **overrides)
        s = rep.solver
        if wait:
            dispatch = s._dispatch_superstep

            def waited():
                dispatch()
                torch.cuda.synchronize()
            s._dispatch_superstep = waited
        steps = record_epochs(rep)
        res = large_inc.run_replay(rep, args, out=log)
        g = s.graphs
        cfg = dataclasses.asdict(s.cfg)
        cfg["dtype"] = str(np.dtype(cfg["dtype"]))
        res.update(phase=f"large-n-{name}", card=card, config=cfg,
                   non_panel_epochs=steps, generation=g.generation,
                   dispatches=dict(g.calls), replays=dict(g.replayed))
        bad = []
        if not g.enabled or sum(g.calls.values()) != \
                sum(g.replayed.values()) + g.captures:
            bad.append(f"dispatches {dict(g.calls)} are not graph replays "
                       f"{dict(g.replayed)} and {g.captures} captures")
        if g.generation != len(res["growths"]):
            bad.append(f"{g.generation} graph generations for "
                       f"{len(res['growths'])} growths")
        c = res["counters"]
        swept = (c["superstep"] - c["sup_nosweep"] + c["sweep_flush"]
                 + c["epoch_panel"])
        by_shape = {(r["shape"][0], r["shape"][1], r["dtype"]): r["launches"]
                    for r in res["tri_inv_launches_by_shape"]}
        if res["tri_inv_launches"] != swept or \
                sum(by_shape.values()) != swept:
            bad.append(f"tri_inv launched {res['tri_inv_launches']} times "
                       f"for {swept} sweeps and panel epochs")
        if not all(np.isfinite(c) for _, c in res["checkpoints"]) or \
                not np.isfinite(res["final_chi2"]):
            bad.append("non-finite chi2")
        hist = s.chi2_history() if s.cfg.log_chi2 else None
        return res, bad, by_shape, hist

    def held(res, bad):
        print(json.dumps(res), flush=True)
        if bad:
            raise AssertionError(f"{res['phase']}: " + "; ".join(bad))

    # float64 parity at lag 0 against the golden's ring
    res, bad, f64, hist = replay("f64", base + ["--checkpoints", "1"],
                                 policy_lag=0, policy_poll=1, log_chi2=True)
    res["ring_entries"] = len(hist)
    if hist.shape == ring.shape:
        err = np.abs(hist - ring) / np.maximum(np.abs(ring), 1e-12)
        res["max_rel_ring_err"] = float(np.max(err))
        if np.any(np.abs(hist - ring) > 1e-6 * np.abs(ring) + 1e-12):
            bad.append(f"ring entry {int(np.argmax(err))} differs")
    else:
        bad.append(f"{hist.shape} ring entries, golden {ring.shape}")
    diff = {k: (res["counters"].get(k, 0), v)
            for k, v in gold["counters"].items()
            if res["counters"].get(k, 0) != v}
    if diff:
        bad.append(f"counters differ (port, golden): {diff}")
    growths = [{k: r[k] for k in ("step", "node_capacity", "factor_capacity")}
               for r in res["growths"]]
    if growths != gold["growths"]:
        bad.append(f"growths {growths} != golden {gold['growths']}")
    caps = (res["node_capacity"], res["factor_capacity"])
    if caps != (gold["node_capacity"], gold["factor_capacity"]):
        bad.append(f"capacities {caps} != golden's")
    if res["epochs"] != gold["epochs"]:
        bad.append(f"epochs {res['epochs']} != golden {gold['epochs']}")
    res["golden"] = {k: gold[k] for k in ("counters", "epochs",
                                          "final_chi2", "seconds")}
    held(res, bad)

    # float64 at the script's lag, each superstep dispatch waited for
    want = lagged["final_chi2"]
    res, bad, _, _ = replay("f64-lagged", base, wait=True)
    res["golden_final_chi2"] = want
    if not abs(res["final_chi2"] - want) < CHI2_BAND:
        bad.append(f"final chi2 {res['final_chi2']!r} vs golden {want!r}")
    held(res, bad)

    # the script's own defaults: float32, 20 000 poses, panel epochs
    res, bad, f32, _ = replay("f32", [])
    res["reference_final_chi2"] = want
    res["rel_to_reference"] = abs(res["final_chi2"] - want) / abs(want)
    if res["node_capacity"] != 32768:
        bad.append(f"final ncap {res['node_capacity']}")
    if not res["rel_to_reference"] < GATE_TOL["large"]:
        bad.append(f"final chi2 {res['final_chi2']!r} is "
                   f"{res['rel_to_reference']:.4%} from {want!r}")
    held(res, bad)
    gc.collect()
    torch.cuda.empty_cache()
    return {"large-n-f64": f64, "large-n-f32": f32}


def run_scaling(K, card: str) -> dict:
    """Phase 16, on a one-rank NCCL group from a collected allocator: the
    scaling bench at its defaults in float64 and float32 against the JAX
    package's CPU figures; the stage profile at its defaults in float32 and
    float64, the float64 chi2 against the BatchSolver's; the communication
    model's rows at 100 000 poses.  Returns K1's launches by shape over the
    phase (none expected: the distributed solve runs no K1)."""
    from aprilsam_tpu_torch import scaling, schur_stages
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.multicard import (SAMPLE_EVERY, hold_to_jax,
                                              jax_entry, read_schur_golden)
    from aprilsam_tpu_torch.parallel import one_rank_group
    from aprilsam_tpu_torch.parallel.schur import partition_graph
    from aprilsam_tpu_torch.scaling_model import model_rows
    from aprilsam_tpu_torch.solver import BatchSolver, SolverConfig
    from aprilsam_tpu_torch.utils.card import card_peaks

    gc.collect()
    torch.cuda.empty_cache()
    peaks = card_peaks(torch.cuda.get_device_name(0))
    K.reset_launches()
    bad = []
    with one_rank_group("cuda") as mesh:
        for dt in ("float64", "float32"):
            t = time.perf_counter()
            args = scaling.build_parser().parse_args(["--dtype", dt])
            res = scaling.bench_rank(mesh, args)
            run = res["sizes"][1]
            rel = abs(run["chi2"] - SCALING_CHI2[dt]) / SCALING_CHI2[dt]
            print(json.dumps({
                "phase": "scaling", "card": card, "dtype": dt,
                "poses": args.poses, "blocks": args.blocks,
                "ni_max": res["ni_max"], "ns": res["ns"],
                "sizes": sorted(res["sizes"]),
                "efficiency": scaling.efficiency(res),
                "seconds": run["seconds"],
                "chi2_initial": res["chi2_initial"], "chi2": run["chi2"],
                "chi2_jax_cpu": SCALING_CHI2[dt], "chi2_rel": rel,
                "tol": SCALING_TOL[dt],
                "phase_s": time.perf_counter() - t}), flush=True)
            if not (np.isfinite(run["chi2"]) and rel <= SCALING_TOL[dt]):
                bad.append(f"scaling {dt}: chi2 {run['chi2']} against "
                           f"{SCALING_CHI2[dt]}")

        t = time.perf_counter()
        g = manhattan_world(**STAGES_GRAPH)
        part = partition_graph(g, STAGES_BLOCKS)
        setup_s = time.perf_counter() - t
        entry = jax_entry(read_schur_golden(), STAGES_GRAPH, STAGES_BLOCKS,
                          STAGES_GN)
        chi2, vs_jax = {}, {}
        for dt in (np.float32, np.float64):
            name = np.dtype(dt).name
            t = time.perf_counter()
            res = schur_stages.profile_stages(mesh, g, part, STAGES_GN, dt,
                                              peaks, out=log)
            schur_stages.report(res, out=log)
            states = res.pop("states")
            chi2[name] = res["chi2"]
            vs_jax[name], fails = hold_to_jax(entry, name, res["chi2"],
                                              states[::SAMPLE_EVERY])
            bad += [f"schur_stages {name}: {f}" for f in fails]
            print(json.dumps({
                "phase": "schur-stages", "card": card, "dtype": name,
                "graph": f"manhattan_world({STAGES_POSES}, seed=0, "
                         "closure_prob=0.02, block=25, "
                         "max_closures_per_pose=1)",
                "blocks": STAGES_BLOCKS, "gn_iters": STAGES_GN,
                "ms_per_gn_iter": res["t_per_gn_s"] * 1e3, **res,
                "graph_and_partition_s": setup_s,
                "phase_s": time.perf_counter() - t}), flush=True)
            if not np.all(np.isfinite(states)):
                bad.append(f"schur_stages {name}: states not finite")

    gc.collect()
    torch.cuda.empty_cache()
    cfg = SolverConfig(node_capacity=1 << 17, factor_capacity=1 << 17,
                       gn_iters=STAGES_GN)
    mono = BatchSolver(cfg, device="cuda")
    t = time.perf_counter()
    mono.solve(g)
    torch.cuda.synchronize()
    mono_s = time.perf_counter() - t
    chi2_mono = mono.chi2()
    del mono
    rel = abs(chi2["float64"] - chi2_mono) / chi2_mono
    print(json.dumps({"phase": "schur-stages-vs-batch", "card": card,
                      "chi2_float64": chi2["float64"],
                      "chi2_float32": chi2["float32"],
                      "chi2_batch": chi2_mono, "chi2_rel_vs_batch": rel,
                      "tol": SCHUR_TOL["chi2_rel_vs_batch"],
                      "vs_jax": vs_jax, "host_batch_s": mono_s}), flush=True)
    if not rel <= SCHUR_TOL["chi2_rel_vs_batch"]:
        bad.append(f"schur_stages float64 chi2 {chi2['float64']} against "
                   f"the batch solve's {chi2_mono}")

    t = time.perf_counter()
    for row in model_rows(g):
        print(json.dumps({"phase": "scaling-model", **row}), flush=True)
    log(f"scaling_model: six rows in {time.perf_counter() - t:.1f} s")
    if bad:
        raise AssertionError("phase 16: " + "; ".join(bad))
    return dict(K.launches_by_shape)


def run_multicard(card: str) -> dict:
    """Phase 17, on every card of the machine, one NCCL rank per card in
    one spawned world (parallel/dryrun.py:run_ranks): multicard.py's full
    spec, held to the JAX package's multi-device golden and to one rank
    (multicard.check); then examples/distributed_solve.py in float64
    under torchrun on every card, its chi2 held to the same example's on
    one rank.  On a machine with one card it prints that it needs two and
    runs nothing.  Returns K1's launches by shape, summed over the
    ranks (none expected: the distributed solve runs no K1)."""
    from aprilsam_tpu_torch.multicard import (SOLVE_TOL, Spec, check,
                                              multicard_rank, read_golden,
                                              read_schur_golden)
    from aprilsam_tpu_torch.parallel.dryrun import run_ranks
    from aprilsam_tpu_torch.schur_stages import report_ranks
    from aprilsam_tpu_torch.utils.card import link_line

    n = torch.cuda.device_count()
    if n < 2:
        print(f"multicard: needs at least two cards; this machine has {n}",
              flush=True)
        return {}
    gc.collect()
    torch.cuda.empty_cache()
    link = link_line()
    spec = Spec(sizes=tuple(sorted({1, 2, n} | ({4} if n >= 4 else set()))))
    t = time.perf_counter()
    results = run_ranks(multicard_rank, n, spec, timeout=900.0,
                        device="cuda")
    world_s = time.perf_counter() - t
    summary, bad = check(results, {**read_golden(), **read_schur_golden()})
    stages = summary.pop("stages")
    report_ranks(stages, out=lambda m: print(m, flush=True))
    for key, row in summary["solves"].items():
        peaks = ", ".join(f"{(b or 0) / 1e9:.3f}" for b in row["peak_bytes"])
        print(f"multicard {key}: {row['ms_per_iter']:.3f} ms per iteration,"
              f" E {row['E']:.4f}, peak GB by rank [{peaks}]", flush=True)
    for dt, row in summary["bench"].items():
        print(f"multicard bench {dt}: " + ", ".join(
            f"E({k}) {e:.4f}" for k, e in row["E"].items()), flush=True)
    print(json.dumps({
        "phase": "multicard", "card": card, "link": link, "cards": n,
        "sizes": spec.sizes, **summary,
        "stages_measured": stages["measured"],
        "stages_collectives": {k: {"counted": c["counted"][0],
                                   "model": c["model"], "equal": c["equal"]}
                               for k, c in stages["collectives"].items()},
        "partitions": {k: v for k, v in results[0].items()
                       if k.startswith("partition")},
        "rank_seconds": [r["seconds"] for r in results],
        "world_s": world_s}, default=str), flush=True)

    # the example in float64 on every card under torchrun, in a session of
    # its own so that a timeout ends every process it started, held to the
    # same example on one rank (this process)
    from aprilsam_tpu_torch.examples import distributed_solve

    t = time.perf_counter()
    example = ["-m", "aprilsam_tpu_torch.examples.distributed_solve",
               "--dtype", "float64"]
    with contextlib.redirect_stdout(io.StringIO()) as one:
        chi2_one = distributed_solve.main(example[2:])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), *example]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=REPO),
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    lines = out.strip().splitlines()
    tol = SOLVE_TOL["float64"]["chi2_rel"]
    rel = None
    if proc.returncode == 0 and lines and lines[0].startswith(
            f"ranks: {n},"):
        rel = abs(float(lines[-1].split("chi2 ")[1]) - chi2_one) / chi2_one
    print(json.dumps({"phase": "multicard-torchrun", "card": card,
                      "link": link, "command": " ".join(cmd[1:]),
                      "rc": proc.returncode, "lines": lines,
                      "one_rank": one.getvalue().strip().splitlines(),
                      "chi2_rel_vs_one_rank": rel, "tol": tol,
                      "seconds": time.perf_counter() - t}), flush=True)
    if rel is None or not rel <= tol:
        bad.append(f"torchrun example: rc {proc.returncode}, "
                   f"{lines[-3:]} against one rank's chi2 {chi2_one}, "
                   f"{err[-2000:]}")
    if bad:
        raise AssertionError("phase 17: " + "; ".join(bad))
    launches = Counter()
    for r in results:
        launches.update(r["tri_inv_launches"])
    return dict(launches)


def sweeps_of(counters: dict) -> int:
    """The dispatches that launch K1 once each: full-path steps, swept
    supersteps, flush()'s sweeps and panel epochs."""
    c = counters
    return (c["full"] + c["superstep"] - c["sup_nosweep"] + c["sweep_flush"]
            + c["epoch_panel"])


def run_row_growth(K, card: str) -> dict:
    """Phase 18: row-capacity growth on graphs, per step and in supersteps
    of 4 (replay_checks.run_row_growth: graphs prepared before the replay
    and again after each growth), held to the JAX package's golden
    (golden/rowgrowth40_jax.txt): row capacity and path per step, each
    returned chi2, ring entry and the final chi2 within relative 1e-6; one
    cache generation per growth and one graph replay per dispatch
    (hold_graphs_over_growth); K1 launched once per full step, swept
    superstep and flush() sweep.  Returns K1's launches by shape."""
    from aprilsam_tpu_torch.replay_checks import (
        ROW_GROWTH_CASES, hold_graphs_over_growth, hold_row_growth,
        read_row_growth_golden, run_row_growth as replay)

    gold = read_row_growth_golden()
    launches, bad = Counter(), []
    for case in ROW_GROWTH_CASES:
        gc.collect()
        torch.cuda.empty_cache()
        K.reset_launches()
        t = time.perf_counter()
        run = replay(case, "cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        s = run["solver"]
        held = hold_row_growth(run["records"], run["ring"],
                               run["final_chi2"], gold[case])
        fails = held.pop("bad") + hold_graphs_over_growth(run)
        if K.launches != sweeps_of(s.counters) or K.launches == 0:
            fails.append(f"tri_inv launched {K.launches} times for "
                         f"{sweeps_of(s.counters)} sweeps")
        print(json.dumps({
            "phase": "row-growth", "case": case, "card": card,
            "config": gold[case]["config"], **held,
            "paths": [r["path"] for r in run["records"]],
            "counters": s.counters, "segments": run["segments"],
            "generation": s.graphs.generation,
            "captures_by_generation": s.graphs.by_generation,
            "tri_inv_launches": K.launches, "seconds": secs}), flush=True)
        bad += [f"{case}: {f}" for f in fails]
        launches.update(K.launches_by_shape)
        del run, s
    if bad:
        raise AssertionError("row-growth: " + "; ".join(bad))
    return dict(launches)


def run_mixed_factors(K, card: str) -> dict:
    """Phase 19: the mixed-factor replay (BASELINE.json config 3) on
    graphs after precompile: manhattan_world(3500, seed=0,
    geopin_every=25), its 140 xytpos priors added as they arrive, per step
    at the default SolverConfig, held to the JAX package's golden
    (golden/manhattan3500_seed0_geopin25.txt) as phase 5 is: every chi2 of
    the ring within relative 1e-6, each path and the census; K1 launched
    once per full-path dispatch; one graph replay per dispatch, the
    largest frontal bucket also captured at every panel count
    (replay_checks.big_bucket_signatures).  Returns K1's launches by
    shape."""
    from aprilsam_tpu_torch.bench import hold_per_step
    from aprilsam_tpu_torch.replay_checks import (MIXED_CONFIG, MIXED_GRAPH,
                                                  MIXED_GOLDEN,
                                                  big_bucket_signatures,
                                                  run_mixed)
    from aprilsam_tpu_torch.solver import IncrementalSolver, SolverConfig

    gold_paths, gold_chi2 = read_golden(MIXED_GOLDEN)
    n = MIXED_GRAPH["n_poses"]
    s = IncrementalSolver(SolverConfig(**MIXED_CONFIG), device="cuda")
    prepared = prepare_graphs(s, n)
    # the largest frontal bucket at every panel count, which the priors
    # reach before default_signatures' late-trajectory counts
    extra = big_bucket_signatures(s, n)
    s.precompile(signatures=extra)
    prepared["big_bucket_signatures"] = [list(sig) for sig in extra]
    s.graphs.calls.clear()
    s.graphs.replayed.clear()
    K.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = run_mixed(s)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    held = hold_per_step(s.chi2_history(), [r["path"] for r in res],
                         gold_chi2, gold_paths)
    bad = held.pop("bad")
    full = s.counters["full"]
    if K.launches != full or K.launches == 0:
        bad.append(f"tri_inv launched {K.launches} times for {full} "
                   "full-path dispatches")
    try:
        use = graph_use(s, "mixed-factors", prepared)
    except AssertionError as e:
        use = {"dispatches": dict(s.graphs.calls),
               "replays": dict(s.graphs.replayed)}
        bad.append(str(e))
    print(json.dumps({
        "phase": "mixed-factors", "card": card,
        "graph": "manhattan_world({n_poses}, seed={seed}, "
                 "geopin_every={geopin_every})".format(**MIXED_GRAPH),
        "config": MIXED_CONFIG, "steps": n, "seconds": secs,
        "poses_per_s": n / secs, **held, "full_dispatches": full,
        "tri_inv_launches": K.launches, "graphs": use}), flush=True)
    if bad:
        raise AssertionError("mixed-factors: " + "; ".join(bad))
    return dict(K.launches_by_shape)


def run_bench(card: str) -> dict:
    """Phase 20: the benchmark's cells (aprilsam_tpu_torch/bench.py), each
    as a user runs it, `python -m aprilsam_tpu_torch.bench --config CELL`
    in a process and session of its own, with one timed run: every
    single-card cell, and on a machine with four cards or more the
    4-card cell.  Each must exit 0 with its gate passed on the card.
    Returns K1's launches by shape of each cell's timed run."""
    from aprilsam_tpu_torch.bench import CELLS

    gc.collect()
    torch.cuda.empty_cache()
    paths = {}
    for name, cell in CELLS.items():
        if cell.chips > torch.cuda.device_count():
            print(f"bench {name}: needs {cell.chips} cards; this machine "
                  f"has {torch.cuda.device_count()}", flush=True)
            continue
        t = time.perf_counter()
        cmd = [sys.executable, "-m", "aprilsam_tpu_torch.bench", "--config",
               name, "--runs", "1"]
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env=dict(os.environ, PYTHONPATH=REPO),
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        lines = out.strip().splitlines()
        line = json.loads(lines[-1]) if lines and lines[-1].startswith(
            "{") else {}
        run = (line.get("runs") or [{}])[0]
        print(json.dumps({
            "phase": f"bench-{name}", "card": card,
            "command": " ".join(cmd[1:]), "rc": proc.returncode,
            "seconds": time.perf_counter() - t,
            "metrics": {k: v["value"] for k, v in
                        line.get("metrics", {}).items()},
            "gate": line.get("gate"), "layers_k1": line.get(
                "layers", {}).get("k1")}, default=str), flush=True)
        if proc.returncode != 0 or line.get("platform") != "gpu" or \
                not line["gate"]["ok"]:
            raise AssertionError(f"bench {name}: rc {proc.returncode}, "
                                 f"{lines[-1:]}, {err[-2000:]}")
        paths[f"bench-{name}"] = {
            (r["shape"][0], r["shape"][1], r["dtype"]): r["launches"]
            for r in run.get("tri_inv_launches_by_shape", [])}
        if cell.gate != "schur" and not paths[f"bench-{name}"]:
            raise AssertionError(f"bench {name}: K1 was not launched")
    return paths


def epochs_of(counters: dict) -> dict:
    return {k: counters[f"epoch_{k}"] for k in ("panel", "dense", "host")}


def run_superstep(K, card: str, name: str, entry: dict,
                  ring=None) -> tuple:
    """Phases 6 and 9, one config: the replay of manhattan_world(3500,
    seed=0) in deferred mode on the card.  With `ring`, every metric-ring
    entry is held to relative 1e-6 and the counters to the golden's;
    otherwise the final chi2 to CHI2_BAND.  Where the golden records the
    epochs by backend, they must be equal.  Returns the tri_inv launches
    by shape."""
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.replay import Replay

    loaded = manhattan_world(3500, seed=0)
    rep = Replay(loaded, golden_config(entry), deferred=True, device="cuda")
    solver = rep.solver
    prepared = prepare_graphs(solver)
    syncs = SyncCounter(solver)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, by_shape = K.launches, dict(K.launches_by_shape)
    final = solver.chi2()
    c = solver.counters
    swept = (c["superstep"] - c["sup_nosweep"] + c["sweep_flush"]
             + c["epoch_panel"])
    summary = {
        "phase": f"superstep-{name}", "card": card,
        "config": entry["config"], "steps": loaded.nnodes,
        "seconds": secs, "poses_per_s": loaded.nnodes / secs,
        "final_chi2": final, "counters": c,
        "golden_counters": entry.get("counters"),
        "epochs": epochs_of(c), "golden_epochs": entry.get("epochs"),
        "sync_debug": syncs.summary(), "tri_inv_launches": launches,
        "tri_inv_launches_by_shape": [
            {"shape": [B, N, N], "dtype": dt, "launches": n}
            for (B, N, dt), n in sorted(by_shape.items())],
        "graphs": graph_use(solver, f"superstep-{name}", prepared)}
    bad = []
    if ring is not None:
        hist = solver.chi2_history()
        summary["ring_entries"] = len(hist)
        if hist.shape == ring.shape:
            err = np.abs(hist - ring) / np.maximum(np.abs(ring), 1e-12)
            summary["max_rel_ring_err"] = float(np.max(err))
            if np.any(np.abs(hist - ring) > 1e-6 * np.abs(ring) + 1e-12):
                bad.append(f"ring entry {int(np.argmax(err))} differs")
        else:
            bad.append(f"{hist.shape} ring entries, golden {ring.shape}")
        diff = {k: (c.get(k, 0), v) for k, v in entry["counters"].items()
                if c.get(k, 0) != v}
        if diff:
            bad.append(f"counters differ (port, golden): {diff}")
    else:
        want = entry["final_chi2"]
        summary["golden_final_chi2"] = want
        if not abs(final - want) < CHI2_BAND:
            bad.append(f"final chi2 {final!r} vs {want!r}")
    print(json.dumps(summary), flush=True)
    if not np.isfinite(final):
        bad.append("non-finite final chi2")
    if "epochs" in entry and epochs_of(c) != entry["epochs"]:
        bad.append(f"epochs {epochs_of(c)} != golden {entry['epochs']}")
    if syncs.sites:
        bad.append(f"synchronizing calls in superstep dispatches: "
                   f"{dict(syncs.sites)}")
    if launches != swept or sum(by_shape.values()) != launches:
        bad.append(f"tri_inv launched {launches} times for {swept} sweeps "
                   "and panel epochs")
    if name == "windowed":
        wins = by_shape.get((8, 384, "float64"), 0)
        if c["sweep_win"] == 0 or wins < c["sweep_win"]:
            bad.append(f"{c['sweep_win']} windowed sweeps, {wins} tri_inv "
                       "launches at [8,384,384]")
    if bad:
        raise AssertionError(f"superstep {name}: " + "; ".join(bad))
    return by_shape


def run_device_epochs(K, card: str) -> dict:
    """Phase 8.  Returns the tri_inv launches by shape of the panel epoch
    that is held against the host epoch."""
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.solver import BatchSolver, SolverConfig
    from aprilsam_tpu_torch.solver.batch import run_batch_epoch

    g = manhattan_world(3500, seed=0)
    n = g.nnodes
    tables = (g.ftype[:g.nfactors], g.fnodes[:g.nfactors])

    def epoch(backend):
        """The checked epoch from the graph's initial states, then the
        median of 3 timed epochs after a warm-up (each from the states the
        last left)."""
        s = BatchSolver(SolverConfig(batch_backend=backend), device="cuda")
        K.reset_launches()
        t0 = time.perf_counter()
        info = s.solve(g)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        by_shape = dict(K.launches_by_shape)
        snap = {k: getattr(s.ds, k)[:n].cpu().numpy()
                for k in ("R_blocks", "y", "state")}
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            s.solve(g)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        # a device epoch as the lagged policy runs it (lazy: no read of
        # the device): the host's time to plan and enqueue it, median of 3
        enqueue = []
        if backend != "host":
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.ds, _sym, _info, _b = run_batch_epoch(
                    s.ds, s.cfg, n, *tables, log_mode=2, lazy=True,
                    graphs=s.graphs)
                enqueue.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
        return (s, info, snap, by_shape, median(times[1:]), first,
                median(enqueue) if enqueue else None)

    def host_phases(cfg):
        """The host's work before a device epoch's first operation: the
        native symbolic phase and, for the panel epoch, its plan; ms,
        median of 3 (None where there is no plan)."""
        from aprilsam_tpu_torch.solver.batch import epoch_symbolic
        from aprilsam_tpu_torch.solver.panel_epoch import build_panel_plan

        sym_ms, plan_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            sym, _pat, _valid = epoch_symbolic(cfg, n, *tables)
            t1 = time.perf_counter()
            sym_ms.append((t1 - t0) * 1e3)
            if cfg.batch_backend == "panel":
                build_panel_plan(cfg, n, sym, sym.pad_idx, sym.pad_nnz,
                                 *tables)
                plan_ms.append((time.perf_counter() - t1) * 1e3)
        return median(sym_ms), median(plan_ms) if plan_ms else None

    h_s, h_info, h_snap, _h_shapes, h_ms, _, _ = epoch("host")
    panel_shapes = {}
    for backend in ("device", "panel"):
        s, info, snap, by_shape, ms, first, enqueue_ms = epoch(backend)
        err = {k: float(np.max(np.abs(snap[k] - h_snap[k]))) for k in snap}
        rel = abs(info.chi2 - h_info.chi2) / abs(h_info.chi2)
        same_order = bool(np.array_equal(s.sym.order, h_s.sym.order))
        sym_ms, plan_ms = host_phases(s.cfg)
        print(json.dumps({
            "phase": f"epoch-{'dense' if backend == 'device' else 'panel'}",
            "card": card, "graph": "manhattan_world(3500, seed=0)",
            "dtype": "float64", "ms": ms, "host_epoch_ms": h_ms,
            "lazy_enqueue_ms": enqueue_ms, "host_symbolic_ms": sym_ms,
            "host_panel_plan_ms": plan_ms,
            "first_call_s": first, "chi2": info.chi2,
            "host_chi2": h_info.chi2, "chi2_rel_err": rel,
            "max_abs_err": err, "same_order": same_order, "spd": info.spd,
            "tol": EPOCH_TOL,
            "tri_inv_launches_by_shape": [
                {"shape": [B, N, N], "dtype": dt, "launches": c}
                for (B, N, dt), c in sorted(by_shape.items())]}),
            flush=True)
        bad = [k for k in err if not err[k] <= EPOCH_TOL[k]]
        if not (same_order and info.spd and rel <= EPOCH_TOL["chi2_rel"]) \
                or bad:
            raise AssertionError(
                f"{backend} epoch vs host: order {same_order}, spd "
                f"{info.spd}, chi2 rel {rel}, errors {err}")
        want = {(32, 384, "float64"): 1} if backend == "panel" else {}
        if by_shape != want:
            raise AssertionError(f"{backend} epoch launched tri_inv "
                                 f"{by_shape}, expected {want}")
        if backend == "panel":
            panel_shapes = by_shape
    return panel_shapes


def run_bundled(K, card: str, name: str, entry: dict, poses: int) -> dict:
    """Phase 10, one config: the per-step replay of manhattan_world(poses,
    seed=0) in bundles, deferred, on the card.  Returns the tri_inv
    launches by shape."""
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.replay import Replay

    loaded = manhattan_world(poses, seed=0)
    rep = Replay(loaded, golden_config(entry), deferred=True, device="cuda")
    solver = rep.solver
    prepared = prepare_graphs(solver, poses)
    syncs = SyncCounter(solver, "bundles")
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rep.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, by_shape = K.launches, dict(K.launches_by_shape)
    final = solver.chi2()
    c = solver.counters
    census = {p: sum(r.path == p for r in res) for p in ("fast", "full",
                                                          "batch")}
    sweeps = c["full"] - c["full_coalesced"] + c["sweep_coalesced"]
    want = entry["final_chi2"]
    print(json.dumps({
        "phase": name,
        "card": card, "config": entry["config"],
        "graph": f"manhattan_world({poses}, seed=0)", "steps": len(res),
        "seconds": secs, "poses_per_s": len(res) / secs,
        "final_chi2": final, "golden_final_chi2": want, "census": census,
        "golden_census": entry.get("census"), "counters": c,
        "epochs": epochs_of(c), "golden_epochs": entry.get("epochs"),
        "sync_debug": syncs.summary(), "tri_inv_launches": launches,
        "tri_inv_launches_by_shape": [
            {"shape": [B, N, N], "dtype": dt, "launches": k}
            for (B, N, dt), k in sorted(by_shape.items())],
        "graphs": graph_use(solver, name, prepared)}), flush=True)
    bad = []
    if not abs(final - want) < CHI2_BAND:
        bad.append(f"final chi2 {final!r} vs {want!r}")
    if syncs.sites:
        bad.append(f"synchronizing calls in bundle dispatches: "
                   f"{dict(syncs.sites)}")
    if syncs.dispatches == 0:
        bad.append("no bundle was dispatched")
    if launches != sweeps or sum(by_shape.values()) != launches:
        bad.append(f"tri_inv launched {launches} times for {sweeps} sweeps")
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad))
    return by_shape


def run_graphpath(K, card: str, entry: dict) -> dict:
    """Phase 7: the CLI on the card, reading the graph through the port's
    binary (stype) writer and reader."""
    from aprilsam_tpu_torch import cli
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.io import save_graph_file

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "manhattan3500.graph")
        save_graph_file(manhattan_world(3500, seed=0), path)
        out = io.StringIO()
        K.reset_launches()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--graphpath", path, "--superstep", "96",
                           "--dtype", "float64", "--no_wallclock_gate",
                           "--device", "cuda", "--quiet", "--json"])
    by_shape = dict(K.launches_by_shape)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    want = entry["final_chi2"]
    print(json.dumps({"phase": "cli-graphpath", "card": card, **res,
                      "golden_final_chi2": want,
                      "tri_inv_launches": K.launches}), flush=True)
    if rc != 0 or not abs(res["final_chi2"] - want) < CHI2_BAND:
        raise AssertionError(f"cli --graphpath: rc {rc}, final chi2 "
                             f"{res['final_chi2']!r} vs {want!r}")
    if K.launches == 0:
        raise AssertionError("cli --graphpath never launched tri_inv")
    return by_shape


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script "
            "needs an NVIDIA card")
        return 1
    sys.path.insert(0, REPO)
    from aprilsam_tpu_torch import native
    from aprilsam_tpu_torch.kernels import frontal_qr as K2
    from aprilsam_tpu_torch.kernels import tri_inv as K
    from aprilsam_tpu_torch.utils.card import card_line, card_peaks
    from aprilsam_tpu_torch.utils import setup_precision

    # 1. device
    t_start = time.perf_counter()
    smi = card_line()
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

    with ThreadPoolExecutor(3) as ex:
        f_kernel = ex.submit(timed, K.build)
        f_k2 = ex.submit(timed, K2.build)
        f_native = ex.submit(timed, native.build)
        build_s = {"tri_inv.cu (nvcc sm_90a)": f_kernel.result(),
                   "frontal_qr.cu (nvcc sm_90a)": f_k2.result(),
                   "sam_native.c (cc)": f_native.result()}
    print(json.dumps({"phase": "build", "seconds": build_s}), flush=True)
    for lib in (K, K2):
        with open(lib.build() + ".log") as f:
            for fig in ptxas_figures(f.read()):
                print(json.dumps({"phase": "ptxas", **fig}), flush=True)

    # 3. the kernels against their plain versions
    rows = check_tri_inv(K, peaks)
    main_row = rows[(32, 384, "float64")]
    k2_rows = check_frontal_qr(K2, peaks)

    # 4-5. the tutorial, then the main path (which saves a checkpoint)
    run_tutorial()
    tmp = tempfile.TemporaryDirectory()
    ckpt_path = os.path.join(tmp.name, "solver.npz")
    by_shape, ckpt = run_main_path(K, smi, ckpt_path)
    k2_main = dict(K2.launches_by_shape)
    paths = {"per-step": by_shape}

    # 6-7. the throughput replays, then the CLI with --graphpath
    head, ring, _ = read_super_golden()
    paths["superstep-ring"] = run_superstep(K, smi, "ring", head, ring)
    for name in ("bench", "windowed"):
        paths[f"superstep-{name}"] = run_superstep(K, smi, name, head[name])
    paths["cli-graphpath"] = run_graphpath(K, smi, head["cli"])

    # 8-10. the device epochs, the panel-backend superstep replays, the
    # bundled replays; each phase prints its seconds
    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(json.dumps({"phase_seconds": name,
                          "seconds": time.perf_counter() - t}), flush=True)
        return out

    paths["epoch-panel"] = phase("device-epochs", run_device_epochs, K, smi)
    head, ring, _ = read_super_golden(PANEL_GOLDEN)
    paths["superstep-panel-ring"] = phase(
        "superstep-panel-ring", run_superstep, K, smi, "panel-ring", head,
        ring)
    paths["superstep-panel-bench"] = phase(
        "superstep-panel-bench", run_superstep, K, smi, "panel-bench",
        head["bench"])
    head, _ring, poses = read_super_golden(BUNDLED_GOLDEN)
    for name in ("bundled", "bundled-coalesced"):
        paths[name] = phase(name, run_bundled, K, smi, name, head[name],
                            poses)

    # 11-12. the checkpoint's resumed half, the distributed solves
    with tmp:
        paths["checkpoint-resume"] = phase(
            "checkpoint-resume", run_checkpoint_resume, K, smi, ckpt_path,
            ckpt)
    phase("distributed", run_distributed, smi)

    # 13-14. the ahead-of-time surface: precompile, graphs against eager;
    # float32 on graphs
    phase("aot", run_aot, K, smi)
    paths["float32"] = phase("float32", run_float32, K, smi)

    # 15. the large-N replay across its capacity growths
    paths.update(phase("large-n", run_large, K, smi))

    # 16. the scaling tools of the distributed solve
    paths["scaling"] = phase("scaling", run_scaling, K, smi)

    # 17. the distributed solves across every card of the machine
    paths["multicard"] = phase("multicard", run_multicard, smi)

    # 18-19. row-capacity growth on graphs, the mixed-factor replay
    paths["row-growth"] = phase("row-growth", run_row_growth, K, smi)
    paths["mixed-factors"] = phase("mixed-factors", run_mixed_factors, K,
                                   smi)

    # 20. the benchmark's cells, each in a process of its own
    paths.update(phase("bench", run_bench, smi))

    # 21. the kernels line, the card, the result; K1's share of each
    # replay is its launches at each shape times that shape's time from
    # phase 3
    print(json.dumps({"phase_seconds": "all",
                      "seconds": time.perf_counter() - t_start}), flush=True)
    for counts in paths.values():
        for key in counts:
            if key not in rows:
                B, N, dt = key
                rows[key] = measure_tri_inv(K, peaks, B, N,
                                            getattr(torch, dt))

    def weighted(counts):
        shapes = [{
            "shape": rows[key]["shape"], "dtype": rows[key]["dtype"],
            "launches": c, "ms": rows[key]["kernel_ms"],
            "library_ms": rows[key]["library_ms"],
            "bound_ms": rows[key]["bound_us"] / 1e3}
            for key, c in sorted(counts.items())]
        return {"launches": sum(counts.values()), "shapes": shapes,
                "kernel_ms": sum(r["launches"] * r["ms"] for r in shapes),
                "library_ms": sum(r["launches"] * r["library_ms"]
                                  for r in shapes)}

    by_path = {name: weighted(counts) for name, counts in paths.items()}
    # K2 on the main path by shape: its device time and cuSOLVER's (the
    # plain version's kernels) at the shape's row of phase 3b
    k2_shapes = [{
        "shape": [n3, p], "dtype": dt, "launches": c,
        "ms": k2_rows[(n3, p, dt)]["kernel_ms"],
        "plain_device_ms": k2_rows[(n3, p, dt)]["plain_device_ms"]}
        for (n3, p, dt), c in sorted(k2_main.items()) if (n3, p, dt) in k2_rows]
    k2_main_row = k2_rows[(768, 96, "float64")]
    print(json.dumps({"kernels": [{
        "name": "tri_inv", "route": "cuda",
        "source": "aprilsam_tpu_torch/csrc/tri_inv.cu",
        "replaces": K.REPLACES,
        "launches": sum(v["launches"] for v in by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": main_row["max_abs_err"],
        "max_rel_err": main_row["max_rel_err"],
        "shape": main_row["shape"], "dtype": main_row["dtype"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_us"] / 1e3,
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}, {
        "name": "frontal_qr", "route": "cuda",
        "source": "aprilsam_tpu_torch/csrc/frontal_qr.cu",
        "replaces": K2.REPLACES,
        "launches_main_path": sum(k2_main.values()),
        "main_path_by_shape": k2_shapes,
        "main_path_kernel_ms": sum(r["launches"] * r["ms"]
                                   for r in k2_shapes),
        "main_path_plain_device_ms": sum(r["launches"] * r["plain_device_ms"]
                                         for r in k2_shapes),
        "max_rel_err": k2_main_row["max_rel_err"],
        "shape": k2_main_row["shape"], "live": k2_main_row["live"],
        "dtype": k2_main_row["dtype"], "ms": k2_main_row["kernel_ms"],
        "plain_ms": k2_main_row["plain_ms"],
        "plain_device_ms": k2_main_row["plain_device_ms"],
        "bound_ms": k2_main_row["bound_us"] / 1e3,
        "bound_by": k2_main_row["bound_by"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
