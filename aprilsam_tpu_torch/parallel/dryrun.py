"""Multi-rank dry run of the distributed solves, and a launcher for
several ranks.

Counterpart of ``__graft_entry__.py:_small_problem`` and
``dryrun_multichip``: the data-parallel batch solve and the keyframe-block
Schur solve (replicated and distributed separator), at the JAX package's
sizes and tolerances, on whatever group the caller's mesh holds (one NCCL
rank per card, or gloo ranks on the CPU).  ``run_ranks`` starts a world
of processes (gloo on the CPU, NCCL one card per rank) and runs a
function on each rank.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..datasets import manhattan_world
from ..geometry import np_mod2pi
from .dist import (COLLECTIVE_TIMEOUT_S, Mesh, dp_batch_solve, init_group,
                   local_shard, shard_factor_tables)
from .schur import partition_graph, schur_solve


def _small_problem(n=32, seed=0):
    """A little pose chain with a loop closure (host numpy)."""
    rng = np.random.default_rng(seed)
    states = np.zeros((n, 3))
    states[:, 0] = np.arange(n)
    states[:, 1] = 0.05 * rng.standard_normal(n)
    a = np.arange(n - 1, dtype=np.int32)
    b = a + 1
    # one loop closure
    a = np.concatenate([a, [0]]).astype(np.int32)
    b = np.concatenate([b, [n - 1]]).astype(np.int32)
    z = np.zeros((n, 3))
    z[:-1, 0] = 1.0
    z[-1] = [n - 1.0, 0.3, 0.0]
    W = np.tile(np.diag([100.0, 100.0, 400.0]), (n, 1, 1))
    return states, a, b, z, W


def small_dp_solve(mesh: Mesh, n: int, seed: int, dtype, tikhonov: float):
    """dp_batch_solve of `_small_problem(n, seed)` over the mesh, the
    factor tables padded to the mesh size and split over the ranks, with an
    empty prior table (one invalid row per rank)."""
    dev = mesh.device
    states, a, b, z, W = _small_problem(n, seed=seed)
    valid = np.ones(a.shape[0], dtype=bool)
    a, b, z, W, valid = local_shard(
        mesh, *shard_factor_tables(mesh.size, a, b, z, W, valid))

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=dev)

    st = t(states)
    return dp_batch_solve(
        mesh, st, st, torch.arange(n, device=dev),
        t(a, torch.int64), t(b, torch.int64), t(z), t(W), t(valid, None),
        torch.zeros(1, dtype=torch.int64, device=dev),
        torch.zeros((1, 3), dtype=dtype, device=dev),
        torch.zeros((1, 3, 3), dtype=dtype, device=dev),
        torch.zeros(1, dtype=torch.bool, device=dev),
        MB=n, tikhonov=tikhonov)


def _max_diff(a, b) -> float:
    """Largest difference of two state tables entry by entry, over all
    three columns, angles as they are: the JAX dry run's figure
    (``__graft_entry__.py:132,146``)."""
    return float(np.max(np.abs(a - b)))


def _max_diff_mod2pi(a, b) -> float:
    """The same with the angle differences taken mod 2pi (printed beside
    it: two angles near +-pi may lie 2pi apart)."""
    d = a - b
    d[:, 2] = np_mod2pi(d[:, 2])
    return float(np.max(np.abs(d)))


def dryrun_multichip(mesh: Mesh, states: dict = None) -> dict:
    """Run one step of both multi-rank strategies over the mesh, in
    float32, as the JAX package's dry run does:

      1. data-parallel assembly: factor tables split over the ranks,
         all-reduced normal equations, replicated factorization;
      2. keyframe-block domain decomposition on 8*D poses, with the
         replicated separator and with the distributed one at 8-scalar
         blocks (several block rows per rank), within 5e-2 of each other;
      3. the same pair at 512*D poses with 128-scalar blocks.

    Raises AssertionError on a failed check; returns what it measured.
    Where `states` is a dict, the states of step 3 go there by separator
    mode ("replicated", "distributed")."""
    D = mesh.size
    x, _y, _L = small_dp_solve(mesh, 16, seed=1, dtype=torch.float32,
                               tikhonov=1e-2)
    if not torch.isfinite(x).all():
        raise AssertionError("dp_batch_solve gave non-finite dx")
    out = {"ranks": D, "dp_dx_norm": float(torch.linalg.norm(x))}

    g = manhattan_world(8 * D, seed=2, closure_prob=0.3, block=4)
    part = partition_graph(g, D)
    s_rep = schur_solve(mesh, g, part, gn_iters=1, dtype=np.float32)
    if not np.all(np.isfinite(s_rep)):
        raise AssertionError("schur_solve (replicated) not finite")
    out["small_ns"] = part.ns
    if part.ns > 0:
        s_dist = schur_solve(mesh, g, part, gn_iters=1, dtype=np.float32,
                             sep_dist=True, sep_block=8)
        out["small_sep_diff"] = _max_diff(s_dist, s_rep)
        out["small_sep_diff_mod2pi"] = _max_diff_mod2pi(s_dist, s_rep)
        if not (np.all(np.isfinite(s_dist))
                and out["small_sep_diff"] < 5e-2):
            raise AssertionError(f"separator modes differ by "
                                 f"{out['small_sep_diff']}")

    # realistically shaped: ~512 poses per rank, full-width 128-scalar
    # pchol blocks spanning several block rows per rank, chunked interior
    # elimination, float32 with the equilibrated jitter
    g2 = manhattan_world(512 * D, seed=3, closure_prob=0.2, block=25)
    part2 = partition_graph(g2, D)
    sr = schur_solve(mesh, g2, part2, gn_iters=1, dtype=np.float32)
    sd = schur_solve(mesh, g2, part2, gn_iters=1, dtype=np.float32,
                     sep_dist=True, sep_block=128)
    out.update(large_poses=g2.nnodes, large_ns=part2.ns,
               large_sep_diff=_max_diff(sd, sr),
               large_sep_diff_mod2pi=_max_diff_mod2pi(sd, sr))
    if states is not None:
        states.update(replicated=sr, distributed=sd)
    if not (np.all(np.isfinite(sr)) and np.all(np.isfinite(sd))
            and out["large_sep_diff"] < 5e-2):
        raise AssertionError(f"separator modes differ by "
                             f"{out['large_sep_diff']} at {g2.nnodes} poses")
    return out


def _rank_main(rank, world_size, store_path, device, timeout, fn, args,
               results):
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        mesh = init_group(rank, world_size, store_path, device=device,
                          timeout=timeout)
    except Exception:                      # reported to the launcher
        results.put((rank, traceback.format_exc(), None))
        return
    try:
        results.put((rank, None, fn(mesh, *args)))
    except Exception:
        # reported before the group is torn down: the launcher ends the
        # world at once, whatever the other ranks wait for
        results.put((rank, traceback.format_exc(), None))
        return
    dist.destroy_process_group()


def _stop(procs, grace: float) -> None:
    """Join each process for up to `grace` seconds in all; kill the rest."""
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def run_ranks(fn, world_size: int, *args, timeout: float = 600.0,
              device: str = "cpu",
              collective_timeout: float = COLLECTIVE_TIMEOUT_S) -> list:
    """Run fn(mesh, *args) on each rank of a world of `world_size` spawned
    processes (fn and args must pickle, fn by import path): gloo ranks on
    the CPU, or with device="cuda" NCCL ranks, rank r on card r.  Only
    host values should come back: each rank's result is pickled through a
    queue.  Returns the ranks' results in rank order; raises if a rank
    fails (with its traceback; the other ranks are ended at once), if a
    collective waits longer than `collective_timeout` seconds, or if the
    world does not finish within `timeout` seconds."""
    if device == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} NCCL ranks need {world_size} cards; "
                         f"this machine has {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, store, device,
                                   collective_timeout, fn, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got, dead_before, failed = {}, [], True
        try:
            deadline = time.monotonic() + timeout
            while len(got) < world_size:
                try:
                    rank, err, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    # a rank that exited with no result on two polls in a
                    # row (its last put has reached the pipe by then)
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got]
                    if dead and dead == dead_before:
                        codes = [procs[r].exitcode for r in dead]
                        raise RuntimeError(f"ranks {dead} exited with no "
                                           f"result (exit codes {codes})"
                                           ) from None
                    dead_before = dead
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world_size} ranks did not "
                                           f"finish in {timeout} s") from None
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                got[rank] = value
            failed = False
        finally:
            _stop(procs, 1.0 if failed else 60.0)
    return [got[r] for r in range(world_size)]
