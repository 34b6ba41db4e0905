"""Distributed solves over a torch.distributed process group.

Counterpart of ``aprilsam_tpu/parallel/dist.py``.  The reference is
single-threaded C (SURVEY.md section 2.7); the scaling design has two
stages:

  1. data-parallel assembly (this module, `dp_batch_solve`): the factor
     tables are split over the ranks, each rank linearizes and scatter-adds
     its shard of J^T W J / J^T W r, one all-reduce gives every rank the
     normal equations, and the factorization and solves run replicated;
  2. keyframe-block domain decomposition (parallel/schur.py).

The JAX package runs one program over a device mesh (shard_map); the port
is one process per rank (SPMD over torch.distributed): each rank calls the
same function with its own shard, the psum is a ``dist.all_reduce`` on the
rank's group, and the outputs are the same on every rank.  NCCL carries
the collectives between cards, gloo between CPU processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.assembly import assemble_block_dense
from ..solver.batch import cholesky_nan
from ..utils import resolve_device, setup_precision


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one distributed solve: a process group (None = the
    default group) and this rank's device."""

    group: Optional[dist.ProcessGroup]
    device: torch.device

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


def make_mesh(group: Optional[dist.ProcessGroup] = None,
              device="cuda") -> Mesh:
    """The mesh of an initialized process group on this rank's device (a
    card without an index is the current one)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized; call "
                           "init_process_group (or use init_group)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    setup_precision()
    return Mesh(group=group, device=dev)


# how long a collective may wait for the other ranks before it raises (or,
# on NCCL, the watchdog ends the process): above the longest stretch in
# which one rank works alone while the others wait in a collective
COLLECTIVE_TIMEOUT_S = 300.0


def _init_process_group(dev: torch.device, timeout: float, **kw) -> None:
    """NCCL bound to this rank's card (its communicator is made here, not
    at the first collective), or gloo on the CPU; a collective that waits
    longer than `timeout` seconds fails."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=timeout),
                            **kw)


def init_group(rank: int, world_size: int, store_path: str,
               device="cuda", timeout: float = COLLECTIVE_TIMEOUT_S) -> Mesh:
    """Initialize the default process group from a FileStore at
    `store_path` (no network): NCCL on cards, rank r on card r (or on the
    card `device` names); gloo on the CPU.  Returns its mesh."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    _init_process_group(dev, timeout,
                        store=dist.FileStore(store_path, world_size),
                        rank=rank, world_size=world_size)
    return make_mesh(None, dev)


@contextlib.contextmanager
def launched_mesh(device="cuda"):
    """The caller's group, the world torchrun started (one card per rank),
    or a world of one rank on `device` for the duration of the block."""
    if dist.is_initialized():
        yield make_mesh(device=device)
    elif "TORCHELASTIC_RUN_ID" in os.environ:        # started by torchrun
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        _init_process_group(dev, COLLECTIVE_TIMEOUT_S)
        try:
            yield make_mesh(device=dev)
        finally:
            dist.destroy_process_group()
    else:
        with one_rank_group(device) as mesh:
            yield mesh


@contextlib.contextmanager
def one_rank_group(device="cuda"):
    """A world of one rank on `device` for the duration of the block, torn
    down at its end."""
    with tempfile.TemporaryDirectory() as tmp:
        mesh = init_group(0, 1, os.path.join(tmp, "store"), device)
        try:
            yield mesh
        finally:
            dist.destroy_process_group()


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh's group; on NCCL on the rank's own
    card (a barrier without a device guesses one)."""
    if mesh.device.type == "cuda":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def subgroups(mesh: Mesh, sizes) -> dict:
    """{k: the mesh of ranks 0..k-1 of the world `mesh`, or None on a rank
    outside it} for each size k.  Every rank of the world calls it with
    the same sizes, and each group is made once."""
    out = {}
    for k in sorted(set(sizes)):
        group = (mesh.group if k == mesh.size
                 else dist.new_group(list(range(k))))
        out[k] = Mesh(group, mesh.device) if mesh.rank < k else None
    return out


def clocked(mesh: Mesh, fn):
    """(seconds, fn()) on this rank: the clock starts after every rank of
    the mesh has reached it and ends on the rank's card."""
    barrier(mesh)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    value = fn()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return time.perf_counter() - t0, value


def slowest(mesh: Mesh, values) -> list:
    """The largest of each of this rank's values over the mesh's ranks (a
    time is the slowest rank's)."""
    t = torch.tensor(values, dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t.tolist()


def dp_batch_solve(
    mesh: Mesh,
    l_points,       # [NCAP, 3] replicated
    states,         # [NCAP, 3] replicated
    pos,            # [NCAP] replicated
    xyt_a, xyt_b, xyt_z, xyt_W, xyt_valid,   # this rank's shard
    pos_node, pos_z, pos_W, pos_valid,       # this rank's shard
    MB: int,
    tikhonov: float,
):
    """Distributed batch Gauss-Newton linear solve.  Each rank passes its
    shard of the padded factor tables (`local_shard`); invalid rows add
    nothing.  Returns (dx [3MB], y [3MB], L [3MB, 3MB]), the same on every
    rank."""
    W = torch.where(xyt_valid[:, None, None], xyt_W, 0.0)
    pW = torch.where(pos_valid[:, None, None], pos_W, 0.0)
    A, B = assemble_block_dense(l_points, states, pos, xyt_a, xyt_b, xyt_z,
                                W, pos_node, pos_z, pW, MB=MB, tikhonov=0.0)
    # reduce the normal equations over the ranks
    dist.all_reduce(A, group=mesh.group)
    dist.all_reduce(B, group=mesh.group)
    A.diagonal().add_(tikhonov)
    L = cholesky_nan(A)
    y = torch.linalg.solve_triangular(L, B[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    return x[:, 0], y[:, 0], L


def shard_factor_tables(n_devices: int, xyt_a, xyt_b, xyt_z, xyt_W,
                        xyt_valid):
    """Pad factor arrays to a multiple of the mesh size (host helper)."""
    F = xyt_a.shape[0]
    Fp = ((F + n_devices - 1) // n_devices) * n_devices
    pad = Fp - F

    def p(a, fill=0):
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1),
                      constant_values=fill)

    return p(xyt_a), p(xyt_b), p(xyt_z), p(xyt_W), p(xyt_valid)


def local_shard(mesh: Mesh, *arrays):
    """Rank r's contiguous 1/size of each padded array along axis 0 (the
    JAX package's P("dp") split)."""
    D, r = mesh.size, mesh.rank
    out = []
    for a in arrays:
        if a.shape[0] % D:
            raise ValueError(f"{a.shape[0]} rows do not split over {D} ranks")
        k = a.shape[0] // D
        out.append(a[r * k:(r + 1) * k])
    return out
