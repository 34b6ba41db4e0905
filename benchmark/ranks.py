"""Cells of several ranks: a world of N processes, one card each (NCCL),
or on the CPU gloo processes (the tests).

The harness process is rank 0.  `World.launch` writes the job (the entry
every rank runs, its arguments, the cell) into a directory of its own
under the temporary directory and starts ranks 1..N-1 as

    python3 -m benchmark.ranks DIRECTORY RANK

from the checkout's root, their standard output sent to rank 0's standard
error (only rank 0 writes standard output).  Every rank then runs the
same entry with its `World`: it generates the same graphs from the seed,
joins the group (`join`, a FileStore in the directory: no network) and
runs the same passes in lockstep, each clock started after a barrier and
taken as the slowest rank's (`slowest`).

A rank that fails ends the run, never hangs it, and leaves no process:
  * a rank 1..N-1 that raises prints its traceback and exits 1; one that
    dies or exits non-zero is seen by rank 0's watch, which ends the
    others and exits non-zero itself;
  * a collective that waits longer than the workload's
    `collective_timeout_s` (by default the program's 300 s) fails: gloo
    raises, and rank 0 then ends the others; NCCL's watchdog ends the
    process (TORCH_NCCL_ASYNC_ERROR_HANDLING 3);
  * a rank 1..N-1 dies with rank 0 (PR_SET_PDEATHSIG).

A world of one rank that the driver does not ask a group of (the replay
cells) is no world at all: no process, no group, and every collective
the identity, so such a cell runs exactly as a plain run.

The group is the program's own (``parallel/dist.py``: `init_group`,
`barrier`, its collective timeout), the one a deployment of the port
makes.  What the harness reads through it is its own: a pass's seconds
(`slowest`) and the ranks' answers and readings (`gather`) are the
yardstick's, and stay here, where the program cannot change them.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import traceback

import torch
import torch.distributed as dist

from aprilsam_tpu_torch.parallel import dist as port_dist

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# exit code of rank 0 when its watch finds another rank failed
RANK_FAILED = 5
WATCH_S = 0.2


class World:
    """This process's place in a cell's world: rank `rank` of `size`, on
    `device` (with a group, the rank's card once joined: cuda:rank), with
    a torch.distributed group once joined where `grouped`, and the job's
    `directory`."""

    def __init__(self, rank: int, size: int, device: str,
                 grouped: bool = False, directory: str = None,
                 timeout: float = port_dist.COLLECTIVE_TIMEOUT_S):
        self.rank, self.size = rank, size
        self.device = torch.device(device)
        self.grouped, self.directory = grouped, directory
        self.timeout = timeout
        self.mesh = None
        self.procs = []
        self._closing = threading.Event()

    @classmethod
    def launch(cls, size: int, device: str, grouped: bool, entry,
               kwargs: dict, timeout: float = None) -> "World":
        """Rank 0's world of `size` ranks on `device`, with a group where
        `grouped` or size > 1: ranks 1..size-1 started to run `entry` (a
        module-level function) with `kwargs` and their World.  Returns at
        once."""
        grouped = grouped or size > 1
        timeout = port_dist.COLLECTIVE_TIMEOUT_S if timeout is None \
            else timeout
        if not grouped:
            return cls(0, 1, device)
        directory = tempfile.mkdtemp(prefix="bench-world-")
        with open(os.path.join(directory, "job.json"), "w") as f:
            json.dump({"entry": entry_name(entry), "kwargs": kwargs,
                       "size": size, "device": device, "timeout": timeout,
                       "parent": os.getpid()}, f)
        world = cls(0, size, device, True, directory, timeout)
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "3")
        try:
            for r in range(1, size):
                world.procs.append(subprocess.Popen(
                    [sys.executable, "-m", f"{__package__}.ranks",
                     directory, str(r)], cwd=ROOT, stdout=2))
        except OSError:
            world.abort()
            raise
        threading.Thread(target=world._watch, daemon=True).start()
        return world

    def _watch(self) -> None:
        """Rank 0: end the run when another rank exits non-zero before the
        world closes (rank 0 may wait in a collective that never ends)."""
        while not self._closing.wait(WATCH_S):
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code and not self._closing.is_set():
                    print(f"rank {r} of {self.size} exited with code "
                          f"{code}: the run ends", file=sys.stderr,
                          flush=True)
                    self._kill()
                    os._exit(RANK_FAILED)

    def join(self) -> None:
        """Make the group (every rank; nothing without one): the program's
        `init_group` on the job's FileStore, NCCL bound to the rank's card
        or gloo on the CPU."""
        if not self.grouped:
            return
        self.mesh = port_dist.init_group(
            self.rank, self.size, os.path.join(self.directory, "store"),
            self.device, self.timeout)
        self.device = self.mesh.device

    def barrier(self) -> None:
        """Wait for every rank (nothing without a group)."""
        if self.grouped:
            port_dist.barrier(self.mesh)

    def slowest(self, seconds: float) -> float:
        """The largest of every rank's `seconds`, on every rank."""
        if not self.grouped:
            return seconds
        t = torch.tensor([seconds], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def gather(self, value) -> list:
        """Every rank's `value` (a host object), in rank order, on every
        rank."""
        if not self.grouped:
            return [value]
        out = [None] * self.size
        dist.all_gather_object(out, value)
        return out

    def close(self) -> None:
        """The end of a sound run, on every rank: the group torn down; on
        rank 0 the other ranks awaited (a rank that exits non-zero, or not
        within the collective timeout, raises) and the job's directory
        removed."""
        if not self.grouped:
            return
        self._closing.set()
        dist.destroy_process_group()
        if self.rank:
            return
        try:
            for r, p in enumerate(self.procs, 1):
                code = p.wait(timeout=self.timeout)
                if code:
                    raise RuntimeError(f"rank {r} exited with code {code}")
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"a rank did not exit within "
                               f"{self.timeout} s") from None
        finally:
            self.abort()

    def abort(self) -> None:
        """Rank 0 after a failure (and at close): every other rank ended
        and awaited, the job's directory removed."""
        self._closing.set()
        self._kill()
        if self.directory and self.rank == 0:
            shutil.rmtree(self.directory, ignore_errors=True)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


def entry_name(fn) -> str:
    """"module:name" of a module-level function, by which another process
    imports it: a module run as a script (python3 -m benchmark.run) is
    __main__ in its own process, and named by its spec."""
    module = fn.__module__
    if module == "__main__":
        module = sys.modules["__main__"].__spec__.name
    return f"{module}:{fn.__qualname__}"


def _die_with_parent(parent: int) -> None:
    """End this process when rank 0 ends (Linux's PR_SET_PDEATHSIG), and
    now where it has already."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(RANK_FAILED)


def main(argv=None) -> int:
    """Rank RANK of the world whose job is in DIRECTORY."""
    directory, rank = (sys.argv[1:] if argv is None else argv)
    rank = int(rank)
    with open(os.path.join(directory, "job.json")) as f:
        job = json.load(f)
    _die_with_parent(job["parent"])
    if job["device"] == "cpu":
        torch.set_num_threads(1)
    world = World(rank, job["size"], job["device"], True, directory,
                  job["timeout"])
    module, name = job["entry"].split(":")
    fn = getattr(importlib.import_module(module), name)
    try:
        fn(world=world, **job["kwargs"])
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        # no teardown of the group: the others may wait in a collective
        os._exit(1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
