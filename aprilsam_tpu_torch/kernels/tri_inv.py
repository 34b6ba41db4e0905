"""Batched upper-triangular inverse: the hand-written CUDA kernel K1 and its
plain PyTorch version.

The kernel (``csrc/tri_inv.cu``) replaces the TPU kernel
``aprilsam_tpu/kernels/pallas_tri.py:tri_inv_pallas``; its source note
states the bound and the design: 48-wide diagonal tiles inverted by one
launch, the strips above them filled by a second with FP64 tensor-core
products.  It is compiled with ``nvcc`` for ``sm_90a`` into
``aprilsam_tpu_torch/build/`` on first use and bound with ctypes (plain C
entry points, pointers and the stream as ``c_void_p``).

``tri_inv`` takes the kernel for a CUDA tensor, and the plain version only
for a tensor that lies on the CPU.  There is no fallback: on a CUDA tensor
it launches the kernel or raises.  ``launches`` counts calls that launched
the kernel (one call is two CUDA launches); ``launches_by_shape`` splits
that count by (B, N, dtype).  A call made while a CUDA graph is being
captured launches nothing: it is recorded in the capture's record
(``capture_record``), and each replay of that graph adds the record to the
counts (``count_replay``), so a replayed step counts as its eager run does.
The kernel sets its function attributes on its first launch on a device
(``device_info`` in the source), which must not happen inside a capture:
the graph cache runs each signature eagerly before capturing it.

``schedule`` and ``run_schedule`` restate the kernel's tiling, block order
and chunk stream in Python, with torch tile products; the tests hold them
against the JAX package.  Nothing on the main path calls them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..utils.build import build_shared_library

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "tri_inv.cu")
REPLACES = "aprilsam_tpu/kernels/pallas_tri.py:96"

TILE = 48                  # diagonal tile (BLK of pallas_tri.py)


launches = 0        # calls that launched the kernel since reset_launches()
launches_by_shape: Dict[Tuple[int, int, str], int] = {}
# the launches the capture in progress records, by shape (None: no capture)
capture_record: Optional[Dict[Tuple[int, int, str], int]] = None

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin); the tri_inv kernel cannot "
                           "be built")
    return nvcc


def _command(out: str):
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", out, SRC]


def build() -> str:
    """Compile the kernel if needed; return the library's path (the
    compiler's output, with the -Xptxas -v figures, is beside it as
    ``<path>.log``)."""
    return build_shared_library(SRC, "tri_inv", _command, timeout=600)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name in ("aprilsam_tri_inv_f64", "aprilsam_tri_inv_f32"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            _lib = lib
        return _lib


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()


def count_replay(record: Dict[Tuple[int, int, str], int]) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    `record`."""
    global launches
    for key, c in record.items():
        launches += c
        launches_by_shape[key] = launches_by_shape.get(key, 0) + c


def tri_inv_plain(T: torch.Tensor) -> torch.Tensor:
    """X[b] = T[b]^-1 by a triangular solve against the identity — the
    function the JAX package's default ``tri_inv`` computes."""
    eye = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)
    return torch.linalg.solve_triangular(T, eye.expand(T.shape), upper=True)


def tri_inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of every upper-triangular T[b] in T [B, N, N] (entries below
    the diagonal are ignored; X is zero there)."""
    if T.device.type == "cpu":
        return tri_inv_plain(T)
    if T.device.type != "cuda":
        raise ValueError(f"tri_inv: unsupported device {T.device}")
    if T.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"tri_inv: dtype {T.dtype} (float32 or float64)")
    if T.dim() != 3 or T.shape[1] != T.shape[2]:
        raise ValueError(f"tri_inv: shape {tuple(T.shape)} is not [B, N, N]")
    if not T.is_contiguous():
        raise ValueError("tri_inv: T must be contiguous")
    B, N, _ = T.shape
    X = torch.empty_like(T)
    lib = _load()
    fn = (lib.aprilsam_tri_inv_f64 if T.dtype == torch.float64
          else lib.aprilsam_tri_inv_f32)
    if T.device.index == torch.cuda.current_device():
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(T.data_ptr(), X.data_ptr(), B, N, stream)
    else:
        with torch.cuda.device(T.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(T.data_ptr(), X.data_ptr(), B, N, stream)
    if rc != 0:
        raise RuntimeError(f"tri_inv kernel launch failed: CUDA error {rc} "
                           f"at shape {tuple(T.shape)}, {T.dtype}")
    key = (B, N, str(T.dtype).replace("torch.", ""))
    if torch.cuda.is_current_stream_capturing():
        if capture_record is None:
            raise RuntimeError("tri_inv captured outside the graph cache: "
                               "its launches would not be counted")
        capture_record[key] = capture_record.get(key, 0) + 1
    else:
        count_replay({key: 1})
    return X


# --- the kernel's schedule, restated for the tests ---------------------------

def chunk_stream(J: int) -> List[Tuple[int, int]]:
    """The tiles a strip of tile column J streams, in order: for step
    i = J-1 .. 0, T's tiles (i, k) for k = J .. i+1, then (i, i), which
    stands for D_i^-1 read back from X.  (Where the strip's rows stream,
    the strip's rows of X's tile k follow each (i, k).)"""
    out = []
    for i in range(J - 1, -1, -1):
        out += [(i, k) for k in range(J, i, -1)]
        out.append((i, i))
    return out


@dataclass
class Schedule:
    tiles: int                                  # nt = ceil(N / 48)
    diag_blocks: List[Tuple[int, int]]          # (b, I) by blockIdx
    zero_blocks: List[Tuple[int, int, int]]     # (b, I, K), after them
    width: int                                  # strip width W
    strip_blocks: List[Tuple[int, int, int]]    # (b, J, c0) by blockIdx


def schedule(B: int, N: int, width: int) -> Schedule:
    """The grids of the kernel's two launches for T [B, N, N] at strip
    width `width` (48, 16 or 8; the kernel picks it from B, N and the card).
    The first inverts the diagonal tiles, then zeroes the tiles below them;
    strip blocks come longest first (J descending), then by matrix, then by
    strip, and one whose first column c0 is at or past N exits at once."""
    if width not in (48, 16, 8):
        raise ValueError(f"strip width {width} (48, 16 or 8)")
    nt = -(-N // TILE)
    diag = [(b, i) for b in range(B) for i in range(nt)]
    zero = [(b, i, k) for b in range(B) for i in range(1, nt)
            for k in range(i)]
    strips = [(b, J, J * TILE + s * width) for J in range(nt - 1, 0, -1)
              for b in range(B) for s in range(TILE // width)]
    return Schedule(nt, diag, zero, width, strips)


def run_schedule(T: torch.Tensor, sched: Schedule) -> torch.Tensor:
    """X = T^-1 by the kernel's algorithm, block by block, with torch tile
    products: the identity-padded upper triangle, every diagonal tile
    inverted by column back-substitution with reciprocals (diag_kernel),
    then every strip's chunk stream (strip_kernel)."""
    B, N, _ = T.shape
    P = sched.tiles * TILE
    Tp = torch.eye(P, dtype=T.dtype).repeat(B, 1, 1)
    Tp[:, :N, :N] = torch.triu(T)
    X = torch.full((B, P, P), float("nan"), dtype=T.dtype)
    for b, i, k in sched.zero_blocks:
        X[b, i * TILE:(i + 1) * TILE, k * TILE:(k + 1) * TILE] = 0.0
    for b, i in sched.diag_blocks:
        lo, hi = i * TILE, (i + 1) * TILE
        D = Tp[b, lo:hi, lo:hi]
        rd = 1.0 / torch.diagonal(D)
        v = torch.eye(TILE, dtype=T.dtype)
        for r in range(TILE - 1, -1, -1):
            v[r] = v[r] * rd[r]
            v[:r] -= D[:r, r, None] * v[r]
        X[b, lo:hi, lo:hi] = torch.triu(v)
    W = sched.width
    for b, J, c0 in sched.strip_blocks:
        if c0 >= N:
            continue
        cols = slice(c0, c0 + W)
        for i, k in chunk_stream(J):
            rows = slice(i * TILE, (i + 1) * TILE)
            if k == J:
                acc = torch.zeros(TILE, W, dtype=T.dtype)
            if k > i:
                acc += (Tp[b, rows, k * TILE:(k + 1) * TILE]
                        @ X[b, k * TILE:(k + 1) * TILE, cols])
                if k == i + 1:
                    R = -acc
            else:
                X[b, rows, cols] = X[b, rows, rows] @ R
    return X[:, :N, :N].contiguous()
