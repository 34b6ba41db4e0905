"""The frontal QR update of an incremental step: the hand-written CUDA kernel
K2 and its plain PyTorch version.

The step refactors the affected rows' triangle under its new measurement
rows, [R; A] = Q [R'; 0], with R's diagonal made positive, and carries the
right-hand side along: y' = Q^T [y; rhs] (aprilsam.c:850-906).  The plain
version is the QR of the stacked matrix (LAPACK on the CPU), the sign flip
and the product Q^T d.  The kernel (``csrc/frontal_qr.cu``) computes the same
function in the form of LAPACK's tpqrt, over the step's live columns and
rows only; its source note states what bounds it and its design.  It
replaces no TPU kernel: the JAX package leaves this QR to XLA.  It is
compiled with ``nvcc`` for ``sm_90a`` into ``aprilsam_tpu_torch/build/`` on
first use and bound with ctypes.

``frontal_qr`` takes the kernel for CUDA tensors, and the plain version only
for tensors that lie on the CPU.  There is no fallback: on a CUDA tensor it
launches the kernel or raises.  The kernel updates R and y in place (the
caller's are temporaries) and returns them.  ``launches`` counts its calls;
``launches_by_shape`` splits them by (3M, p, dtype).  As for K1, a call
inside a CUDA graph capture is recorded in ``capture_record`` and each
replay of the graph adds the record (``count_replay``).  The kernel sets no
function attribute, so its first launch may come anywhere.

``sweep`` restates the kernel's schedule in Python (groups of ``ROWS``
rows, the first touched column, the column sweep with the kernel's
reflector formulas); the tests hold it against the plain version.  Nothing
on the main path calls it.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.build import build_shared_library, nvcc

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "frontal_qr.cu")
REPLACES = None          # the JAX package leaves this QR to XLA

ROWS = 12                # measurement rows a sweep holds (kRows)
MAX_COLUMNS = 8192       # columns and right-hand side: 8 blocks of 1024
KERNEL_NAMES = ("frontal_qr_kernel",)

launches = 0
launches_by_shape: Dict[Tuple[int, int, str], int] = {}
capture_record: Optional[Dict[Tuple[int, int, str], int]] = None

_lock = threading.Lock()
_lib = None


def _command(out: str):
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", out, SRC]


def build() -> str:
    """Compile the kernel if needed; return the library's path (the
    compiler's output is beside it as ``<path>.log``)."""
    return build_shared_library(SRC, "frontal_qr", _command, timeout=600)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name in ("aprilsam_frontal_qr_f64", "aprilsam_frontal_qr_f32"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * 5 + [
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


def frontal_qr_plain(R: torch.Tensor, y: torch.Tensor, A: torch.Tensor,
                     rhs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The QR of [R; A] with a positive diagonal, and Q^T [y; rhs]: dead
    rows of A are zero and change nothing."""
    C = torch.cat([R, A], dim=0)
    d = torch.cat([y, rhs], dim=0)
    Q, Rq = torch.linalg.qr(C, mode="reduced")
    sgn = torch.where(torch.diagonal(Rq) < 0, -1.0, 1.0).to(R.dtype)
    return sgn[:, None] * Rq, sgn * (Q.T @ d)


def frontal_qr(R: torch.Tensor, y: torch.Tensor, A: torch.Tensor,
               rhs: torch.Tensor,
               ctl: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R', y') for R [3M, 3M] upper triangular in slot order (identity on
    dead slots), y [3M], A [6K, 3M] (K xyt factors' rows, then K position
    factors', the live ones first in each) and rhs [6K]; ctl holds the live
    counts [slots, xyt factors, position factors, ...] on R's device.  On
    the card R and y are updated in place and returned."""
    if R.device.type == "cpu":
        return frontal_qr_plain(R, y, A, rhs)
    if R.device.type != "cuda":
        raise ValueError(f"frontal_qr: unsupported device {R.device}")
    if R.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"frontal_qr: dtype {R.dtype} (float32 or float64)")
    for name, t in (("y", y), ("A", A), ("rhs", rhs), ("ctl", ctl)):
        if t.device != R.device:
            raise ValueError(f"frontal_qr: {name} on {t.device}, R on "
                             f"{R.device}")
        if name != "ctl" and t.dtype != R.dtype:
            raise TypeError(f"frontal_qr: {name} is {t.dtype}, R {R.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"frontal_qr: {name} must be contiguous")
    n = R.shape[0] if R.dim() == 2 else -1
    p = A.shape[0] if A.dim() == 2 else -1
    if (R.shape != (n, n) or n % 3 or y.shape != (n,) or A.shape != (p, n)
            or p % 6 or rhs.shape != (p,)):
        raise ValueError(
            f"frontal_qr: shapes R {tuple(R.shape)}, y {tuple(y.shape)}, A "
            f"{tuple(A.shape)}, rhs {tuple(rhs.shape)} are not [3M, 3M], "
            f"[3M], [6K, 3M], [6K]")
    if not R.is_contiguous():
        raise ValueError("frontal_qr: R must be contiguous")
    if ctl.dtype != torch.int64 or ctl.dim() != 1 or ctl.shape[0] < 3:
        raise ValueError("frontal_qr: ctl must be int64 with at least 3 "
                         "counts")
    if n + 1 > MAX_COLUMNS:
        raise ValueError(f"frontal_qr: {n} columns; the kernel takes at most "
                         f"{MAX_COLUMNS - 1}")
    lib = _load()
    fn = (lib.aprilsam_frontal_qr_f64 if R.dtype == torch.float64
          else lib.aprilsam_frontal_qr_f32)
    args = (R.data_ptr(), y.data_ptr(), A.data_ptr(), rhs.data_ptr(),
            ctl.data_ptr(), n, p // 6)
    if R.device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(R.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"frontal_qr kernel launch failed: CUDA error {rc}"
                           f" at R {tuple(R.shape)}, A {tuple(A.shape)}, "
                           f"{R.dtype}")
    key = (n, p, str(R.dtype).replace("torch.", ""))
    if torch.cuda.is_current_stream_capturing():
        if capture_record is None:
            raise RuntimeError("frontal_qr captured outside the graph cache: "
                               "its launches would not be counted")
        capture_record[key] = capture_record.get(key, 0) + 1
    else:
        count_replay({key: 1})
    return R, y


def example(M: int, nodes: int, nx: int, npos: int, K: int = 16,
            seed: int = 0, dtype=torch.float64, device="cpu", first: int = 0,
            zero_rows=(), neg_diag=()):
    """A seeded frontal problem (R, y, A, rhs, ctl) shaped as _frontal_core
    builds it, for the tests and chip_smoke.py: R [3M, 3M] upper triangular
    with a dominant diagonal over `nodes` live slots and the identity on the
    dead ones (y zero there); A [6K, 3M] with nx xyt factors (two 3x3 blocks
    each) and npos position factors (one block), live ones first in each
    half, touching slots from `first` on (the first factor slot `first`
    itself).  Slots in `zero_rows` have a zero row of R (a new node), slots
    in `neg_diag` a negative first diagonal entry."""
    rng = np.random.default_rng(seed)
    n, nl = 3 * M, 3 * nodes
    R = np.zeros((n, n))
    R[:nl, :nl] = np.triu(rng.standard_normal((nl, nl)) * (0.5 / np.sqrt(nl)),
                          1)
    R[np.arange(nl), np.arange(nl)] = 1.0 + rng.random(nl)
    R[np.arange(nl, n), np.arange(nl, n)] = 1.0
    for s in zero_rows:
        R[3 * s:3 * s + 3] = 0.0
    for s in neg_diag:
        R[3 * s, 3 * s] = -R[3 * s, 3 * s]
    A = np.zeros((6 * K, n))

    def block(r0, slot):
        A[r0:r0 + 3, 3 * slot:3 * slot + 3] = rng.standard_normal((3, 3))

    # the first factor touches slot `first`, as a step's lowest touched
    # node is its front's first slot (the front is the touched nodes'
    # ancestors): the sweep starts there
    for f in range(nx):
        pair = ((first, rng.integers(first + 1, nodes)) if f == 0 else
                rng.choice(np.arange(first, nodes), 2, replace=False))
        for s in pair:
            block(3 * f, s)
    for f in range(npos):
        block(3 * K + 3 * f,
              first if f == 0 and nx == 0 else rng.integers(first, nodes))
    y = np.zeros(n)
    y[:nl] = rng.standard_normal(nl)
    rhs = np.zeros(6 * K)
    rhs[:3 * nx] = rng.standard_normal(3 * nx)
    rhs[3 * K:3 * K + 3 * npos] = rng.standard_normal(3 * npos)
    out = [torch.tensor(v, dtype=dtype, device=device) for v in (R, y, A, rhs)]
    ctl = torch.tensor([nodes, nx, npos], dtype=torch.int64, device=device)
    return (*out, ctl)


# --- the kernel's schedule, restated for the tests ---------------------------

def sweep(R: torch.Tensor, y: torch.Tensor, A: torch.Tensor,
          rhs: torch.Tensor, m: int, kx: int,
          kp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R', y') by the kernel's schedule on copies of R and y, with the live
    counts m (slots), kx and kp (factors) as ctl gives them.  The live rows
    are taken ROWS at a time, each group one sweep over the 3m live columns
    and the right-hand side (column 3m of the thread-held rows X).  Before
    each sweep: the first column where the group's rows are nonzero, the
    rows before it negated where their diagonal is negative.  Then, column
    by column, the owner of column k forms reflector k (u = (u0, x), u0 =
    alpha - beta, g = 1 / (beta (beta - alpha))) and, after the barrier,
    every later column applies it: w = u0 R[k, j] + x . X[:, j]."""
    R, y = R.clone(), y.clone()
    n, p = R.shape[0], A.shape[0]
    K = p // 6
    nl = 3 * max(0, min(m, n // 3))
    kx, kp = max(0, min(kx, K)), max(0, min(kp, K))
    if nl == 0:
        return R, y
    rows = list(range(3 * kx)) + list(range(3 * K, 3 * K + 3 * kp))
    for g0 in range(0, max(len(rows), 1), ROWS):
        grp = rows[g0:g0 + ROWS]
        X = torch.zeros(ROWS, nl + 1, dtype=R.dtype)
        if grp:
            X[:len(grp), :nl] = A[grp, :nl]
            X[:len(grp), nl] = rhs[grp]
        nz = torch.nonzero(X[:, :nl].ne(0).any(dim=0)).flatten()
        kf = int(nz[0]) if len(nz) else nl
        neg = torch.diagonal(R)[:kf] < 0
        lead = R[:kf, :nl]                 # left of the diagonal: zeros
        lead[neg] = -lead[neg]
        y[:kf][neg] = -y[:kf][neg]
        for k in range(kf, nl):
            alpha = R[k, k].clone()
            x = X[:, k].clone()
            s = (x * x).sum()
            if s == 0:
                u0, g = 0.0, 0.0
                sg = -1.0 if alpha < 0 else 1.0
                diag = sg * alpha
            else:
                nrm = torch.sqrt(alpha * alpha + s)
                beta = -nrm if alpha >= 0 else nrm
                u0 = alpha - beta
                g = -1.0 / (beta * u0)
                sg = -1.0 if beta < 0 else 1.0
                diag = nrm
            top = torch.cat([R[k, k + 1:nl], y[k:k + 1]])
            gw = g * (u0 * top + x @ X[:, k + 1:])
            out = sg * (top - gw * u0)
            X[:, k + 1:] -= x[:, None] * gw[None, :]
            R[k, k + 1:nl] = out[:-1]
            y[k] = out[-1]
            R[k, k] = diag
    return R, y
