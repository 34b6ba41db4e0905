"""Batched upper-triangular inverse: the hand-written CUDA kernel K1 and its
plain PyTorch version.

The kernel (``csrc/tri_inv.cu``) replaces the TPU kernel
``aprilsam_tpu/kernels/pallas_tri.py:tri_inv_pallas``; its source note
states the bound and the design.  It is compiled with ``nvcc`` for
``sm_90a`` into ``aprilsam_tpu_torch/build/`` on first use and bound with
ctypes (plain C entry points, pointers and the stream as ``c_void_p``).

``tri_inv`` takes the kernel for a CUDA tensor, and the plain version only
for a tensor that lies on the CPU.  There is no fallback: on a CUDA tensor
it launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from ..utils.build import build_shared_library

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "tri_inv.cu")
REPLACES = "aprilsam_tpu/kernels/pallas_tri.py:96"

launches = 0        # kernel launches since the last reset_launches()

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
    """Compile the kernel if needed; return the library's path."""
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


def tri_inv_plain(T: torch.Tensor) -> torch.Tensor:
    """X[b] = T[b]^-1 by a triangular solve against the identity — the
    function the JAX package's default ``tri_inv`` computes."""
    eye = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)
    return torch.linalg.solve_triangular(T, eye.expand(T.shape), upper=True)


def tri_inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of every upper-triangular T[b] in T [B, N, N] (entries below
    the diagonal are ignored; X is zero there)."""
    global launches
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
    launches += 1
    return X
