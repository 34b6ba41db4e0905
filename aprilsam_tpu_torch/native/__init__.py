"""Native (C) host runtime: build-on-first-use + ctypes bindings.

``sam_native.c`` here is a byte-for-byte copy of
``aprilsam_tpu/native/sam_native.c``: the constrained minimum-degree
orderings, the block symbolic factorization, the float64 batch epoch and the
incremental step planner.  The signatures below are those of
``aprilsam_tpu/native/__init__.py``.  The library is built into
``aprilsam_tpu_torch/build/`` with the system C compiler; unlike the JAX
package, the port has no pure-python fallback for it, so a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from ..utils.build import build_shared_library

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "sam_native.c")

_lock = threading.Lock()
_lib = None

_i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_f64 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _command(out: str):
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")
    if cc is None:
        raise RuntimeError("no C compiler (cc, gcc or clang) on PATH")
    return [cc, "-O3", "-march=native", "-fPIC", "-shared", "-std=c99",
            "-D_GNU_SOURCE", SRC, "-o", out, "-lm"]


def build() -> str:
    """Build the library if needed; return its path."""
    return build_shared_library(SRC, "sam_native", _command, timeout=120)


def load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())

        lib.asn_order_md.restype = ctypes.c_int
        lib.asn_order_md.argtypes = [ctypes.c_int32, _i32, _i32, _i32]

        lib.asn_order_heapmd.restype = ctypes.c_int
        lib.asn_order_heapmd.argtypes = [ctypes.c_int32, _i32, _i32, _i32]

        lib.asn_symbolic.restype = ctypes.c_int
        lib.asn_symbolic.argtypes = [
            ctypes.c_int32, _i32, _i32, _i32, ctypes.c_int32,
            _i32, _i32, _i32,
        ]

        lib.asn_batch_solve.restype = ctypes.c_int
        lib.asn_batch_solve.argtypes = [
            ctypes.c_int32, _f64,
            ctypes.c_int32, _i32, _i32, _f64, _f64,
            ctypes.c_int32, _i32, _f64, _f64,
            _i32, ctypes.c_int32, _i32, _i32,
            ctypes.c_double,
            _f64, _f64, _f64, _f64, _f64, _f64,
        ]

        lib.asn_plan_step.restype = ctypes.c_int
        lib.asn_plan_step.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32, _i32, _i32, _i32, _i32,
            _i32, _i32, _i32,
            _i32, ctypes.c_int32,
            _i32, _i32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            _i32, _i32, _i32, _i32, _i32, _i32,
        ]
        _lib = lib
        return _lib


def order_md(n: int, adj_ptr: np.ndarray, adj_idx: np.ndarray,
             style: str = "md") -> np.ndarray:
    """Fill-reducing ordering.  style="md" = exact minimum degree with
    lazy re-evaluation (newest-last); style="heapmd" = the reference's
    bucketed heap scheme (heap_minimum_degree_ordering,
    aprilsam.c:989-1249)."""
    lib = load()
    out = np.zeros(n, dtype=np.int32)
    fn = lib.asn_order_heapmd if style == "heapmd" else lib.asn_order_md
    rc = fn(n, np.ascontiguousarray(adj_ptr, np.int32),
            np.ascontiguousarray(adj_idx, np.int32), out)
    if rc != 0:
        raise RuntimeError("native ordering failed")
    return out


def symbolic(n: int, adj_ptr, adj_idx, order, bcap: int):
    lib = load()
    patterns = np.zeros((n, bcap), dtype=np.int32)
    nnz = np.zeros(n, dtype=np.int32)
    parents = np.zeros(n, dtype=np.int32)
    rc = lib.asn_symbolic(
        n, np.ascontiguousarray(adj_ptr, np.int32),
        np.ascontiguousarray(adj_idx, np.int32),
        np.ascontiguousarray(order, np.int32), bcap,
        patterns.reshape(-1), nnz, parents)
    if rc < 0:
        raise OverflowError("row_block_capacity exceeded")
    return patterns, nnz, parents, rc


def batch_solve(n, states, fa, fb, fz, fW, pn, pz, pW, order, bcap,
                patterns, nnz, tikhonov):
    lib = load()
    blocks = np.zeros((n, bcap, 3, 3), dtype=np.float64)
    y = np.zeros(3 * n, dtype=np.float64)
    x = np.zeros(3 * n, dtype=np.float64)
    new_states = np.zeros((n, 3), dtype=np.float64)
    delta = np.zeros((n, 3), dtype=np.float64)
    chi2 = np.zeros(1, dtype=np.float64)
    rc = lib.asn_batch_solve(
        n, np.ascontiguousarray(states, np.float64).reshape(-1),
        len(fa), np.ascontiguousarray(fa, np.int32),
        np.ascontiguousarray(fb, np.int32),
        np.ascontiguousarray(fz, np.float64).reshape(-1),
        np.ascontiguousarray(fW, np.float64).reshape(-1),
        len(pn), np.ascontiguousarray(pn, np.int32),
        np.ascontiguousarray(pz, np.float64).reshape(-1),
        np.ascontiguousarray(pW, np.float64).reshape(-1),
        np.ascontiguousarray(order, np.int32), bcap,
        np.ascontiguousarray(patterns, np.int32).reshape(-1),
        np.ascontiguousarray(nnz, np.int32),
        float(tikhonov),
        blocks.reshape(-1), y, x, new_states.reshape(-1),
        delta.reshape(-1), chi2)
    return blocks, y, x, new_states, delta, float(chi2[0]), rc == 0


def plan_step_native(nn, ncap, bcap, parents, pat_idx, pat_nnz, mark, token,
                     kid_head, kid_next, kid_prev,
                     touched, ea, eb, maxaff, fr_cap, F_out, fringe_out,
                     m_out, nfr_out, old_idx_out, old_nnz_out) -> int:
    """In-place incremental-step symbolic planning (see asn_plan_step).
    kid_head/next/prev are the maintained child lists of the parent array.
    old_idx_out/old_nnz_out [maxaff(,bcap)] receive the PRE-merge patterns
    of the affected rows.

    Returns the C return code: 0 ok, 1 affected-overflow (no mutation),
    2 bcap overflow, 3 invariant violation."""
    lib = load()
    return lib.asn_plan_step(
        nn, ncap, bcap, parents, pat_idx.reshape(-1), pat_nnz, mark, token,
        kid_head, kid_next, kid_prev,
        touched, len(touched), ea, eb, len(ea),
        maxaff, fr_cap, F_out, m_out, fringe_out, nfr_out,
        old_idx_out.reshape(-1), old_nnz_out)
