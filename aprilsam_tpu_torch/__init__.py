"""aprilsam_tpu_torch — the AprilSAM engine on PyTorch and CUDA.

The port of ``aprilsam_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It imports neither JAX nor the JAX package: the host layer (graph, IO,
symbolic planning, the native C runtime) is its own copy, the device layer
is PyTorch, and the TPU's Pallas kernel is a hand-written CUDA kernel
(csrc/tri_inv.cu), as is the frontal QR update of the per-step path
(csrc/frontal_qr.cu).  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from .graph import Attributes, FactorGraph, FACTOR_XYT, FACTOR_XYTPOS
from .geometry import mod2pi, xyt_inv, xyt_inv_mul, xyt_mul
from .io import load_g2o_text, load_graph_file, save_graph_file
from .solver import BatchSolver, IncrementalSolver, SolverConfig

__version__ = "0.1.0"

__all__ = [
    "Attributes",
    "FactorGraph",
    "FACTOR_XYT",
    "FACTOR_XYTPOS",
    "mod2pi",
    "xyt_mul",
    "xyt_inv",
    "xyt_inv_mul",
    "load_g2o_text",
    "load_graph_file",
    "save_graph_file",
    "BatchSolver",
    "IncrementalSolver",
    "SolverConfig",
]
