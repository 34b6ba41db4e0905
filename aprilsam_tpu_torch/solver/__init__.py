from .config import SolverConfig
from .batch import BatchSolver
from .incremental import IncrementalSolver

__all__ = ["SolverConfig", "BatchSolver", "IncrementalSolver"]
