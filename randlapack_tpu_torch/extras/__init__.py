"""Extras tier (counterpart of ``randlapack_tpu/extras``; reference:
extras/ — file-backed solver operators and their utilities, SURVEY.md
§2.7): Matrix Market IO and the solver operators."""
from .io import mm_read, mm_write
from .solver_linops import CholSolverLinOp, LUSolverLinOp

__all__ = ["mm_read", "mm_write", "CholSolverLinOp", "LUSolverLinOp"]
