"""Extras tier (counterpart of ``randlapack_tpu/extras``; reference:
extras/): Matrix Market IO so far."""
from .io import mm_read, mm_write

__all__ = ["mm_read", "mm_write"]
