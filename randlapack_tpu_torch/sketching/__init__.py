"""Sketching operators (counterpart of ``randlapack_tpu/sketching``). So
far the index-sampling utilities RPCholesky needs."""
from .sampling import sample_indices_iid, weights_to_cdf

__all__ = ["sample_indices_iid", "weights_to_cdf"]
