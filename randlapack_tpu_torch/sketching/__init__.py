"""Sketching operators (counterpart of ``randlapack_tpu/sketching``): the
sparse (SASO) and SRHT sketches and the index-sampling utilities."""
from .sampling import (sample_distinct_uniform, sample_indices_iid,
                       sample_indices_iid_uniform, weights_to_cdf)
from .sparse_ops import (SparseDist, SparseSkOp, fill_sparse,
                         saso_left_apply, saso_right_apply, saso_to_dense)
from .srht import SRHTSkOp, fwht, srht_left_apply, srht_skop

__all__ = [
    "SparseDist", "SparseSkOp", "fill_sparse", "saso_left_apply",
    "saso_right_apply", "saso_to_dense",
    "SRHTSkOp", "fwht", "srht_left_apply", "srht_skop",
    "sample_distinct_uniform", "sample_indices_iid",
    "sample_indices_iid_uniform", "weights_to_cdf",
]
