"""Sketching substrate (counterpart of ``randlapack_tpu/sketching``; the
RandBLAS-equivalent bottom layer, SURVEY.md §2.9): the dense, sparse
(SASO) and SRHT sketches, sided application, the sparse formats and the
index-sampling utilities."""
from .dense import DenseDist, DenseSkOp, ScalarDist, dense_skop, fill_dense
from .sparse_ops import (SparseDist, SparseSkOp, fill_sparse,
                         saso_left_apply, saso_right_apply, saso_to_dense)
from .srht import SRHTSkOp, fwht, srht_left_apply, srht_skop
from .apply import sketch_left, sketch_right
from .sampling import (sample_distinct_uniform, sample_indices_iid,
                       sample_indices_iid_uniform, weights_to_cdf)
from . import sparse_data
from .sparse_data import sparse_trsm

__all__ = [
    "DenseDist", "DenseSkOp", "ScalarDist", "dense_skop", "fill_dense",
    "SparseDist", "SparseSkOp", "fill_sparse", "saso_left_apply",
    "saso_right_apply", "saso_to_dense",
    "SRHTSkOp", "fwht", "srht_left_apply", "srht_skop",
    "sketch_left", "sketch_right",
    "sample_distinct_uniform", "sample_indices_iid",
    "sample_indices_iid_uniform", "weights_to_cdf", "sparse_data",
    "sparse_trsm",
]
