"""The distributed layer (counterpart of ``randlapack_tpu/parallel/``):
the tall dimension split over the ranks of a ``torch.distributed``
process group, each rank one process holding its rows, with the
collectives written out (``mesh``'s ``psum``/``pmax``/``broadcast``, the
``jax.lax`` ones ``shard_map`` takes).

  * meshes and shards: ``make_mesh``, ``row_sharded``, ``replicated``,
    ``set_mesh`` (what a config's ``shard_axis`` names), and
    ``run_ranks``, which starts the ranks
  * distributed tall-skinny orthogonalization (``dist_cholqr``,
    ``dist_shifted_cholqr3``): local Gram + one psum + replicated
    Cholesky + local triangular solve; ``dist_gram``, ``dist_sketch_left``
    and the rangefinder step ``dist_rangefinder_step``
  * the distributed drivers ``dist_cqrrpt``, ``dist_cqrrt``,
    ``dist_rsvd``, ``dist_revd2``, ``dist_spls``, ``dist_krill`` over
    ``DistSquaredExpKernelLinOp``, and the row-sharded modes of four
    single-device drivers: ``dist_bqrrp_factored`` (K1–K3 on the card),
    ``dist_bqrrp`` (the explicit form; K2's forms in a trailing mode),
    ``dist_hqrrp`` (K5/K6, or K3 with CholQR panels) and ``dist_abrik``
    (CQRRT on the shards)
"""
from .mesh import Mesh, make_mesh, replicated, row_sharded, set_mesh
from .launch import run_ranks
from .tsqr import dist_cholqr, dist_gram, dist_shifted_cholqr3
from .distributed import dist_rangefinder_step, dist_sketch_left
from .dist_drivers import (DistSquaredExpKernelLinOp, dist_abrik,
                           dist_bqrrp, dist_bqrrp_factored, dist_cqrrpt,
                           dist_cqrrt, dist_hqrrp, dist_krill, dist_revd2,
                           dist_rsvd, dist_spls)

__all__ = ["Mesh", "make_mesh", "row_sharded", "replicated", "set_mesh",
           "run_ranks",
           "dist_cholqr", "dist_gram", "dist_shifted_cholqr3",
           "dist_sketch_left", "dist_rangefinder_step",
           "dist_bqrrp", "dist_bqrrp_factored", "dist_hqrrp", "dist_abrik",
           "dist_cqrrpt", "dist_cqrrt", "dist_rsvd",
           "dist_revd2", "dist_spls", "dist_krill",
           "DistSquaredExpKernelLinOp"]
