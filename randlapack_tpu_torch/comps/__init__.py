"""Computational routines (counterpart of ``randlapack_tpu/comps``;
reference: RandLAPACK/comps/). So far what KRILL runs: RPCholesky, its
preconditioner data and the preconditioned CG family."""
from .determiter import (PCGConfig, PCGSaddleConfig, frobenius_seminorm, pcg,
                         pcg_saddle, psd_sqrt_pinv)
from .preconditioners import make_right_orthogonalizer, rpchol_pc_data
from .rpchol import RPCholConfig, rp_cholesky

__all__ = ["PCGConfig", "PCGSaddleConfig", "frobenius_seminorm", "pcg",
           "pcg_saddle", "psd_sqrt_pinv", "make_right_orthogonalizer",
           "rpchol_pc_data", "RPCholConfig", "rp_cholesky"]
