"""Computational routines (counterpart of ``randlapack_tpu/comps``;
reference: RandLAPACK/comps/): orthogonalizers and stabilizers, the row
sketcher, range finder and blocked QB, the symmetric power sketch and
range finder, RPCholesky, the preconditioner data, the preconditioned
CG family and LSQR."""
from .orth import Stab, orth, stabilize
from .rs import RSConfig, rs
from .rf import RFConfig, rf
from .qb import QBConfig, qb, qb_blocked
from .syps import SYPSConfig, syps
from .syrf import SYRFConfig, syrf
from .rpchol import RPCholConfig, rp_cholesky
from .determiter import (PCGConfig, PCGSaddleConfig, frobenius_seminorm, pcg,
                         pcg_saddle, psd_sqrt_pinv)
from .lsqr import LSQRConfig, lsqr
from .preconditioners import (make_right_orthogonalizer, nystrom_pc_data,
                              right_precond_saso, rpc_data_svd_saso,
                              rpchol_pc_data)

__all__ = ["Stab", "orth", "stabilize", "RSConfig", "rs", "RFConfig", "rf",
           "QBConfig", "qb", "qb_blocked", "SYPSConfig", "syps",
           "SYRFConfig", "syrf", "RPCholConfig", "rp_cholesky",
           "PCGConfig", "PCGSaddleConfig", "pcg", "pcg_saddle",
           "frobenius_seminorm", "psd_sqrt_pinv",
           "make_right_orthogonalizer", "nystrom_pc_data", "rpchol_pc_data",
           "rpc_data_svd_saso", "right_precond_saso", "LSQRConfig", "lsqr"]
