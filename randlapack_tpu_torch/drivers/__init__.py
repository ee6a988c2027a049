"""User-facing drivers (reference: RandLAPACK/drivers/)."""
from .rsvd import RSVDConfig, rsvd, rsvd_fixed_rank
from .cqrrt import CQRRTConfig, SketchKind, cqrrt
from .cqrrpt import CQRRPTConfig, QRCPKind, cqrrpt
from .bqrrp import (BQRRPConfig, BQRRPFactors, QRTall, bqrrp, bqrrp_apply_qt,
                    bqrrp_factored, bqrrp_q)
from .revd2 import REVD2Config, revd2, revd2_fixed_rank
from .krill import KrillConfig, krill_full_rpchol, krill_restricted_rpchol
from .hqrrp import HQRRPConfig, PanelQR, hqrrp, hqrrp_lapack_format
from .abrik import ABRIKConfig, abrik, abrik_factor
from .spls import SPLSConfig, spls
from .cholqr_linops import (CholQRLinopsConfig, CQRRTLinopsConfig,
                            blocked_gram, blocked_gram_precond,
                            cholqr_linops, cqrrt_linops, materialize_q,
                            scholqr3_linops, scholqr3_linops_basic)

__all__ = ["RSVDConfig", "rsvd", "rsvd_fixed_rank",
           "CQRRTConfig", "SketchKind", "cqrrt",
           "CQRRPTConfig", "QRCPKind", "cqrrpt",
           "BQRRPConfig", "BQRRPFactors", "QRTall", "bqrrp",
           "bqrrp_apply_qt", "bqrrp_factored", "bqrrp_q",
           "REVD2Config", "revd2", "revd2_fixed_rank",
           "KrillConfig", "krill_full_rpchol", "krill_restricted_rpchol",
           "HQRRPConfig", "PanelQR", "hqrrp", "hqrrp_lapack_format",
           "ABRIKConfig", "abrik", "abrik_factor",
           "CholQRLinopsConfig", "CQRRTLinopsConfig", "blocked_gram",
           "blocked_gram_precond", "cholqr_linops", "cqrrt_linops",
           "materialize_q", "scholqr3_linops", "scholqr3_linops_basic",
           "SPLSConfig", "spls"]
