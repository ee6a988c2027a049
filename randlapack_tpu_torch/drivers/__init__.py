"""User-facing drivers (reference: RandLAPACK/drivers/)."""
from .bqrrp import (BQRRPConfig, BQRRPFactors, QRTall, bqrrp, bqrrp_apply_qt,
                    bqrrp_factored, bqrrp_q)
from .cqrrpt import CQRRPTConfig, QRCPKind, cqrrpt
from .cqrrt import CQRRTConfig, SketchKind, cqrrt
from .hqrrp import HQRRPConfig, PanelQR, hqrrp, hqrrp_lapack_format
from .krill import KrillConfig, krill_full_rpchol, krill_restricted_rpchol

__all__ = ["BQRRPConfig", "BQRRPFactors", "QRTall", "bqrrp",
           "bqrrp_apply_qt", "bqrrp_factored", "bqrrp_q", "CQRRPTConfig",
           "QRCPKind", "cqrrpt", "CQRRTConfig", "SketchKind", "cqrrt",
           "HQRRPConfig", "PanelQR", "hqrrp", "hqrrp_lapack_format",
           "KrillConfig", "krill_full_rpchol", "krill_restricted_rpchol"]
