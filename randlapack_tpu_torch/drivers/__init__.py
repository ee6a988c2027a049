"""User-facing drivers (reference: RandLAPACK/drivers/)."""
from .bqrrp import (BQRRPConfig, BQRRPFactors, QRTall, bqrrp_apply_qt,
                    bqrrp_factored, bqrrp_q)
from .hqrrp import HQRRPConfig, PanelQR, hqrrp, hqrrp_lapack_format
from .krill import KrillConfig, krill_full_rpchol, krill_restricted_rpchol

__all__ = ["BQRRPConfig", "BQRRPFactors", "QRTall", "bqrrp_apply_qt",
           "bqrrp_factored", "bqrrp_q", "HQRRPConfig", "PanelQR", "hqrrp",
           "hqrrp_lapack_format", "KrillConfig", "krill_full_rpchol",
           "krill_restricted_rpchol"]
