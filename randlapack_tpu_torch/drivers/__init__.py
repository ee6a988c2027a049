"""User-facing drivers (reference: RandLAPACK/drivers/)."""
from .bqrrp import (BQRRPConfig, BQRRPFactors, QRTall, bqrrp_apply_qt,
                    bqrrp_factored, bqrrp_q)
from .hqrrp import HQRRPConfig, PanelQR, hqrrp, hqrrp_lapack_format

__all__ = ["BQRRPConfig", "BQRRPFactors", "QRTall", "bqrrp_apply_qt",
           "bqrrp_factored", "bqrrp_q", "HQRRPConfig", "PanelQR", "hqrrp",
           "hqrrp_lapack_format"]
