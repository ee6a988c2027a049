"""Dense kernel toolbox: CholQR family, QR, QRCP and LU pivots,
Householder reconstruction and application, the masked WY update, the
fused kernel product and Gaussian sketch, the economy SVD and matrix
utilities."""
from .cholqr import (cholqr, cholqr2, cholqr_auto, preconditioned_cholqr,
                     shifted_cholqr3)
from .householder import (apply_reflectors, getrfnp, householder_reconstruct,
                          orhr_col)
from .kernels import (gaussian_sketch, gaussian_sketch_reference,
                      kernel_matmat_auto, kernel_matmat_reference,
                      kernel_matmat_routed)
from .lu import getrfnp_routed
from .qr import (geqp3, lu_pivot_columns, qr_econ, qrcp_panel,
                 qrcp_select_pivots, wy_T)
from .qrcp import qrcp_panel_routed, qrcp_select_pivots_routed
from .svd import resolve_svd_method, svd_econ
from .wy import (a_minus_vz_masked_mixed, a_minus_vz_masked_reference,
                 a_minus_vz_masked_routed, masked_vt_a_mixed,
                 masked_vt_a_reference, masked_vt_a_routed,
                 trailing_wy_update)
from . import util

__all__ = [
    "cholqr", "cholqr2", "cholqr_auto", "preconditioned_cholqr",
    "shifted_cholqr3",
    "apply_reflectors", "getrfnp", "getrfnp_routed",
    "householder_reconstruct", "orhr_col",
    "geqp3", "lu_pivot_columns", "qr_econ", "qrcp_panel",
    "qrcp_select_pivots", "wy_T",
    "qrcp_panel_routed", "qrcp_select_pivots_routed",
    "a_minus_vz_masked_mixed", "a_minus_vz_masked_reference",
    "a_minus_vz_masked_routed", "masked_vt_a_mixed",
    "masked_vt_a_reference", "masked_vt_a_routed", "trailing_wy_update",
    "gaussian_sketch", "gaussian_sketch_reference", "kernel_matmat_auto",
    "kernel_matmat_reference", "kernel_matmat_routed",
    "resolve_svd_method", "svd_econ", "util",
]
