"""The plain reference of a truncated SVD A ≈ U·diag(S)·Vt (float64
PyTorch, nothing of the program): how far each triplet is from one of
A's, how orthonormal U and V are, and how far S lies from the spectrum
the input was made with."""
from __future__ import annotations

import torch


def svd_numbers(A, U, S, Vt, s) -> dict:
    """``triplet_residual`` max(‖A·V − U·Σ‖_F, ‖Aᵀ·U − V·Σ‖_F) / ‖A‖_F;
    ``orthogonality`` the larger ‖XᵀX − I‖_F of U and V;
    ``spectrum_error`` max_i |S_i − s_i| / s_0 (inf for another count)."""
    A, U, S, V = A.double(), U.double(), S.double(), Vt.double().T
    norm = float(torch.linalg.matrix_norm(A))
    res = max(float(torch.linalg.matrix_norm(A @ V - U * S)),
              float(torch.linalg.matrix_norm(A.T @ U - V * S))) / norm
    eye = torch.eye(S.numel(), dtype=torch.float64, device=S.device)
    orth = max(float(torch.linalg.matrix_norm(X.T @ X - eye))
               for X in (U, V))
    spec = (float((S - s).abs().max() / s[0]) if S.shape == s.shape
            else float("inf"))
    return dict(triplet_residual=res, orthogonality=orth,
                spectrum_error=spec)
