"""A matrix of known spectrum, and the spectrum: ``make`` returns the
tuple ``(A, s)``, not a tensor. A = U·diag(s)·Vᵀ (m×n, in the
configuration's type) with U and V the orthonormal factors of Gaussians
drawn from ``matrix_seed``, and s_i = ``ratio``^i for i < ``rank`` (float64).
The run's seed orders A's rows: every seed the same singular values and
right singular vectors, the left ones' rows in another order."""
import torch

from cardbench import inputs


def make(config: dict, seed: int, device):
    gen = config["generator"]
    m, n = config["shape"]
    r = gen["rank"]
    U = torch.linalg.qr(torch.randn(
        (m, r), generator=inputs.generator(gen["matrix_seed"], 1, device),
        dtype=torch.float64, device=device)).Q
    V = torch.linalg.qr(torch.randn(
        (n, r), generator=inputs.generator(gen["matrix_seed"], 2, device),
        dtype=torch.float64, device=device)).Q
    s = gen["ratio"] ** torch.arange(r, dtype=torch.float64, device=device)
    A = ((U * s) @ V.T).to(getattr(torch, config["dtype"]))
    rows = torch.randperm(m, generator=inputs.generator(seed, 5, device),
                          device=device)
    return A.index_select(0, rows), s
