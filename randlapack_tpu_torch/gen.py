"""Synthetic test matrices with controlled spectra (counterpart of
``randlapack_tpu/gen.py``; reference: RandLAPACK/testing/rl_gen.hh:
mat_type enum :22-31, mat_gen :713, spectrum functions :106/:216,
adversarial generators :311/:384/:409, sparse generators :538/:614).

Every generator is deterministic in the RNGState and returns
``(A, next_state)``. Each random generator takes ``draws=``: the random
tensors it would draw, in the order it draws them, to use instead (a
test injects the JAX package's draws so the two packages build the same
matrix); an injected draw still advances ``state``. The spectrum
functions and ``kahan_matrix`` are deterministic. Tensors are made on
``device``, the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import torch

from .ops.util import matmul
from .rng import RNGState


class MatType(enum.Enum):
    polynomial = "polynomial"
    exponential = "exponential"
    gaussian = "gaussian"
    step = "step"
    spiked = "spiked"
    adversarial = "adversarial"
    bad_cholqr = "bad_cholqr"
    kahan = "kahan"
    custom_input = "custom_input"   # read from a Matrix Market file
                                    # (rl_gen.hh:438 process_input_mat)


@dataclasses.dataclass(frozen=True)
class MatGenInfo:
    """Port of ``mat_gen_info`` (rl_gen.hh:36)."""

    n_rows: int
    n_cols: int
    mat_type: MatType = MatType.gaussian
    cond_num: float = 1e3        # target 2-norm condition number
    rank: int | None = None      # numerical rank (None = full)
    exponent: float = 2.0        # polynomial decay power
    scaling: float = 1.0
    filename: str | None = None  # .mtx path for MatType.custom_input


def _draw(state: RNGState, draws, i: int, make, device):
    """Draw ``i`` of a generator: ``draws[i]`` on ``device`` when given,
    else ``make(generator)`` from a generator spawned from ``state``.
    Returns ``(tensor, next_state)``; both ways advance the state."""
    if draws is not None:
        return torch.as_tensor(draws[i], device=device), state.advance()
    gen, state = state.spawn(device)
    return make(gen), state


# -- spectrum functions -------------------------------------------------------

def gen_poly_singvals(k: int, cond: float, p: float, dtype,
                      device="cuda") -> torch.Tensor:
    """σ_i ∝ (1+i)^-p, the log-profile renormalized so σ_0/σ_{k-1} =
    cond while keeping the polynomial decay shape (rl_gen.hh:106)."""
    if k == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    i = torch.arange(k, dtype=dtype, device=device)
    raw = (1.0 + i) ** (-p)
    t = torch.log(raw / raw[0]) / torch.log(raw[-1] / raw[0])
    return torch.exp(t * torch.log(torch.tensor(1.0 / cond, dtype=dtype,
                                                device=device)))


def gen_exp_singvals(k: int, cond: float, dtype,
                     device="cuda") -> torch.Tensor:
    """Geometric decay from 1 to 1/cond."""
    if k == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    t = torch.arange(k, dtype=dtype, device=device) / (k - 1)
    return torch.exp(-t * math.log(cond))


def gen_quadratic_singvals(k: int, cond: float, dtype,
                           device="cuda") -> torch.Tensor:
    """σᵢ = 1 + (cond−1)·(i/(k−1))², descending after normalization —
    the reference's quadratic spectrum (rl_test_utils.hh:446 usage,
    ``gen_quadratic_singvals``); κ = cond exactly."""
    if k == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    t = torch.arange(k, dtype=dtype, device=device) / (k - 1)
    s = 1.0 + (cond - 1.0) * t * t
    return s.flip(0) / s[-1]


def gen_step_singvals(k: int, cond: float, dtype, n_steps: int = 4,
                      device="cuda") -> torch.Tensor:
    """Piecewise-constant spectrum (rl_gen.hh:216)."""
    lev = torch.exp(-torch.arange(n_steps, dtype=dtype, device=device)
                    / max(n_steps - 1, 1) * math.log(cond))
    idx = torch.clamp((torch.arange(k, device=device) * n_steps) // k,
                      max=n_steps - 1)
    return lev[idx]


def gen_spiked_singvals(k: int, cond: float, dtype, n_spikes: int = 10,
                        device="cuda") -> torch.Tensor:
    s = torch.full((k,), 1.0 / cond, dtype=dtype, device=device)
    s[:n_spikes] = 1.0
    return s


# -- factor assembly ----------------------------------------------------------

def haar_basis(m: int, k: int, state: RNGState, dtype, device="cuda",
               draws=None):
    """Orthonormal m×k factor from the Householder QR of a Gaussian
    (Haar-ish, rl_gen.hh:63). ``draws``: ``(G,)``, the (m, k) Gaussian."""
    G, state = _draw(state, draws, 0, lambda g: torch.randn(
        (m, k), generator=g, dtype=dtype, device=device), device)
    return torch.linalg.qr(G.to(dtype))[0], state


def gen_singvec(m: int, n: int, singvals: torch.Tensor, state: RNGState,
                draws=None):
    """A = U diag(σ) Vᵀ with Haar-ish U, V on singvals' device.
    ``draws``: ``(G_U, G_V)``, the Gaussians of the two bases."""
    dtype, dev = singvals.dtype, singvals.device
    k = singvals.shape[0]
    U, state = haar_basis(m, k, state, dtype, dev,
                          None if draws is None else draws[:1])
    V, state = haar_basis(n, k, state, dtype, dev,
                          None if draws is None else draws[1:])
    return (U * singvals[None, :]) @ V.T, state


# -- special matrices ---------------------------------------------------------

def kahan_matrix(n: int, dtype, theta: float = 1.2,
                 device="cuda") -> torch.Tensor:
    """Kahan's upper-triangular QR-pivoting stress matrix (rl_gen.hh:409):
    K = diag(s^i) · (I - c·strict_upper), s = sin θ, c = cos θ."""
    s, c = math.sin(theta), math.cos(theta)
    i = torch.arange(n, dtype=dtype, device=device)
    scale = torch.pow(torch.tensor(s, dtype=dtype, device=device), i)
    body = (torch.eye(n, dtype=dtype, device=device)
            - c * torch.triu(torch.ones((n, n), dtype=dtype, device=device),
                             1))
    return scale[:, None] * body


def bad_cholqr_matrix(m: int, n: int, state: RNGState, dtype,
                      cond: float | None = None, device="cuda", draws=None):
    """Tall matrix engineered to break one-pass CholQR (rl_gen.hh:384):
    cond ≈ 1/√eps so the Gram matrix is numerically indefinite.
    ``draws`` as for ``gen_singvec``."""
    eps = torch.finfo(dtype).eps
    cond = cond or (0.5 / math.sqrt(eps))
    s = gen_exp_singvals(min(m, n), cond, dtype, device)
    return gen_singvec(m, n, s, state, draws)


def adversarial_matrix(m: int, n: int, state: RNGState, dtype,
                       n_copies: int = 4, device="cuda", draws=None):
    """High-coherence matrix with (near-)repeated columns — the
    reference's 'oleg adversarial' generator (rl_gen.hh:311) stresses
    pivoting. ``draws``: ``(base, noise)``, the (m, max(n // n_copies,
    1)) and (m, n) Gaussians."""
    w = max(n // n_copies, 1)
    base, state = _draw(state, draws, 0, lambda g: torch.randn(
        (m, w), generator=g, dtype=dtype, device=device), device)
    reps = -(-n // w)
    A = base.repeat(1, reps)[:, :n]
    noise, state = _draw(state, draws, 1, lambda g: torch.randn(
        (m, n), generator=g, dtype=dtype, device=device), device)
    return A + 1e-8 * noise, state


# -- dispatch -----------------------------------------------------------------

def mat_gen(info: MatGenInfo, state: RNGState, dtype=torch.float64,
            device="cuda", draws=None):
    """Generate a matrix per ``info`` (rl_gen.hh:713 dispatch). Returns
    ``(A, next_state)``. ``draws`` goes to the generator the type picks:
    ``(G,)`` the (m, n) Gaussian of ``gaussian``; the pair of
    ``gen_singvec`` for the spectrum types and ``bad_cholqr``; that of
    ``adversarial_matrix``."""
    m, n = info.n_rows, info.n_cols
    k = info.rank or min(m, n)
    t = info.mat_type
    if t == MatType.gaussian:
        G, state = _draw(state, draws, 0, lambda g: torch.randn(
            (m, n), generator=g, dtype=dtype, device=device), device)
        return G * info.scaling, state
    if t == MatType.polynomial:
        s = gen_poly_singvals(k, info.cond_num, info.exponent, dtype, device)
    elif t == MatType.exponential:
        s = gen_exp_singvals(k, info.cond_num, dtype, device)
    elif t == MatType.step:
        s = gen_step_singvals(k, info.cond_num, dtype, device=device)
    elif t == MatType.spiked:
        s = gen_spiked_singvals(k, info.cond_num, dtype, device=device)
    elif t == MatType.kahan:
        return kahan_matrix(min(m, n), dtype, device=device), state
    elif t == MatType.bad_cholqr:
        return bad_cholqr_matrix(m, n, state, dtype, device=device,
                                 draws=draws)
    elif t == MatType.adversarial:
        return adversarial_matrix(m, n, state, dtype, device=device,
                                  draws=draws)
    elif t == MatType.custom_input:
        # rl_gen.hh:438: route a Matrix Market file through mat_gen
        from .errors import require
        from .extras.io import mm_read
        require(info.filename is not None,
                "custom_input requires MatGenInfo.filename")
        A = torch.as_tensor(mm_read(info.filename, dense=True), dtype=dtype,
                            device=device)
        require(tuple(A.shape) == (m, n),
                f"file is {tuple(A.shape)}, MatGenInfo says {(m, n)}")
        return A * info.scaling, state
    else:  # pragma: no cover
        raise ValueError(t)
    return gen_singvec(m, n, s * info.scaling, state, draws)


def fast_decay_matrix(m: int, n: int, state: RNGState,
                      dtype=torch.float32, decay: float = 6.0,
                      precision=None, device="cuda"):
    """Benchmark matrix with an approximately exponential spectrum:
    A = (G₁·diag(e^{-decay·i/k}))·G₂ᵀ/√(mk) with iid Gaussian factors
    drawn on ``device`` (one GEMM at ``precision``, ``ops.util.matmul``;
    None is "highest", as ``config.resolve_precision`` reads it; no
    orthogonal factors)."""
    k = min(m, n)
    gen1, state = state.spawn(device)
    gen2, state = state.spawn(device)
    s = torch.exp(-decay * torch.arange(k, dtype=dtype, device=device) / k)
    G1 = torch.randn((m, k), generator=gen1, dtype=dtype, device=device)
    G2 = torch.randn((n, k), generator=gen2, dtype=dtype, device=device)
    A = matmul(G1 * s[None, :], G2.T, precision) / math.sqrt(float(m) * k)
    return A, state


def gen_sparse_coo(m: int, n: int, nnz: int, state: RNGState,
                   dtype=torch.float64, device="cuda", draws=None):
    """Random sparse COO matrix (rl_gen.hh:538). Returns
    ``((rows, cols, vals), next_state)`` with iid positions and values
    (duplicates possible, as in the reference's generator). ``draws``:
    ``(rows, cols, vals)``."""
    rows, state = _draw(state, draws, 0, lambda g: torch.randint(
        0, m, (nnz,), generator=g, device=device), device)
    cols, state = _draw(state, draws, 1, lambda g: torch.randint(
        0, n, (nnz,), generator=g, device=device), device)
    vals, state = _draw(state, draws, 2, lambda g: torch.randn(
        (nnz,), generator=g, dtype=dtype, device=device), device)
    return (rows, cols, vals), state


def gen_sparse_from_singvals(m: int, n: int, singvals: torch.Tensor,
                             density: float, state: RNGState, draws=None):
    """Tall sparse matrix with (approximately) prescribed spectrum
    (rl_gen.hh:614): the dense spectrum-shaped matrix of ``gen_singvec``
    masked to the target density by f32 uniforms and rescaled. Returns
    ``(A_dense_masked, next_state)``; ``SparseLinOp.from_dense`` makes the
    operator. ``draws``: ``(G_U, G_V, uniforms)``."""
    dev = singvals.device
    A, state = gen_singvec(m, n, singvals, state,
                           None if draws is None else draws[:2])
    u, state = _draw(state, draws, 2, lambda g: torch.rand(
        (m, n), generator=g, dtype=torch.float32, device=dev), dev)
    return A * (u < density).to(A.dtype) / math.sqrt(density), state


def psd_from_eigvals(n: int, eigvals: torch.Tensor, state: RNGState,
                     draws=None):
    """Symmetric PSD matrix with prescribed eigenvalues, on eigvals'
    device. ``draws``: ``(G,)``, the Gaussian of the basis."""
    U, state = haar_basis(n, n, state, eigvals.dtype, eigvals.device, draws)
    A = (U * eigvals[None, :]) @ U.T
    return 0.5 * (A + A.T), state
