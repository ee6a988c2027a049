"""The fused squared-exponential kernel product and the fused Gaussian
sketch — replaces ``randlapack_tpu/ops/pallas_kernels.py`` (its two Pallas
kernels become the hand-written CUDA kernels of ``csrc/kernel_matmat.cu``
and ``csrc/gaussian_sketch.cu``).

* ``kernel_matmat`` (kernel K4) — K(X, X)·V for the squared-exponential
  kernel with no tile of K stored anywhere in device memory: KRILL's hot
  operation (``pdkernels.SquaredExpKernelLinOp.matmat``).
* ``gaussian_sketch`` (kernel K7) — S·A with the d×m Gaussian S generated
  inside the kernel, so the sketch operator never exists in device memory.
  S[i, r] is a function of ``(seed, i, r)`` alone (Philox4x32-10, both
  Box–Muller branches; see ``gaussian_sketch_matrix``), so the plain
  version reproduces the kernel's S, which the TPU kernel's reference
  could not.

``kernel_matmat_routed``/``kernel_matmat_auto`` and ``gaussian_sketch``
take the kernel for a CUDA tensor (and raise if it cannot launch) and the
plain PyTorch version for a CPU tensor; nothing falls back from one to
the other.
"""
from __future__ import annotations

import math

import torch

from ..errors import require
from .wy import _KERNEL_DTYPES, _device_route

# kernel launches since the last reset
LAUNCHES = {"kernel_matmat": 0, "gaussian_sketch": 0}

# kernel_matmat's tiling (csrc/kernel_matmat.cu): 64 rows i a block, tiles
# of 128 columns j, V in chunks of 1, 4 or 16 columns
_TI, _TJ = 64, 128
_MIN_BLOCKS = 1024              # below this the j tiles are split over blocks


# --------------------------------------------------------------------------
# fused squared-exp kernel matmat
# --------------------------------------------------------------------------

def _squared_exp_columns(X, XJ, bandwidth):
    """K(X, XJ): norms plus cross term, clamped at 0, as the kernel."""
    ni = torch.sum(X * X, dim=0)
    nj = torch.sum(XJ * XJ, dim=0)
    d2 = ni[:, None] + nj[None, :] - 2.0 * (X.T @ XJ)
    return torch.exp(-torch.clamp(d2, min=0.0) / (2.0 * bandwidth ** 2))


def kernel_matmat_reference(X, V, bandwidth, block=None):
    """Plain version of K4. ``block=None`` builds K(X, X) whole and
    multiplies; an integer evaluates K in blocks of that many columns
    (clipped indices, masked tail), capping memory at O(n·block)."""
    n = X.shape[1]
    if block is None:
        return _squared_exp_columns(X, X, bandwidth) @ V
    b = min(block, n)
    out = torch.zeros_like(V)
    for start in range(0, n, b):
        pos = start + torch.arange(b, device=X.device)
        idx = torch.clamp(pos, 0, n - 1)
        Kb = _squared_exp_columns(X, X[:, idx], bandwidth)
        out = out + (Kb * (pos < n).to(V.dtype)[None, :]) @ V[idx, :]
    return out


def _column_chunk(s: int) -> int:
    return 1 if s == 1 else 4 if s <= 4 else 16


def kernel_matmat_splits(n: int, s: int) -> int:
    """Into how many parts the kernel's sum over j is split (each part a
    block of its own, the parts added in index order afterwards) so that
    a small n still fills the card. Depends on the shapes alone."""
    sc = _column_chunk(s)
    blocks = -(-n // _TI) * -(-s // sc)
    return max(1, min(-(-n // _TJ), _MIN_BLOCKS // blocks))


def kernel_matmat(X, V, bandwidth):
    """K4 on the card: K(X, X)·V for the squared-exponential kernel,
    K_ij = exp(−max(‖x_i‖²+‖x_j‖²−2x_iᵀx_j, 0)/(2σ²)), fused (K is never
    stored). X (d, n) one point per column, V (n, s) → (n, s); any n, d ≥ 1
    and s; ``bandwidth`` a Python number or a tensor of one element."""
    from .. import _build
    require(X.dim() == 2 and V.dim() == 2,
            "kernel_matmat takes X (d,n) and V (n,s)")
    d, n = X.shape
    s = V.shape[1]
    require(V.shape[0] == n, f"shape mismatch: X {tuple(X.shape)}, "
            f"V {tuple(V.shape)}")
    require(d >= 1, "X needs at least one coordinate row")
    require(X.device.type == "cuda", f"kernel operands must be CUDA "
            f"tensors, got {X.device}")
    require(X.dtype in _KERNEL_DTYPES, f"kernel dtype must be "
            f"float32/float64, got {X.dtype}")
    require(V.device == X.device and V.dtype == X.dtype,
            "kernel operands must share one device and dtype")
    require(X.is_contiguous() and V.is_contiguous(),
            "kernel operands must be contiguous")
    require(max(d, n, s) < 2**31, "dimension too large")
    sc = _column_chunk(s)
    require(-(-s // sc) <= 65535, "s too large for the kernel grid")
    out = torch.empty((n, s), dtype=X.dtype, device=X.device)
    if n and s:
        splits = kernel_matmat_splits(n, s)
        norms = torch.empty((n,), dtype=X.dtype, device=X.device)
        part = torch.empty((splits if splits > 1 else 0, n, s),
                           dtype=X.dtype, device=X.device)
        bw = float(bandwidth)
        _build.call("rl_kernel_matmat", out, X, V, norms, part, out, d, n,
                    s, 1.0 / (2.0 * bw * bw), splits)
        LAUNCHES["kernel_matmat"] += 1
    return out


def kernel_matmat_routed(X, V, bandwidth):
    """K(X, X)·V: K4 on CUDA, the plain version on the CPU."""
    if _device_route(X):
        return kernel_matmat(X.contiguous(), V.contiguous(), bandwidth)
    return kernel_matmat_reference(X, V, bandwidth)


kernel_matmat_auto = kernel_matmat_routed


# --------------------------------------------------------------------------
# fused generate+apply Gaussian sketch
# --------------------------------------------------------------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a: int, b):
    """(high, low) 32-bit words of a·b for a 32-bit constant ``a`` and an
    int64 tensor ``b`` of 32-bit values. The 64-bit product does not fit a
    signed int64, so b is split into 16-bit halves."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + (p_lo & _MASK32)) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 (Random123) in integer tensor operations.
    ``counter``: four int64 tensors of 32-bit values (broadcastable),
    ``key``: two Python ints. Returns the four output words as int64
    tensors of 32-bit values."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK32
        k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def _seed_key(seed: int) -> tuple[int, int]:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK32, seed >> 32


def gaussian_sketch_matrix(d: int, m: int, seed: int, dtype=torch.float32,
                           device="cpu"):
    """The (d, m) sketching operator of K7, S ~ N(0, 1/d), entry by entry
    what the kernel generates: Philox4x32-10 on the counter (r // 4, i, 0,
    0) with the key (seed's low word, its high word) gives w0..w3; 23-bit
    uniforms from their low bits, u₁ floored at 1e-7; Box–Muller, both
    branches: S[i, 4q] and S[i, 4q+1] are the cosine and the sine branch
    of (w0, w1), S[i, 4q+2] and S[i, 4q+3] those of (w2, w3); all times
    1/√d."""
    quads = -(-m // 4)
    q = torch.arange(quads, dtype=torch.int64, device=device)[None, :]
    i = torch.arange(d, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w = philox4x32_10((q, i, zero, zero), _seed_key(seed))
    u = [(x & 0x7FFFFF).to(dtype) * (1.0 / 8388608.0) for x in w]
    scale = float(1.0 / math.sqrt(d)) if d else 1.0
    cols = []
    for u1, u2 in ((u[0], u[1]), (u[2], u[3])):
        radius = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-7)))
        angle = 2.0 * math.pi * u2
        cols += [(radius * torch.cos(angle)) * scale,
                 (radius * torch.sin(angle)) * scale]
    S = torch.stack(cols, dim=2).reshape(d, 4 * quads)
    return S[:, :m].contiguous()


def gaussian_sketch_reference(A, d: int, seed: int):
    """Plain version of K7: materializes the same S and multiplies."""
    S = gaussian_sketch_matrix(d, A.shape[0], seed, A.dtype, A.device)
    return S @ A


def gaussian_sketch_cuda(A, d: int, seed: int):
    """K7 on the card: S·A with S (d, m) ~ N(0, 1/d) generated inside the
    kernel (see ``gaussian_sketch_matrix``); one pass over A for each 128
    columns of the result. A (m, n) → (d, n); any m, d and n, int seed.
    Two runs give the same bits."""
    from .. import _build
    require(A.dim() == 2, "gaussian_sketch takes A (m,n)")
    m, n = A.shape
    d = int(d)
    require(d >= 0, "d must be nonnegative")
    require(A.device.type == "cuda", f"kernel operands must be CUDA "
            f"tensors, got {A.device}")
    require(A.dtype in _KERNEL_DTYPES, f"kernel dtype must be "
            f"float32/float64, got {A.dtype}")
    require(A.is_contiguous(), "kernel operands must be contiguous")
    require(max(d, m, n) < 2**31, "dimension too large")
    require(-(-d // 64) <= 65535, "d too large for the kernel grid")
    out = torch.empty((d, n), dtype=A.dtype, device=A.device)
    if d and n and m:
        key0, key1 = _seed_key(seed)
        _build.call("rl_gaussian_sketch", out, A, out, d, m, n, key0, key1,
                    float(1.0 / math.sqrt(d)))
        LAUNCHES["gaussian_sketch"] += 1
    else:
        out.zero_()
    return out


def gaussian_sketch(A, d: int, seed: int):
    """S·A with S (d, m) ~ N(0, 1/d) a function of ``seed``: K7 on CUDA,
    the plain version (the same S, stored) on the CPU."""
    if _device_route(A):
        return gaussian_sketch_cuda(A.contiguous(), d, seed)
    return gaussian_sketch_reference(A, d, seed)
