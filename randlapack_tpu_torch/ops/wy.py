"""Masked WY trailing update of the factored BQRRP driver — replaces
``randlapack_tpu/ops/pallas_wy.py`` (its two Pallas kernels become the
hand-written CUDA kernels of ``csrc/wy.cu``).

The update runs in two passes over the trailing window:

    W = Vᵀ·(A ⊙ live)          masked_vt_a        (kernel K1)
    A ← A − (V·Z) ⊙ live       a_minus_vz_masked  (kernel K2, in place)

with Z = Tᵀ·W between them. The ``*_routed`` functions take the kernel
for a CUDA tensor (and raise if it cannot launch) and the plain PyTorch
version for a CPU tensor; nothing falls back from one to the other.

In f32 the kernels run on the tensor cores: each operand is split into
two TF32 halves and three TF32 products stand for one fp32 product
(``_split_tf32`` and the ``*_split_reference`` functions are that
arithmetic in plain PyTorch, for the tests). f64, and f32 operands that
are not 16-byte aligned with row lengths in multiples of 4, take the
SIMT kernels of the same file.
"""
from __future__ import annotations

import functools

import torch

from ..errors import require

# kernel launches since the last reset (a run sets these to 0 and reads
# them back to show which kernels it went through). The first two count
# the launches of K1 and K2 by their wrappers, whatever body ran; the
# ``_simt`` ones count every launch of the f32 SIMT bodies, by their own
# wrappers or as K1/K2's guarded path
LAUNCHES = {"masked_vt_a": 0, "a_minus_vz_masked": 0,
            "masked_vt_a_simt": 0, "a_minus_vz_masked_simt": 0}

_KERNEL_DTYPES = (torch.float32, torch.float64)
_MAX_GRID_Y = 65535 * 64        # rows of 64-row tiles the grid can hold
_TILE = 128                     # output tile edge of the tensor-core kernels
_MIN_SPLIT_DEPTH = 512          # least reduction length of one part of K1
# stages of 32 terms the tensor cores accumulate before the running sum is
# folded into the fp32 registers with round-to-nearest adds. The tensor
# cores truncate, which costs about 6e-8 of the sum per 8 terms; folding
# after every stage costs up to 5 % of the time and keeps the error at
# 2-5e-7, within that of cuBLAS's fp32 product from 36 terms to 65536
CHUNK = 1


def masked_vt_a_reference(V, A, mask):
    """Plain version of K1: Vᵀ·(A ⊙ mask)."""
    return V.T @ (A * mask[None, :])


def a_minus_vz_masked_reference(A, V, Z, mask):
    """Plain version of K2: A − (V·Z) ⊙ mask (out of place)."""
    return A - (V @ Z) * mask[None, :]


def _split_tf32(x):
    """x (float32) as hi + lo, both TF32 values (10 mantissa bits, the low
    13 bits zero): hi is x rounded to nearest, ties away from zero, lo the
    same of x − hi, as ``cvt.rna.tf32.f32`` rounds on the card. hi + lo
    equals x within 2⁻²¹|x|; ±Inf gives lo = NaN, NaN stays NaN."""
    require(x.dtype == torch.float32, "the TF32 split takes float32")

    def rna(t):
        bits = t.contiguous().view(torch.int32)
        # sign-magnitude: adding half a unit to the bit pattern rounds the
        # magnitude, ties away; a carry into the exponent is the right
        # power of two (or Inf)
        r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isnan(t), t, r)

    hi = rna(x)
    return hi, rna(x - hi)


def _three_products(P, Q):
    """P·Q from the TF32 halves of P and Q: the two small products first,
    then hi·hi; lo·lo is dropped. The halves' products are exact in fp32,
    so ``@`` in fp32 is the tensor cores' arithmetic up to summation."""
    Ph, Pl = _split_tf32(P)
    Qh, Ql = _split_tf32(Q)
    return (Pl @ Qh + Ph @ Ql) + Ph @ Qh


def masked_vt_a_split_reference(V, A, mask):
    """K1 as the f32 tensor-core kernel computes it, in plain PyTorch."""
    return _three_products(V.T, A * mask[None, :])


def a_minus_vz_masked_split_reference(A, V, Z, mask):
    """K2 as the f32 tensor-core kernel computes it, in plain PyTorch
    (out of place)."""
    return A - _three_products(V, Z) * mask[None, :]


def _check_kernel_operands(mats, mask):
    dev, dt = mats[0].device, mats[0].dtype
    require(dev.type == "cuda", f"kernel operands must be CUDA tensors, "
            f"got {dev}")
    require(dt in _KERNEL_DTYPES, f"kernel dtype must be float32/float64, "
            f"got {dt}")
    for t in (*mats, mask):
        require(t.device == dev and t.dtype == dt,
                "kernel operands must share one device and dtype")
        require(t.is_contiguous(), "kernel operands must be contiguous")
        require(all(s < 2**31 for s in t.shape), "dimension too large")


def takes_tensor_cores(*tensors):
    """Whether the f32 tensor-core kernels take these operands: float32,
    every one 16-byte aligned, every matrix's row length a multiple of 4
    (they are read by 16-byte asynchronous copies). Anything else takes
    the SIMT kernels."""
    return all(t.dtype == torch.float32 and t.data_ptr() % 16 == 0
               and (t.dim() < 2 or t.shape[-1] % 4 == 0) for t in tensors)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def masked_vt_a_splits(m: int, b: int, w: int, sms: int) -> int:
    """Into how many parts K1's reduction over m is split (each part a
    block of its own, the parts added in index order afterwards) so that
    an output of few 128×128 tiles still fills a card of ``sms``
    multiprocessors. Depends on the shapes and the card alone."""
    tiles = -(-b // _TILE) * -(-w // _TILE)
    return max(1, min(sms // tiles, m // _MIN_SPLIT_DEPTH))


def _check_vt_a(V, A, mask):
    require(V.dim() == 2 and A.dim() == 2 and mask.dim() == 1,
            "masked_vt_a takes V (m,b), A (m,w), mask (w,)")
    m, b = V.shape
    w = A.shape[1]
    require(A.shape[0] == m and mask.shape[0] == w,
            f"shape mismatch: V {tuple(V.shape)}, A {tuple(A.shape)}, "
            f"mask {tuple(mask.shape)}")
    require(b <= _MAX_GRID_Y, "b too large for the kernel grid")
    _check_kernel_operands((V, A), mask)
    return m, b, w


def _check_a_minus_vz(A, V, Z, mask):
    require(A.dim() == 2 and V.dim() == 2 and Z.dim() == 2
            and mask.dim() == 1,
            "a_minus_vz_masked takes A (m,w), V (m,k), Z (k,w), mask (w,)")
    m, w = A.shape
    k = V.shape[1]
    require(V.shape[0] == m and Z.shape == (k, w) and mask.shape[0] == w,
            f"shape mismatch: A {tuple(A.shape)}, V {tuple(V.shape)}, "
            f"Z {tuple(Z.shape)}, mask {tuple(mask.shape)}")
    require(m <= _MAX_GRID_Y, "m too large for the kernel grid")
    _check_kernel_operands((A, V, Z), mask)
    return m, k, w


def masked_vt_a(V, A, mask, chunk=None):
    """K1 on the card: W = Vᵀ·(A ⊙ mask) with the mask multiplied into
    the A tile as it is loaded. V (m, b), A (m, w), mask (w,) → (b, w).

    f32 runs on the tensor cores as three TF32 products per fp32 product,
    the running sum folded into fp32 registers every ``chunk`` stages of
    32 terms (default ``CHUNK``; 0: never): fp32-accurate, but an ``Inf``
    operand splits into ``Inf`` and ``Inf − Inf = NaN``, so where the
    plain version gives ``±Inf`` this may give ``NaN``. The finite/non-finite
    pattern of W is the plain version's. f64, and f32 operands that
    ``takes_tensor_cores`` refuses, run on the SIMT kernel."""
    from .. import _build
    m, b, w = _check_vt_a(V, A, mask)
    W = torch.empty((b, w), dtype=A.dtype, device=A.device)
    if not (m and b and w):
        return W.zero_()
    if takes_tensor_cores(V, A, W):
        splits = masked_vt_a_splits(m, b, w, _sm_count(A.device.index))
        part = torch.empty((splits if splits > 1 else 0, b, w),
                           dtype=A.dtype, device=A.device)
        _build.call("rl_masked_vt_a", W, V, A, mask, W, part, m, b, w,
                    splits, CHUNK if chunk is None else chunk)
    elif A.dtype == torch.float32:
        _build.call("rl_masked_vt_a_simt", W, V, A, mask, W, m, b, w)
        LAUNCHES["masked_vt_a_simt"] += 1
    else:
        _build.call("rl_masked_vt_a", W, V, A, mask, W, m, b, w)
    LAUNCHES["masked_vt_a"] += 1
    return W


def a_minus_vz_masked(A, V, Z, mask, chunk=None):
    """K2 on the card, IN PLACE: A ← A − (V·Z) ⊙ mask in one read and
    one write of A. A (m, w), V (m, k), Z (k, w), mask (w,); returns A.

    f32 runs on the tensor cores as three TF32 products per fp32 product
    (``chunk`` as in ``masked_vt_a``): fp32-accurate, but an ``Inf`` in V
    or Z gives ``NaN`` where the plain version may give ``±Inf``; the
    finite/non-finite pattern of A is the plain version's. f64, and f32
    operands that ``takes_tensor_cores`` refuses, run on the SIMT
    kernel."""
    from .. import _build
    m, k, w = _check_a_minus_vz(A, V, Z, mask)
    if not (m and w and k):
        return A
    if takes_tensor_cores(A, V, Z, mask):
        _build.call("rl_a_minus_vz_masked", A, A, V, Z, mask, m, k, w,
                    CHUNK if chunk is None else chunk)
    elif A.dtype == torch.float32:
        _build.call("rl_a_minus_vz_masked_simt", A, A, V, Z, mask, m, k, w)
        LAUNCHES["a_minus_vz_masked_simt"] += 1
    else:
        _build.call("rl_a_minus_vz_masked", A, A, V, Z, mask, m, k, w)
    LAUNCHES["a_minus_vz_masked"] += 1
    return A


def masked_vt_a_simt(V, A, mask):
    """K1's f32 SIMT kernel (FFMA, no tensor cores) on its own: the
    earlier design, kept as a yardstick and as the guarded path. Nothing
    on a driver's path calls it."""
    from .. import _build
    m, b, w = _check_vt_a(V, A, mask)
    require(A.dtype == torch.float32, "the SIMT yardstick is float32")
    W = torch.empty((b, w), dtype=A.dtype, device=A.device)
    if not (m and b and w):
        return W.zero_()
    _build.call("rl_masked_vt_a_simt", W, V, A, mask, W, m, b, w)
    LAUNCHES["masked_vt_a_simt"] += 1
    return W


def a_minus_vz_masked_simt(A, V, Z, mask):
    """K2's f32 SIMT kernel on its own, IN PLACE (see
    ``masked_vt_a_simt``)."""
    from .. import _build
    m, k, w = _check_a_minus_vz(A, V, Z, mask)
    require(A.dtype == torch.float32, "the SIMT yardstick is float32")
    if m and w and k:
        _build.call("rl_a_minus_vz_masked_simt", A, A, V, Z, mask, m, k, w)
        LAUNCHES["a_minus_vz_masked_simt"] += 1
    return A


def _device_route(t):
    if t.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no kernel for device {t.device}")
    return t.device.type == "cuda"


def masked_vt_a_routed(V, A, mask):
    """W = Vᵀ·(A ⊙ mask): K1 on CUDA, the plain version on the CPU."""
    if _device_route(A):
        return masked_vt_a(V.contiguous(), A.contiguous(),
                           mask.contiguous())
    return masked_vt_a_reference(V, A, mask)


def a_minus_vz_masked_routed(A, V, Z, mask):
    """A ← A − (V·Z) ⊙ mask IN PLACE (A is overwritten and returned; the
    caller must own it): K2 on CUDA, the plain version on the CPU."""
    if _device_route(A):
        require(A.is_contiguous(), "A must be contiguous for the in-place "
                "update")
        return a_minus_vz_masked(A, V.contiguous(), Z.contiguous(),
                                 mask.contiguous())
    return A.copy_(a_minus_vz_masked_reference(A, V, Z, mask))


def trailing_wy_update(A, V, T, mask):
    """The whole masked trailing update, out of place:
    A − V·(Tᵀ·(Vᵀ·(A ⊙ mask))) ⊙ mask (``randlapack_tpu/ops/pallas_wy.py``
    ``trailing_wy_update``). On CUDA: K1, then Z = Tᵀ·W by cuBLAS, then K2
    on a copy of A, so the caller's A is left as it was; the kernels take
    any shape, so there is no shape gate. On the CPU: the plain versions.
    """
    W = masked_vt_a_routed(V, A, mask)
    Z = T.T @ W
    return a_minus_vz_masked_routed(
        torch.clone(A, memory_format=torch.contiguous_format), V, Z, mask)


def _require_highest(trailing_precision):
    if trailing_precision != "highest":
        raise NotImplementedError(
            f"trailing_precision={trailing_precision!r}: only 'highest' "
            "(true fp32/f64 products) is ported")


def masked_vt_a_mixed(V, A, mask, trailing_precision="highest"):
    """W = Vᵀ·(A ⊙ mask) at the configured trailing precision."""
    _require_highest(trailing_precision)
    return masked_vt_a_routed(V, A, mask)


def a_minus_vz_masked_mixed(A, V, Z, mask, trailing_precision="highest"):
    """A ← A − (V·Z) ⊙ mask (in place) at the configured trailing
    precision."""
    _require_highest(trailing_precision)
    return a_minus_vz_masked_routed(A, V, Z, mask)
