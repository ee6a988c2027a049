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

In f32 both kernels run on the tensor cores. K4's cross term x_i·x_j is
TF32 ``mma`` products of the split halves of the scaled points, and an
entry costs one ``ex2`` (``kernel_matmat_split_reference`` is that
arithmetic in plain PyTorch); from ``_WIDE_MIN_S`` columns of V on, its
product with V is three TF32 ``wgmma`` products of the split halves of the
entries and of V (``kernel_matmat_wide_reference``); K7's product is three
TF32 ``wgmma`` products per fp32 product with S generated by producer warps
and shared among the blocks of a cluster
(``gaussian_sketch_split_reference``). f64,
f32 points of more than 32 coordinates (K4) and f32 operands that
``wy.takes_tensor_cores`` refuses (K7) take the SIMT kernels of the same
files, which also stay reachable as ``kernel_matmat_simt`` and
``gaussian_sketch_simt``.
"""
from __future__ import annotations

import functools
import math

import torch

from ..errors import require
from ..utils.timing import count
from .wy import (CHUNK, _KERNEL_DTYPES, _device_route, _split_tf32,
                 _three_products, takes_tensor_cores)

# kernel launches since the last reset. The first two count the launches of
# K4 and K7 by their wrappers, whatever body ran; the ``_simt`` ones count
# every launch of the f32 SIMT bodies, by their own wrappers or as K4/K7's
# guarded path; ``kernel_matmat_wide`` the launches of K4's wide body
LAUNCHES = {"kernel_matmat": 0, "gaussian_sketch": 0,
            "kernel_matmat_simt": 0, "gaussian_sketch_simt": 0,
            "kernel_matmat_wide": 0}

# kernel_matmat's tiling (csrc/kernel_matmat.cu): tiles of 128 columns j, V
# in chunks of 1, 4 or 16 columns; 256 rows i a block on the tensor cores
# (at most 32 coordinates), 64 in the SIMT kernel
_TI, _TJ = 256, 128
_SIMT_TI = 64
# below this many blocks the j tiles are split over more of them: about 8
# a multiprocessor, the point where the last wave's idle share stops
# showing (on an H100 at n 65536, s 1: 2.22 ms in 512 blocks, 2.02 in 1024,
# 1.99 in 2048)
_MIN_BLOCKS = 1024
_MAX_TC_D = 32
# the wide body (kernel_matmat_wide_kernel): 128 rows i by 128 columns of V
# a block, j in stages of 32 points; it runs from _WIDE_MIN_S columns of V
# on, the body above below that (the kernel's own kWideMinS)
_WIDE_TI, _WIDE_SC, _WIDE_BK = 128, 128, 32
_WIDE_MIN_S = 17
_LOG2E = 1.4426950408889634
# gaussian_sketch's tiling (csrc/gaussian_sketch.cu): 128x128 tiles of out,
# the 4 blocks of a cluster on neighbouring column tiles
_SKETCH_TILE = 128
_SKETCH_CLUSTER = 4
_SKETCH_MIN_DEPTH = 1024        # least reduction length of one part
_SKETCH_MAX_SPLITS = 8


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


def kernel_matmat_splits(n: int, s: int, rows: int = _TI,
                         min_blocks: int = _MIN_BLOCKS,
                         columns: int | None = None) -> int:
    """Into how many parts the kernel's sum over j is split (each part a
    block of its own, the parts added in index order afterwards) so that
    a small n still fills the card: blocks of ``rows`` rows i by
    ``columns`` columns of V (default: the chunk of 1, 4 or 16 the SIMT
    and the narrow tensor-core bodies take), at least ``min_blocks`` of
    them where the j tiles allow (defaults: the narrow tensor-core
    body's). Depends on the shapes alone."""
    sc = columns or _column_chunk(s)
    blocks = -(-n // rows) * -(-s // sc)
    return max(1, min(-(-n // _TJ), min_blocks // blocks))


def kernel_matmat_plan(d: int, n: int, s: int,
                       dtype=torch.float32) -> tuple[str, int]:
    """Which body of K4 runs at these shapes, and into how many parts it
    splits its sum over j: ``"wide"`` (f32, d ≤ 32, s ≥ ``_WIDE_MIN_S``:
    the product with V on ``wgmma``), ``"narrow"`` (f32, d ≤ 32, fewer
    columns: the product with V on the FMA units) or ``"simt"`` (f64,
    and f32 with d > 32). Depends on the shapes and the type alone."""
    if dtype == torch.float32 and d <= _MAX_TC_D:
        if s >= _WIDE_MIN_S:
            return "wide", kernel_matmat_splits(n, s, _WIDE_TI,
                                                columns=_WIDE_SC)
        return "narrow", kernel_matmat_splits(n, s)
    return "simt", kernel_matmat_splits(n, s, _SIMT_TI)


def kernel_matmat_work(d: int, n: int, s: int, esize: int = 4) -> dict:
    """The work K(X, X)·V asks for at these shapes, whatever computes it:
    per kernel entry 2d flops for the cross term (``product_flops``: a
    matrix product, which may run on the tensor cores), 6 for norms,
    clamp, scale and sign plus 2s for the product with V (``flops``) and
    one exponential (``special``; none in f64, ``esize`` 8, where the
    exponential is a polynomial on the FMA units); X, V and the result
    cross the memory interface once (``nbytes``)."""
    return dict(flops=n * n * (2 * s + 6), product_flops=n * n * 2 * d,
                special=n * n if esize == 4 else 0,
                nbytes=(d * n + 2 * n * s) * esize)


def kernel_matmat_split_reference(X, V, bandwidth, block=None):
    """K4 as the f32 tensor-core kernel computes it, in plain PyTorch:
    with a = log₂e/(2σ²) the points are scaled to x′ = √(2a)·x, rounded to
    fp32 and then to the sum of their TF32 halves, nᵢ′ = −‖xᵢ′‖²/2, the
    cross term x′ᵢ·x′ⱼ is the four products of those halves, small ones
    first (rows of zeros up to a multiple of 8 change nothing; lo·lo is
    kept, unlike in a plain matrix product, because on and near the
    diagonal the exponent is a difference of nearly equal numbers) and
    K_ij = 2^min(x′ᵢ·x′ⱼ + nᵢ′ + nⱼ′, 0). ``block`` as in
    ``kernel_matmat_reference``."""
    require(X.dtype == torch.float32, "the TF32 split takes float32")
    n = X.shape[1]
    bw = float(bandwidth)
    hi, lo = _split_tf32(X * float(math.sqrt(2.0 * _LOG2E / (2.0 * bw * bw))))
    Xs = hi + lo                # exact in fp32: what the products see
    nrm = -0.5 * torch.sum(Xs * Xs, dim=0)
    b = n if block is None else max(1, min(block, n))
    out = torch.zeros_like(V)
    for start in range(0, n, b):
        j = slice(start, min(start + b, n))
        cross = ((lo.T @ lo[:, j] + lo.T @ hi[:, j]) + hi.T @ lo[:, j]) \
            + hi.T @ hi[:, j]
        e = cross + (nrm[:, None] + nrm[None, j])
        out = out + torch.exp2(torch.clamp(e, max=0.0)) @ V[j, :]
    return out


def kernel_matmat_wide_reference(X, V, bandwidth, splits: int = 1,
                                 chunk: int = CHUNK):
    """K4's wide body (s ≥ ``_WIDE_MIN_S``) as the card computes it, in
    plain PyTorch: the entries K_ij as ``kernel_matmat_split_reference``
    forms them, taken in stages of 32 points j; each entry and each row of
    V split into TF32 halves (``wy._split_tf32``), a stage's product the
    three products of the halves, small ones first (lo·V_hi + hi·V_lo +
    hi·V_hi; lo·lo dropped; the halves' products are exact in fp32, so
    ``@`` is the tensor cores' arithmetic up to summation); the products
    of ``chunk`` stages summed (on the card by the tensor cores, 0: all of
    a part's) and then added in fp32 to the running sum; the stages of
    the sum over j (n rounded up to 128) in ``splits`` parts, added in
    index order."""
    require(X.dtype == torch.float32, "the TF32 split takes float32")
    n = X.shape[1]
    bw = float(bandwidth)
    hi, lo = _split_tf32(X * float(math.sqrt(2.0 * _LOG2E / (2.0 * bw * bw))))
    Xs = hi + lo
    nrm = -0.5 * torch.sum(Xs * Xs, dim=0)
    Vh, Vl = _split_tf32(V)
    stages = -(-n // _TJ) * _TJ // _WIDE_BK
    per = -(-stages // splits)
    out = None
    for z in range(splits):
        acc = torch.zeros_like(V)
        run, since = None, 0
        for st in range(z * per, min(stages, (z + 1) * per)):
            j = slice(st * _WIDE_BK, min(n, (st + 1) * _WIDE_BK))
            if j.start < n:
                cross = ((lo.T @ lo[:, j] + lo.T @ hi[:, j])
                         + hi.T @ lo[:, j]) + hi.T @ hi[:, j]
                e = cross + (nrm[:, None] + nrm[None, j])
                Eh, El = _split_tf32(torch.exp2(torch.clamp(e, max=0.0)))
                p = (El @ Vh[j] + Eh @ Vl[j]) + Eh @ Vh[j]
                run = p if since == 0 else run + p
            since += 1          # a stage past n adds zeros on the card
            if since == chunk:
                if run is not None:
                    acc = acc + run
                run, since = None, 0
        if run is not None:
            acc = acc + run
        out = acc if out is None else out + acc
    return out


def _check_kernel_matmat(X, V):
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
    require(-(-s // _column_chunk(s)) <= 65535,
            "s too large for the kernel grid")
    return d, n, s


def _launch_kernel_matmat_simt(name, X, V, bandwidth, d, n, s):
    """The SIMT kernel (``name``: its f32 or f64 entry point)."""
    from .. import _build
    out = torch.empty((n, s), dtype=X.dtype, device=X.device)
    splits = kernel_matmat_splits(n, s, _SIMT_TI)
    norms = torch.empty((n,), dtype=X.dtype, device=X.device)
    part = torch.empty((splits if splits > 1 else 0, n, s),
                       dtype=X.dtype, device=X.device)
    bw = float(bandwidth)
    _build.call(name, out, X, V, norms, part, out, d, n, s,
                1.0 / (2.0 * bw * bw), splits)
    return out


def kernel_matmat(X, V, bandwidth):
    """K4 on the card: K(X, X)·V for the squared-exponential kernel,
    K_ij = exp(−max(‖x_i‖²+‖x_j‖²−2x_iᵀx_j, 0)/(2σ²)), fused (K is never
    stored). X (d, n) one point per column, V (n, s) → (n, s); any n, d ≥ 1
    and s; ``bandwidth`` a Python number or a tensor of one element.

    f32 with d ≤ 32 runs the cross term on the tensor cores (see
    ``kernel_matmat_split_reference``), and from ``_WIDE_MIN_S`` columns
    on the product with V too (``kernel_matmat_wide_reference``; the body
    by ``kernel_matmat_plan``, counted in ``LAUNCHES["kernel_matmat_wide"]``
    and, while a span records, in the counter ``k4.wide_columns``: the
    columns it took of all the f32 tensor-core launches'); f64, and f32
    with more coordinates, run on the SIMT kernel."""
    from .. import _build
    d, n, s = _check_kernel_matmat(X, V)
    if not (n and s):
        return torch.empty((n, s), dtype=X.dtype, device=X.device)
    body, splits = kernel_matmat_plan(d, n, s, X.dtype)
    if body != "simt":
        wide = body == "wide"
        out = torch.empty((n, s), dtype=X.dtype, device=X.device)
        n_pad = -(-n // _TJ) * _TJ
        ks = 1 if d <= 8 else 2 if d <= 16 else 4      # k-steps of 8
        # one piece of scratch: the scaled points' TF32 halves in fragment
        # order (16 ks floats a point; the wide body pads them to its
        # shared-memory stride), their norms, V in column chunks (the wide
        # body: its TF32 hi and lo tiles), then the parts of a split sum
        # over j
        if wide:
            pf = 16 if ks == 1 else 16 * ks + 16
            vfloats = -(-s // _WIDE_SC) * 2 * _WIDE_SC
        else:
            pf = 16 * ks
            vfloats = -(-s // _column_chunk(s)) * _column_chunk(s)
        scratch = torch.empty(
            n_pad * (pf + 1 + vfloats) + (splits * n * s if splits > 1
                                          else 0),
            dtype=X.dtype, device=X.device)
        bw = float(bandwidth)
        _build.call("rl_kernel_matmat", out, X, V, scratch, out, d, n, s,
                    1.0 / (2.0 * bw * bw), splits, CHUNK)
        LAUNCHES["kernel_matmat_wide"] += wide
        count("k4.wide_columns", s if wide else 0, s)
    elif X.dtype == torch.float32:
        out = _launch_kernel_matmat_simt("rl_kernel_matmat_simt", X, V,
                                         bandwidth, d, n, s)
        LAUNCHES["kernel_matmat_simt"] += 1
    else:
        out = _launch_kernel_matmat_simt("rl_kernel_matmat", X, V, bandwidth,
                                         d, n, s)
    LAUNCHES["kernel_matmat"] += 1
    return out


def kernel_matmat_simt(X, V, bandwidth):
    """K4's f32 SIMT kernel (FFMA cross term, ``expf``) on its own: the
    earlier design, kept as a yardstick and as the guarded path. Nothing
    on a driver's path calls it."""
    d, n, s = _check_kernel_matmat(X, V)
    require(X.dtype == torch.float32, "the SIMT yardstick is float32")
    if not (n and s):
        return torch.empty((n, s), dtype=X.dtype, device=X.device)
    out = _launch_kernel_matmat_simt("rl_kernel_matmat_simt", X, V,
                                     bandwidth, d, n, s)
    LAUNCHES["kernel_matmat_simt"] += 1
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
                           device="cuda", col0: int = 0):
    """The (d, m) sketching operator of K7, S ~ N(0, 1/d), entry by entry
    what the kernel generates: Philox4x32-10 on the counter (r // 4, i, 0,
    0) with the key (seed's low word, its high word) gives w0..w3; 23-bit
    uniforms from their low bits, u₁ floored at 1e-7; Box–Muller, both
    branches: S[i, 4q] and S[i, 4q+1] are the cosine and the sine branch
    of (w0, w1), S[i, 4q+2] and S[i, 4q+3] those of (w2, w3); all times
    1/√d. ``col0`` gives columns [col0, col0 + m) of the operator of that
    seed (a row shard's block: the operator does not depend on how its
    columns are split)."""
    q0 = col0 // 4
    quads = -(-(col0 + m) // 4) - q0
    q = torch.arange(q0, q0 + quads, dtype=torch.int64,
                     device=device)[None, :]
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
    return S[:, col0 - 4 * q0:col0 - 4 * q0 + m].contiguous()


def gaussian_sketch_reference(A, d: int, seed: int):
    """Plain version of K7: materializes the same S and multiplies."""
    S = gaussian_sketch_matrix(d, A.shape[0], seed, A.dtype, A.device)
    return S @ A


def gaussian_sketch_split_reference(A, d: int, seed: int):
    """K7 as the f32 tensor-core kernel computes it, in plain PyTorch:
    the same S, and three products of the TF32 halves of S and A."""
    S = gaussian_sketch_matrix(d, A.shape[0], seed, A.dtype, A.device)
    return _three_products(S, A)


def gaussian_sketch_splits(d: int, m: int, n: int, wave: int) -> int:
    """Into how many parts K7's reduction over m is split (every work
    item — a 128×128 tile of the result for each of the 4 blocks of a
    cluster, neighbours along n — in as many items, the parts added in
    index order afterwards) so that the items fill the last wave, a wave
    being the ``wave`` clusters the card holds at once: the least count,
    up to 8 and with parts at least 1024 long, that minimises the waves.
    Depends on the shapes and the card alone."""
    tiles = -(-d // _SKETCH_TILE) * -(-(-(-n // _SKETCH_TILE))
                                      // _SKETCH_CLUSTER)
    best, waves = 1, None
    for z in range(1, max(1, min(_SKETCH_MAX_SPLITS,
                                 m // _SKETCH_MIN_DEPTH)) + 1):
        w = -(-tiles * z // wave) / z
        if waves is None or w < waves - 1e-12:
            best, waves = z, w
    return best


@functools.lru_cache(maxsize=None)
def _sketch_wave(index: int) -> int:
    """Clusters of K7's tensor-core kernel that card ``index`` holds at
    once."""
    from .. import _build
    with torch.cuda.device(index):
        wave = _build.lib()["rl_gaussian_sketch_wave"]()
    if wave <= 0:
        raise RuntimeError(f"rl_gaussian_sketch_wave failed with "
                           f"cudaError {-wave}")
    return wave


def _check_gaussian_sketch(A, d):
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
    return d, m, n


def gaussian_sketch_cuda(A, d: int, seed: int, chunk=None):
    """K7 on the card: S·A with S (d, m) ~ N(0, 1/d) generated inside the
    kernel (see ``gaussian_sketch_matrix``). A (m, n) → (d, n); any m, d
    and n, int seed. Two runs give the same bits.

    f32 runs on the tensor cores as three TF32 products per fp32 product
    (``gaussian_sketch_split_reference``), the running sum folded into
    fp32 registers every ``chunk`` stages of 32 terms (default
    ``wy.CHUNK``; 0: never), with S generated by producer warps beside the
    products and shared among the 4 blocks of a cluster. It is
    fp32-accurate, but an ``Inf`` in A splits into ``Inf`` and ``Inf − Inf
    = NaN``, so where the plain version gives ``±Inf`` this may give
    ``NaN``; the finite/non-finite pattern of the result is the plain
    version's. f64,
    and f32 operands that ``wy.takes_tensor_cores`` refuses (A not 16-byte
    aligned, n not a multiple of 4), run on the SIMT kernel."""
    from .. import _build
    d, m, n = _check_gaussian_sketch(A, d)
    out = torch.empty((d, n), dtype=A.dtype, device=A.device)
    if not (d and n and m):
        return out.zero_()
    key0, key1 = _seed_key(seed)
    scale = float(1.0 / math.sqrt(d))
    if takes_tensor_cores(A, out):
        splits = gaussian_sketch_splits(d, m, n,
                                        _sketch_wave(A.device.index))
        part = torch.empty((splits if splits > 1 else 0, d, n),
                           dtype=A.dtype, device=A.device)
        _build.call("rl_gaussian_sketch", out, A, out, part, d, m, n, key0,
                    key1, scale, splits, CHUNK if chunk is None else chunk)
    elif A.dtype == torch.float32:
        _build.call("rl_gaussian_sketch_simt", out, A, out, d, m, n, key0,
                    key1, scale)
        LAUNCHES["gaussian_sketch_simt"] += 1
    else:
        _build.call("rl_gaussian_sketch", out, A, out, d, m, n, key0, key1,
                    scale)
    LAUNCHES["gaussian_sketch"] += 1
    return out


def gaussian_sketch_simt(A, d: int, seed: int):
    """K7's f32 SIMT kernel (FFMA product, S generated once per 128
    columns by the threads that multiply) on its own: the earlier design,
    kept as a yardstick and as the guarded path. Nothing on a driver's
    path calls it."""
    from .. import _build
    d, m, n = _check_gaussian_sketch(A, d)
    require(A.dtype == torch.float32, "the SIMT yardstick is float32")
    out = torch.empty((d, n), dtype=A.dtype, device=A.device)
    if not (d and n and m):
        return out.zero_()
    key0, key1 = _seed_key(seed)
    _build.call("rl_gaussian_sketch_simt", out, A, out, d, m, n, key0, key1,
                float(1.0 / math.sqrt(d)))
    LAUNCHES["gaussian_sketch_simt"] += 1
    return out


def gaussian_sketch(A, d: int, seed: int):
    """S·A with S (d, m) ~ N(0, 1/d) a function of ``seed``: K7 on CUDA,
    the plain version (the same S, stored) on the CPU."""
    if _device_route(A):
        return gaussian_sketch_cuda(A.contiguous(), d, seed)
    return gaussian_sketch_reference(A, d, seed)
