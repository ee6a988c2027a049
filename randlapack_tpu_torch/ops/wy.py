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

The drivers' ``trailing_precision`` (the JAX package's ``_tp_matmul``
and ``masked_vt_a_mixed``/``a_minus_vz_masked_mixed``) picks the form of
the trailing products, ``trailing_form``:

====================  ==========================  ==========================
mode                  CPU (as XLA's CPU backend)  CUDA f32
====================  ==========================  ==========================
"highest"             fp32/f64 products           K1/K2 as above (3xTF32)
"high"                as "highest" (XLA's CPU     one TF32 product (HIGH's
                      dot ignores the precision)  alias is "tensorfloat32")
"default"             as "highest"                one bf16 product, fp32
                                                  accumulation (DEFAULT's
                                                  alias is "bfloat16")
"bf16_3x_emul", any   ``bf16_3x_matmul``          three bf16 products of the
other string                                      same halves
====================  ==========================  ==========================

On the card in f64, "high" and "default" take the f64 kernels "highest"
takes (XLA computes f64 dots in f64 whatever the precision), and
"bf16_3x_emul" forms its halves from the f64 values, as the JAX function
does, and runs the bf16 form three times on them. A CUDA f32 tensor in a
form other than "highest" launches that form (``masked_vt_a_form``,
``a_minus_vz_masked_form``, counted under ``LAUNCHES["…_tf32"]``,
``["…_bf16"]``, ``["…_bf16x3"]``) or raises; the ``*_reference``
functions of each form are its arithmetic in plain PyTorch, for the
tests.

The three forms of both kernels run the ring kernels of
``csrc/wy_ring.cu``: a pre-pass rounds the small operands once a call
into tiles laid out for the tensor cores (``tf32_tiles``, ``bf16_tiles``;
``tf32_tiles_reference``, ``bf16_tiles_reference`` are their plain
versions), and a producer warpgroup streams them (and K1's A: raw for
the "tf32" form, masked and rounded by the producer for the bf16 forms)
through an mbarrier ring to two consumer warpgroups (``*_order_reference``
follow their order of sums). The earlier forms, the "highest" kernel of
``csrc/wy.cu`` with one TF32, one bf16 or three bf16 products, stay
reachable as the forms "tf32_wy", "bf16_wy" and "bf16x3_wy" of both
kernels under ``LAUNCHES["…_tf32_wy"]`` etc., which no driver path takes.
``FORM_KERNELS`` names the entry points of every form.
"""
from __future__ import annotations

import functools

import torch

from ..errors import require
from .util import require_kernel_operands

# kernel launches since the last reset (a run sets these to 0 and reads
# them back to show which kernels it went through). The first two count
# the launches of K1 and K2 by their wrappers, whatever body ran; the
# ``_simt`` ones count every launch of the f32 SIMT bodies, by their own
# wrappers or as K1/K2's guarded path
LAUNCHES = {"masked_vt_a": 0, "a_minus_vz_masked": 0,
            "masked_vt_a_simt": 0, "a_minus_vz_masked_simt": 0,
            "masked_vt_a_tf32": 0, "masked_vt_a_bf16": 0,
            "masked_vt_a_bf16x3": 0, "a_minus_vz_masked_tf32": 0,
            "a_minus_vz_masked_bf16": 0, "a_minus_vz_masked_bf16x3": 0,
            "masked_vt_a_tf32_wy": 0, "a_minus_vz_masked_tf32_wy": 0,
            "masked_vt_a_bf16_wy": 0, "a_minus_vz_masked_bf16_wy": 0,
            "masked_vt_a_bf16x3_wy": 0, "a_minus_vz_masked_bf16x3_wy": 0,
            "tf32_tiles": 0, "bf16_tiles": 0}

# the trailing-precision forms the drivers take
FORMS = ("tf32", "bf16", "bf16x3")
# form -> the C entry points of its K1 and K2 launches: the ring kernels of
# csrc/wy_ring.cu for the forms the drivers take; for the "_wy" forms (the
# earlier forms, yardsticks no driver takes) the tensor-core kernel of
# csrc/wy.cu in the ``mode`` of ``_FORM_MODES`` (0 is the 3xTF32 form)
FORM_KERNELS = {
    "tf32": ("rl_masked_vt_a_tf32", "rl_a_minus_vz_masked_tf32"),
    "bf16": ("rl_masked_vt_a_bf16", "rl_a_minus_vz_masked_bf16"),
    "bf16x3": ("rl_masked_vt_a_bf16x3", "rl_a_minus_vz_masked_bf16x3"),
    "tf32_wy": ("rl_masked_vt_a_mode", "rl_a_minus_vz_masked_mode"),
    "bf16_wy": ("rl_masked_vt_a_mode", "rl_a_minus_vz_masked_mode"),
    "bf16x3_wy": ("rl_masked_vt_a_mode", "rl_a_minus_vz_masked_mode")}
_FORM_MODES = {"tf32_wy": 1, "bf16_wy": 2, "bf16x3_wy": 3}
# the forms that run the ring kernels, and their sets of rounded tiles a
# (row tile, stage): bf16x3's hi and lo
_RING_SETS = {"tf32": 1, "bf16": 1, "bf16x3": 2}

_KERNEL_DTYPES = (torch.float32, torch.float64)
_MAX_GRID_Y = 65535 * 64        # rows of 64-row tiles the grid can hold
_TILE = 128                     # output tile edge of the tensor-core kernels
                                # (and rows of a rounded tile of the ring
                                # forms, csrc/wy_ring.cu's kTileRows)
_STAGE = 32                     # reduction depth of a stage (csrc/tc.cuh)
_MIN_SPLIT_DEPTH = 512          # least reduction length of one part of K1
# stages of 32 terms the tensor cores accumulate before the running sum is
# folded into the fp32 registers with round-to-nearest adds. The tensor
# cores truncate, which costs about 6e-8 of the sum per 8 terms; folding
# after every stage costs up to 5 % of the time and keeps the error at
# 2-5e-7, within that of cuBLAS's fp32 product from 36 terms to 65536
CHUNK = 1
# The trailing-precision forms restart their accumulator every stage too.
# Measured at the main path's shapes (K1 m 8192, K2 k 1024, NVIDIA H100):
# never restarting would cost the one-product forms under 0.3 % of their
# error against the f64 product (the operands' rounding, 2⁻¹¹ or 2⁻⁸,
# dwarfs the truncation) and save 3-7 % of their time, but move them
# 2.3e-5 of max|W| from their plain versions, where the restarted forms
# stay within fp32 summation (1e-6); three bf16 products would err 6.4x
# more (2.85e-5 against 4.45e-6 for K1)


def masked_vt_a_reference(V, A, mask):
    """Plain version of K1: Vᵀ·(A ⊙ mask)."""
    return V.T @ (A * mask[None, :])


def a_minus_vz_masked_reference(A, V, Z, mask):
    """Plain version of K2: A − (V·Z) ⊙ mask (out of place)."""
    return A - (V @ Z) * mask[None, :]


def _tf32_rna(t):
    """t (float32) rounded to TF32 (10 mantissa bits, the low 13 bits
    zero), to nearest, ties away from zero, as ``cvt.rna.tf32.f32`` rounds
    on the card; NaN stays NaN."""
    require(t.dtype == torch.float32, "TF32 rounding takes float32")
    bits = t.contiguous().view(torch.int32)
    # sign-magnitude: adding half a unit to the bit pattern rounds the
    # magnitude, ties away; a carry into the exponent is the right power
    # of two (or Inf)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(t), t, r)


def _split_tf32(x):
    """x (float32) as hi + lo, both TF32 values: hi is x rounded to
    nearest, ties away from zero, lo the same of x − hi (``_tf32_rna``).
    hi + lo equals x within 2⁻²¹|x|; ±Inf gives lo = NaN, NaN stays
    NaN."""
    require(x.dtype == torch.float32, "the TF32 split takes float32")
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


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


def _bf16_halves(x):
    """x as bf16 hi + lo: hi = x rounded to bf16 (to nearest even; from
    f64 through f32, as XLA and PyTorch both convert), lo the same of
    x − hi, both returned in x's type. ±Inf gives lo = NaN."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def bf16_3x_matmul(X, Y):
    """X·Y as the JAX package's ``bf16_3x_matmul`` (``randlapack_tpu/ops/
    pallas_wy.py:37``) computes it, on any device: bf16 hi and lo halves
    of each operand, hi·hi + (hi·lo + lo·hi) with bf16 inputs and fp32
    accumulation (products of bf16 values are exact in fp32, so an fp32
    product of the halves is that arithmetic up to summation order), cast
    back to the operands' type."""
    xh, xl = (t.float() for t in _bf16_halves(X))
    yh, yl = (t.float() for t in _bf16_halves(Y))
    return (xh @ yh + (xh @ yl + xl @ yh)).to(X.dtype)


def _round_form(x, form):
    """x's values as the one-product form ``form`` feeds them to the
    tensor cores: TF32 by ``cvt.rna``, or bf16 to nearest even."""
    if form == "tf32":
        return _tf32_rna(x)
    return x.to(torch.bfloat16).to(x.dtype)


def _bf16_bits(t):
    """t (float32) rounded to bf16, to nearest even, as int16 bit patterns,
    as the ring kernels' pre-pass rounds: the rounding's carry added to the
    sign-magnitude bit pattern (a carry into the exponent is the right
    power of two or Inf), every NaN written as 0x7FC0 (PyTorch's CPU
    conversion does the same; its CUDA one writes 0x7FFF)."""
    require(t.dtype == torch.float32, "bf16 rounding takes float32")
    b = t.contiguous().view(torch.int32).to(torch.int64)
    r = (b + 0x7FFF + ((b >> 16) & 1)) >> 16
    return torch.where(torch.isnan(t), 0x7FC0, r).to(torch.int16)


def _bf16_value(bits):
    """The float32 value of int16 bf16 bit patterns."""
    return (bits.to(torch.int32) << 16).view(torch.float32)


def masked_vt_a_tf32_reference(V, A, mask):
    """K1's "high" form in plain PyTorch: V and A ⊙ mask rounded to TF32,
    then their fp32 product (TF32 off)."""
    return _round_form(V, "tf32").T @ _round_form(A * mask[None, :], "tf32")


def masked_vt_a_bf16_reference(V, A, mask):
    """K1's "default" form in plain PyTorch: V and A ⊙ mask rounded to
    bf16, then their fp32 product."""
    return _round_form(V, "bf16").T @ _round_form(A * mask[None, :], "bf16")


def masked_vt_a_bf16x3_reference(V, A, mask):
    """K1's "bf16_3x_emul" form in plain PyTorch: ``bf16_3x_matmul`` of
    Vᵀ and A ⊙ mask, as ``masked_vt_a_mixed`` of the JAX package."""
    return bf16_3x_matmul(V.T, A * mask[None, :])


def a_minus_vz_masked_tf32_reference(A, V, Z, mask):
    """K2's "high" form in plain PyTorch (out of place)."""
    return A - (_round_form(V, "tf32") @ _round_form(Z, "tf32")) \
        * mask[None, :]


def a_minus_vz_masked_bf16_reference(A, V, Z, mask):
    """K2's "default" form in plain PyTorch (out of place)."""
    return A - (_round_form(V, "bf16") @ _round_form(Z, "bf16")) \
        * mask[None, :]


def a_minus_vz_masked_bf16x3_reference(A, V, Z, mask):
    """K2's "bf16_3x_emul" form in plain PyTorch (out of place), as
    ``a_minus_vz_masked_mixed`` of the JAX package."""
    return A - bf16_3x_matmul(V, Z) * mask[None, :]


def _tiles_floats(rows, depth):
    """Values of the rounded tiles of a rows × depth operand (one tile set:
    TF32 floats or bf16 values): whole tiles of ``_TILE`` rows by
    ``_STAGE`` of the reduction."""
    return -(-rows // _TILE) * _TILE * (-(-depth // _STAGE) * _STAGE)


def tf32_tiles_reference(X):
    """The TF32 form's pre-pass in plain PyTorch: X (R, K) float32, K the
    reduction, rounded to TF32 (``_tf32_rna``), zero-padded to whole tiles
    of 128 rows × 32 of the reduction, and laid out as the kernels read
    it, flat: tile (i, s) (rows 128i.., reduction 32s..) at (i·S + s)·4096
    (S stages in all), in it the 16-byte row (r % 8) of the core matrix
    (r/8, q/4) (8 rows × 4 of the reduction) at ((r/8)·8 + q/4)·32 +
    (r % 8)·4, q % 4 the last index: K-major, as the tensor cores take
    both operands of a TF32 product."""
    require(X.dim() == 2 and X.dtype == torch.float32,
            "the TF32 tiles take a float32 matrix")
    R, K = X.shape
    Rp, Kp = -(-R // _TILE) * _TILE, -(-K // _STAGE) * _STAGE
    P = X.new_zeros((Rp, Kp))
    P[:R, :K] = _tf32_rna(X)
    # (tile, row group, row, stage, quad, entry) ->
    # (tile, stage, row group, quad, row, entry)
    return (P.view(Rp // _TILE, _TILE // 8, 8, Kp // _STAGE, _STAGE // 4, 4)
            .permute(0, 3, 1, 4, 2, 5).reshape(-1))


def bf16_tiles_reference(X, split=False):
    """The bf16 forms' pre-pass in plain PyTorch: X (R, K) float32, K the
    reduction, rounded to bf16 (``_bf16_bits``), zero-padded to whole
    tiles of 128 rows × 32 of the reduction, and laid out as the ring
    kernel reads it, flat, as bfloat16: tile (i, s) at (i·S + s)·4096·n
    (n tile sets: 1, or with ``split`` 2, the lo halves bf16(x − hi)
    4096 values after the hi values), in it the 16-byte row (r % 8) of the
    core matrix (r/8, q/8) (8 rows × 8 of the reduction) at ((r/8)·4 +
    q/8)·64 + (r % 8)·8, q % 8 the last index: K-major, as
    ``tf32_tiles_reference``."""
    require(X.dim() == 2 and X.dtype == torch.float32,
            "the bf16 tiles take a float32 matrix")
    R, K = X.shape
    Rp, Kp = -(-R // _TILE) * _TILE, -(-K // _STAGE) * _STAGE
    P = X.new_zeros((Rp, Kp))
    P[:R, :K] = X
    sets = [_bf16_bits(P)]
    if split:
        sets.append(_bf16_bits(P - _bf16_value(sets[0])))
    # (tile, row group, row, stage, octet, entry) ->
    # (tile, stage, set, row group, octet, row, entry)
    T = torch.stack([h.view(Rp // _TILE, _TILE // 8, 8, Kp // _STAGE,
                            _STAGE // 8, 8) for h in sets])
    return T.permute(1, 4, 0, 2, 5, 3, 6).reshape(-1).view(torch.bfloat16)


def tf32_tiles(X):
    """``tf32_tiles_reference`` of X (any strides): on a CUDA tensor the
    pre-pass kernel of ``csrc/wy_ring.cu`` on its own (the TF32 form's
    entry points launch it themselves), on the CPU the plain version."""
    require(X.dim() == 2 and X.dtype == torch.float32,
            "the TF32 tiles take a float32 matrix")
    if not _device_route(X):
        return tf32_tiles_reference(X)
    from .. import _build
    out = torch.empty(_tiles_floats(*X.shape), dtype=X.dtype,
                      device=X.device)
    if out.numel():
        _build.call("rl_tf32_tiles", out, X, out, X.shape[0], X.shape[1],
                    X.stride(0), X.stride(1))
        LAUNCHES["tf32_tiles"] += 1
    return out


def bf16_tiles(X, split=False):
    """``bf16_tiles_reference`` of X (any strides): on a CUDA tensor the
    bf16 pre-pass kernel of ``csrc/wy_ring.cu`` on its own (K2's bf16 forms
    launch it themselves), on the CPU the plain version."""
    require(X.dim() == 2 and X.dtype == torch.float32,
            "the bf16 tiles take a float32 matrix")
    if not _device_route(X):
        return bf16_tiles_reference(X, split)
    from .. import _build
    out = torch.empty(_tiles_floats(*X.shape) * (2 if split else 1),
                      dtype=torch.bfloat16, device=X.device)
    if out.numel():
        _build.call("rl_bf16_tiles", X, X, out, X.shape[0], X.shape[1],
                    X.stride(0), X.stride(1), int(split))
        LAUNCHES["bf16_tiles"] += 1
    return out


def _chunk_sums(P, Q, k0, k1, chunk):
    """Σ over [k0, k1) of P[:, q]·Q[q, :] as the ring kernels' consumers
    take it: the fp32 product of each run of ``chunk`` stages of 32 (0:
    the whole range), added in order into an fp32 sum that starts at the
    first run's product. P and Q may be tuples of equal length: a run is
    then the sum of their products in that order (bf16x3's lo·hi, hi·lo,
    hi·hi)."""
    Ps, Qs = (P, Q) if isinstance(P, tuple) else ((P,), (Q,))
    step = _STAGE * chunk if chunk > 0 else max(k1 - k0, 1)
    acc = None
    for c0 in range(k0, k1, step):
        c1 = min(k1, c0 + step)
        run = Ps[0][:, c0:c1] @ Qs[0][c0:c1]
        for p, q in zip(Ps[1:], Qs[1:]):
            run = run + p[:, c0:c1] @ q[c0:c1]
        acc = run if acc is None else acc + run
    return acc if acc is not None else Ps[0].new_zeros(
        (Ps[0].shape[0], Qs[0].shape[1]))


def masked_vt_a_tf32_order_reference(V, A, mask, splits=1, chunk=None):
    """K1's "tf32" kernel in plain PyTorch, in its order of sums: V and
    A ⊙ mask rounded to TF32 once, the reduction over m cut into
    ``splits`` parts of whole 32-row stages (the kernel's ``kper``, the
    count of parts recomputed from it as the entry point does), each part
    summed by ``_chunk_sums`` (``chunk`` default ``CHUNK``), the parts
    added in index order. Only the order inside a run of ``chunk`` stages
    (the tensor cores') is left to ``@``."""
    return _masked_vt_a_order(_tf32_rna(V).T, _tf32_rna(A * mask[None, :]),
                              V.shape[0], splits, chunk)


def _masked_vt_a_order(P, Q, m, splits, chunk):
    """Σ over q < m of P[:, q]·Q[q, :] as K1's ring kernels sum it: the
    reduction cut into ``splits`` parts of whole 32-row stages (the
    kernel's ``kper``, the count of parts recomputed from it as the entry
    point does), each part summed by ``_chunk_sums`` (P, Q may be tuples),
    the parts added in index order."""
    chunk = CHUNK if chunk is None else chunk
    kper = max(1, -(-(-(-m // splits)) // _STAGE)) * _STAGE
    W = None
    for k0 in range(0, max(m, 1), kper):
        p = _chunk_sums(P, Q, k0, min(m, k0 + kper), chunk)
        W = p if W is None else W + p
    return W


def masked_vt_a_bf16_order_reference(V, A, mask, splits=1, chunk=None):
    """K1's "bf16" ring kernel in plain PyTorch, in its order of sums: V
    and A ⊙ mask rounded to bf16 once, the parts and runs as in
    ``masked_vt_a_tf32_order_reference``."""
    return _masked_vt_a_order(_round_form(V, "bf16").T,
                              _round_form(A * mask[None, :], "bf16"),
                              V.shape[0], splits, chunk)


def masked_vt_a_bf16x3_order_reference(V, A, mask, splits=1, chunk=None):
    """K1's "bf16x3" ring kernel in plain PyTorch, in its order of sums:
    the bf16 halves of V and A ⊙ mask formed once; the kernel computes Wᵀ
    with the halves of A as the first operand, so each run of ``chunk``
    stages is Aₗᵀ·Vₕ + Aₕᵀ·Vₗ + Aₕᵀ·Vₕ (lo·hi, hi·lo, hi·hi), written
    here transposed; the parts and runs as in
    ``masked_vt_a_tf32_order_reference``."""
    (Vh, Vl), (Ah, Al) = _bf16_halves(V), _bf16_halves(A * mask[None, :])
    return _masked_vt_a_order((Vh.T, Vl.T, Vh.T), (Al, Ah, Ah), V.shape[0],
                              splits, chunk)


def a_minus_vz_masked_tf32_order_reference(A, V, Z, mask, chunk=None):
    """K2's "tf32" kernel in plain PyTorch (out of place), in its order of
    sums: V and Z rounded to TF32 once, the reduction over k summed by
    ``_chunk_sums``, then A − acc ⊙ mask."""
    chunk = CHUNK if chunk is None else chunk
    acc = _chunk_sums(_tf32_rna(V), _tf32_rna(Z), 0, V.shape[1], chunk)
    return A - acc * mask[None, :]


def a_minus_vz_masked_bf16_order_reference(A, V, Z, mask, chunk=None):
    """K2's "bf16" ring kernel in plain PyTorch (out of place), in its
    order of sums: V and Z rounded to bf16 once, the reduction summed by
    ``_chunk_sums``, then A − acc ⊙ mask."""
    chunk = CHUNK if chunk is None else chunk
    acc = _chunk_sums(_round_form(V, "bf16"), _round_form(Z, "bf16"), 0,
                      V.shape[1], chunk)
    return A - acc * mask[None, :]


def a_minus_vz_masked_bf16x3_order_reference(A, V, Z, mask, chunk=None):
    """K2's "bf16x3" ring kernel in plain PyTorch (out of place), in its
    order of sums: the bf16 halves of V and Z formed once, each run of
    ``chunk`` stages lo·hi + hi·lo + hi·hi (``_chunk_sums``), then
    A − acc ⊙ mask."""
    chunk = CHUNK if chunk is None else chunk
    (Vh, Vl), (Zh, Zl) = _bf16_halves(V), _bf16_halves(Z)
    acc = _chunk_sums((Vl, Vh, Vh), (Zh, Zl, Zh), 0, V.shape[1], chunk)
    return A - acc * mask[None, :]


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
    if not (m and b and w):
        return torch.zeros((b, w), dtype=A.dtype, device=A.device)
    if takes_tensor_cores(V, A):
        W = _tc_masked_vt_a(V, A, mask, 0, chunk)
    else:
        W = torch.empty((b, w), dtype=A.dtype, device=A.device)
        if A.dtype == torch.float32:
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
        _tc_a_minus_vz_masked(A, V, Z, mask, 0, chunk)
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


def _padded(t, cols=None):
    """t itself where the tensor-core kernels take it (16-byte aligned,
    ``cols`` long rows, a multiple of 4), else a zero-padded copy of it
    with rows of ``cols`` (default: t's row length rounded up to 4)."""
    n = t.shape[-1]
    cols = -(-n // 4) * 4 if cols is None else cols
    if n == cols and t.data_ptr() % 16 == 0:
        return t
    out = torch.zeros((*t.shape[:-1], cols), dtype=t.dtype, device=t.device)
    out[..., :n] = t
    return out


def _tc_masked_vt_a(V, A, mask, mode, chunk):
    """K1's tensor-core kernel in the form ``mode`` (0 the 3xTF32 fp32
    form, ``_FORM_MODES`` the others) on f32 operands, copied into
    zero-padded aligned ones where the kernel refuses them; returns W."""
    from .. import _build
    m, b, w = V.shape[0], V.shape[1], A.shape[1]
    Vp, Ap = _padded(V), _padded(A)
    b4, w4 = Vp.shape[1], Ap.shape[1]
    W = torch.empty((b4, w4), dtype=A.dtype, device=A.device)
    splits = masked_vt_a_splits(m, b4, w4, _sm_count(A.device.index))
    part = torch.empty((splits if splits > 1 else 0, b4, w4),
                       dtype=A.dtype, device=A.device)
    _build.call("rl_masked_vt_a_mode", W, Vp, Ap, _padded(mask, w4), W, part,
                m, b4, w4, splits, CHUNK if chunk is None else chunk, mode)
    return W if (b4, w4) == (b, w) else W[:b, :w].contiguous()


def _tc_a_minus_vz_masked(A, V, Z, mask, mode, chunk):
    """K2's tensor-core kernel in the form ``mode`` on f32 operands, in
    place, through zero-padded aligned copies where the kernel refuses
    them (A's copy written back); returns A."""
    from .. import _build
    m, k, w = A.shape[0], V.shape[1], A.shape[1]
    Ap, Vp = _padded(A), _padded(V)
    w4, k4 = Ap.shape[1], Vp.shape[1]
    Zp = _padded(Z, w4)
    if k4 != k:
        Zp = torch.cat([Zp, Zp.new_zeros((k4 - k, w4))])
    _build.call("rl_a_minus_vz_masked_mode", Ap, Ap, Vp, Zp,
                _padded(mask, w4), m, k4, w4,
                CHUNK if chunk is None else chunk, mode)
    if Ap is not A:
        A.copy_(Ap[:, :w])
    return A


def _ring_masked_vt_a(V, A, mask, form, chunk):
    """K1's ring kernel in the form ``form`` ("tf32", "bf16", "bf16x3") on
    f32 operands (the pre-pass rounds Vᵀ into its tiles, scratch allocated
    here, inside the launch), through a zero-padded aligned copy of A and
    the mask where the kernel refuses A; returns W."""
    from .. import _build
    m, b, w = V.shape[0], V.shape[1], A.shape[1]
    Ap = _padded(A)
    w4 = Ap.shape[1]
    W = torch.empty((b, w4), dtype=A.dtype, device=A.device)
    splits = masked_vt_a_splits(m, b, w4, _sm_count(A.device.index))
    part = torch.empty((splits if splits > 1 else 0, b, w4),
                       dtype=A.dtype, device=A.device)
    dt = torch.float32 if form == "tf32" else torch.bfloat16
    vt = torch.empty(_tiles_floats(b, m) * _RING_SETS[form], dtype=dt,
                     device=A.device)
    _build.call(FORM_KERNELS[form][0], W, V, Ap, _padded(mask, w4), W,
                part, vt, m, b, w4, splits, CHUNK if chunk is None else chunk)
    return W if w4 == w else W[:, :w].contiguous()


def _ring_a_minus_vz_masked(A, V, Z, mask, form, chunk):
    """K2's ring kernel in the form ``form`` ("tf32", "bf16", "bf16x3") on
    f32 operands, in place (the pre-pass rounds V and Zᵀ into their tiles,
    scratch allocated here, inside the launch), through zero-padded
    aligned copies of A, Z and the mask where the kernel refuses A (A's
    copy written back); returns A."""
    from .. import _build
    m, k, w = A.shape[0], V.shape[1], A.shape[1]
    Ap = _padded(A)
    w4 = Ap.shape[1]
    Zp = Z if w4 == w else _padded(Z, w4)
    dt = torch.float32 if form == "tf32" else torch.bfloat16
    sets = _RING_SETS[form]
    vr = torch.empty(_tiles_floats(m, k) * sets, dtype=dt, device=A.device)
    zt = torch.empty(_tiles_floats(w4, k) * sets, dtype=dt, device=A.device)
    _build.call(FORM_KERNELS[form][1], Ap, Ap, V, Zp, _padded(mask, w4),
                vr, zt, m, k, w4, CHUNK if chunk is None else chunk)
    if Ap is not A:
        A.copy_(Ap[:, :w])
    return A


def masked_vt_a_form(V, A, mask, form, chunk=None):
    """K1 on the card in the trailing-precision form ``form`` ("tf32",
    "bf16" or "bf16x3"; ``FORMS``; or the yardsticks "tf32_wy", "bf16_wy",
    "bf16x3_wy"), f32 only: W = Vᵀ·(A ⊙ mask) with the mask multiplied
    into A, each product on the tensor cores as the form says
    (``masked_vt_a_<form>_reference`` is its arithmetic; a yardstick's
    that of its form), the accumulator restarted every ``chunk`` stages
    as in ``masked_vt_a``. Operands that the form's kernel refuses are
    copied into zero-padded aligned ones first. The finite/non-finite
    pattern of W is the plain version's."""
    require(form in FORM_KERNELS, f"unknown form {form!r}")
    m, b, w = _check_vt_a(V, A, mask)
    require(A.dtype == torch.float32, f"the {form!r} form takes float32")
    if not (m and b and w):
        return torch.zeros((b, w), dtype=A.dtype, device=A.device)
    if form in _RING_SETS:
        W = _ring_masked_vt_a(V, A, mask, form, chunk)
    else:
        W = _tc_masked_vt_a(V, A, mask, _FORM_MODES[form], chunk)
    LAUNCHES[f"masked_vt_a_{form}"] += 1
    return W


def a_minus_vz_masked_form(A, V, Z, mask, form, chunk=None):
    """K2 on the card in the trailing-precision form ``form`` (as in
    ``masked_vt_a_form``), f32 only, IN PLACE: A ← A − (V·Z) ⊙ mask
    (``a_minus_vz_masked_<form>_reference`` is its arithmetic; ``chunk``
    as in ``masked_vt_a``); returns A. Any k; operands that the form's
    kernel refuses are copied into zero-padded aligned ones first. The
    finite/non-finite pattern of A is the plain version's."""
    m, k, w = _check_a_minus_vz(A, V, Z, mask)
    require(A.dtype == torch.float32, f"the {form!r} form takes float32")
    require(form in FORM_KERNELS, f"unknown form {form!r}")
    if m and w and k:
        if form in _RING_SETS:
            _ring_a_minus_vz_masked(A, V, Z, mask, form, chunk)
        else:
            _tc_a_minus_vz_masked(A, V, Z, mask, _FORM_MODES[form], chunk)
        LAUNCHES[f"a_minus_vz_masked_{form}"] += 1
    return A


def _bf16_parts_f32(x):
    """x's bf16 halves (``_bf16_halves``, formed from x's own values) as
    float32 tensors, which hold them exactly."""
    return tuple(t.float().contiguous() for t in _bf16_halves(x))


def _masked_vt_a_bf16x3_f64(V, A, mask):
    """"bf16_3x_emul" of K1 for f64 on the card: the halves formed from
    the f64 values, then hi·hi + (hi·lo + lo·hi) as three launches of the
    bf16 form (which leaves bf16 values as they are), cast back."""
    Vh, Vl = _bf16_parts_f32(V)
    Ah, Al = _bf16_parts_f32(A * mask[None, :])
    ones = torch.ones(A.shape[1], dtype=torch.float32, device=A.device)

    def f(X, Y):
        return masked_vt_a_form(X, Y, ones, "bf16")

    return (f(Vh, Ah) + (f(Vh, Al) + f(Vl, Ah))).to(A.dtype)


def _a_minus_vz_masked_bf16x3_f64(A, V, Z, mask):
    """"bf16_3x_emul" of K2 for f64 on the card, in place: −hi·hi and
    −(hi·lo + lo·hi) by three launches of the bf16 form on zeroed fp32
    buffers, then A ← A − (their sum) ⊙ mask in f64."""
    Vh, Vl = _bf16_parts_f32(V)
    Zh, Zl = _bf16_parts_f32(Z)
    m, w = A.shape
    ones = torch.ones(w, dtype=torch.float32, device=A.device)
    hh = a_minus_vz_masked_form(
        torch.zeros((m, w), dtype=torch.float32, device=A.device), Vh, Zh,
        ones, "bf16")
    cross = a_minus_vz_masked_form(
        torch.zeros((m, w), dtype=torch.float32, device=A.device), Vh, Zl,
        ones, "bf16")
    a_minus_vz_masked_form(cross, Vl, Zh, ones, "bf16")
    return A.sub_((-(hh + cross)).to(A.dtype) * mask[None, :])


def _device_route(t):
    if t.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no kernel for device {t.device}")
    if t.device.type == "cuda":
        require_kernel_operands("K1/K2", t)
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


def trailing_form(trailing_precision, t):
    """The form a trailing product at ``trailing_precision`` takes for the
    tensor ``t`` (the module's table): "highest" (the routed K1/K2 and
    plain products), "tf32", "bf16" or "bf16x3"."""
    if trailing_precision == "highest":
        return "highest"
    if trailing_precision in ("high", "default"):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            return "highest"
        return "tf32" if trailing_precision == "high" else "bf16"
    return "bf16x3"


def masked_vt_a_mixed(V, A, mask, trailing_precision="highest"):
    """W = Vᵀ·(A ⊙ mask) at the trailing precision (``trailing_form``): on
    a CUDA tensor the K1 form, on the CPU the plain product or, for
    "bf16_3x_emul", ``bf16_3x_matmul``."""
    form = trailing_form(trailing_precision, A)
    if form == "highest":
        return masked_vt_a_routed(V, A, mask)
    if not _device_route(A):
        return masked_vt_a_bf16x3_reference(V, A, mask)
    if A.dtype == torch.float64:
        return _masked_vt_a_bf16x3_f64(V, A, mask)
    return masked_vt_a_form(V.contiguous(), A.contiguous(),
                            mask.contiguous(), form)


def a_minus_vz_masked_mixed(A, V, Z, mask, trailing_precision="highest"):
    """A ← A − (V·Z) ⊙ mask IN PLACE (the caller must own A) at the
    trailing precision (``trailing_form``): on a CUDA tensor the K2 form,
    on the CPU the plain update or, for "bf16_3x_emul",
    ``bf16_3x_matmul``'s."""
    form = trailing_form(trailing_precision, A)
    if form == "highest":
        return a_minus_vz_masked_routed(A, V, Z, mask)
    if not _device_route(A):
        return A.copy_(a_minus_vz_masked_bf16x3_reference(A, V, Z, mask))
    require(A.is_contiguous(), "A must be contiguous for the in-place "
            "update")
    if A.dtype == torch.float64:
        return _a_minus_vz_masked_bf16x3_f64(A, V, Z, mask)
    return a_minus_vz_masked_form(A, V.contiguous(), Z.contiguous(),
                                  mask.contiguous(), form)
