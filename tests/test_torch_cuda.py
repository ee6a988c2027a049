"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test is marked ``cuda`` and skips where
there is no CUDA device.

This file imports neither JAX nor the JAX package (the machine with the
card has no JAX), so it runs there without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: fp32 sums of up to 8192 terms in another order than cuBLAS's
stay within 1e-4 of the largest entry; f64 within 1e-12. The f32 K1/K2
kernels (three TF32 products per fp32 product on the tensor cores) are
also held to fp32 accuracy against the f64 product: a relative Frobenius
error of at most 4x that of ``torch.mm``/``torch.addmm`` in fp32 on the
same operands. The f32 K4 (TF32 ``mma`` cross term, ``ex2``; at wide s
the product with V as three TF32 ``wgmma`` products) and K7
(three TF32 ``wgmma`` products, S made by producer warps) are held the
same way: K7 to 4x ``torch.mm``'s error on the stored S, K4 to 4x its SIMT
kernel's. The QRCP kernels (K5, K6; the step kernels and the earlier
cooperative ones) must give exactly the pivots of the plain version and
of the step schedule's plain model (``ops.qrcp.qrcp_*_schedule``) on
inputs whose column norms are spread out (exp(-3·U) column scaling, as
the JAX kernel test uses) or tie exactly; their factors agree within
1e-4 (f32) / 1e-10 (f64) of the largest entry. K3 (the blocked LU and the
earlier flat one) gives the plain version's signs exactly and F within
1e-4 (f32) / 1e-10 (f64); the blocked one is also held to the model of
its schedule, within 1e-5 / 1e-12. The kernel product (K4) sums n terms of one sign
pattern in its own order: 1e-4 (f32) / 1e-11 (f64) of the largest entry.
The Gaussian sketch (K7) generates S from the same Philox words as its
plain version, but ``logf``/``cosf`` on the card differ from PyTorch's
by an ulp or two: S within 1e-6 absolute (f32) / 1e-14 (f64), S·A within
1e-4 / 1e-11 of the largest entry. The operator slice (no kernel): the
sparse products (cuSPARSE) and the sparse triangular solve within 1e-5
(f32) / 1e-12 or 1e-13 (f64) of the CPU's largest entry, ABRIK in f64 as
its CPU parity test gates it. ``trailing_wy_update`` (K1, a cuBLAS
product, K2 on a copy): one launch of each, A unchanged, within 1e-4
(f32) / 1e-12 (f64) of the plain version's largest entry. The least
squares slice (no kernel): spls in f64 against the CPU with one SASO,
iterations within 1, x within 100·κ·eps (LSQR to its stall stop) or
10·κ²·eps (PCG), κ 1e3; the solver operators' device and host solves
within 1e-12 (f64) / 1e-5 (f32) of the CPU's largest entry. The
trailing-precision forms of K1/K2 (one TF32, one bf16, three bf16
products): within 1e-5 of the largest entry of their plain versions
(the same rounded operands, fp32 sums in another order), at most 2x the
plain version's error against the f64 product, two launches bit-equal,
the plain version's finite/non-finite pattern; "bf16_3x_emul" in f64
(three bf16 launches on halves of the f64 values) within 1e-5 of the
CPU's ``bf16_3x_matmul``; the drivers launch their mode's forms and no
"highest" K1/K2, and hold the residual to the mode's gate
(``_MODE_RES``). The "tf32" form's ring kernels are also held to the
plain version of their order of sums within 1e-5, their pre-pass bit for
bit to the plain one; "high" launches them and not the earlier TF32 form
("tf32_wy"), which stays reachable under its own count. The "bf16" and
"bf16x3" forms of both kernels run the same ring kernel on bf16 tiles and
are held the same way (pre-pass bit for bit, Inf/NaN included; plain
version and order of sums within 1e-5); "default" and "bf16_3x_emul"
launch them and not the earlier forms ("bf16_wy", "bf16x3_wy"), also in
the 8192² BQRRP and HQRRP speed modes. The driver-level ``precision=``
(``ops.util.matmul``): "high" is the f64 product of the operands rounded
to TF32 and "default" that of the operands rounded to bf16, within fp32
summation error; "highest" and f64 are ``@`` bit for bit; no TF32 switch
changes. Autograd through QB and RSVD (no kernel) on the card matches
the CPU's gradient; a kernel path raises for a tensor that requires grad
or is batched."""
import numpy as np
import pytest
import torch

import randlapack_tpu_torch as rt
from randlapack_tpu_torch.drivers import (BQRRPConfig, CQRRPTConfig,
                                          CQRRTConfig, HQRRPConfig, PanelQR,
                                          QRCPKind, SketchKind,
                                          bqrrp, bqrrp_factored, bqrrp_q,
                                          cqrrpt,
                                          cqrrt, hqrrp)
from randlapack_tpu_torch.ops import kernels as tk
from randlapack_tpu_torch.ops import lu as tlu
from randlapack_tpu_torch.ops import qr as tqr
from randlapack_tpu_torch.ops import qrcp as tqrcp
from randlapack_tpu_torch.ops import wy as twy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wy_operands(m, w, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)), rng.standard_normal((m, w)),
            rng.standard_normal((k, w)),
            (rng.random(w) < 0.6).astype(np.float64))


def _orthonormal(k, seed):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.standard_normal((k, k)))[0]


def _relf(x, ref):
    return float(torch.linalg.norm(x.double() - ref)
                 / torch.linalg.norm(ref))


def _f64_gate(lib_err):
    """4x the library's fp32 error against f64, or 4 units of fp32
    roundoff where the library happens to be exact (a sum of one term)."""
    return 4 * max(lib_err, 2.0 ** -24)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,w,k", [(64, 64, 64), (3000, 1900, 200),
                                   (1, 1, 1), (513, 1025, 1024)])
def test_wy_kernels_match_plain(cuda, dtype, m, w, k):
    V, A, Z, mask = (torch.tensor(x, dtype=dtype, device=cuda)
                     for x in _wy_operands(m, w, k, m + w))
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    n0 = dict(twy.LAUNCHES)
    # f32 with row lengths in multiples of 4 runs on the tensor cores,
    # everything else on the SIMT kernels
    simt = int(dtype == torch.float32 and (w % 4 != 0 or k % 4 != 0))
    assert twy.takes_tensor_cores(V, A, Z, mask) \
        == (dtype == torch.float32 and not simt)
    W = twy.masked_vt_a(V, A, mask)
    Wp = twy.masked_vt_a_reference(V, A, mask)
    assert float((W - Wp).abs().max()) <= tol * float(Wp.abs().max())
    assert torch.equal(W, twy.masked_vt_a(V, A, mask))
    Ap = twy.a_minus_vz_masked_reference(A, V, Z, mask)
    A0 = A.clone()
    out = twy.a_minus_vz_masked(A, V, Z, mask)
    torch.cuda.synchronize()
    assert out is A
    assert float((A - Ap).abs().max()) <= tol * float(Ap.abs().max())
    assert torch.equal(A, twy.a_minus_vz_masked(A0.clone(), V, Z, mask))
    assert twy.LAUNCHES["masked_vt_a"] == n0["masked_vt_a"] + 2
    assert twy.LAUNCHES["a_minus_vz_masked"] == n0["a_minus_vz_masked"] + 2
    assert twy.LAUNCHES["masked_vt_a_simt"] \
        == n0["masked_vt_a_simt"] + 2 * simt
    assert twy.LAUNCHES["a_minus_vz_masked_simt"] \
        == n0["a_minus_vz_masked_simt"] + 2 * simt
    if dtype == torch.float32:
        # against the f64 products: within 4x the error of the library's
        # fp32 calls on the same operands, and as close to the plain
        # three-product emulation
        Vd, A0d, Zd, md = (t.double() for t in (V, A0, Z, mask))
        ref1 = Vd.T @ (A0d * md)
        lib1 = _relf(torch.mm(V.T, A0 * mask), ref1)
        assert _relf(W, ref1) <= _f64_gate(lib1)
        assert _relf(W, twy.masked_vt_a_split_reference(
            V, A0, mask).double()) <= _f64_gate(lib1)
        ref2 = A0d - (Vd @ Zd) * md
        lib2 = _relf(torch.addmm(A0, V, Z * mask, alpha=-1.0), ref2)
        assert _relf(A, ref2) <= _f64_gate(lib2)
        assert _relf(A, twy.a_minus_vz_masked_split_reference(
            A0, V, Z, mask).double()) <= _f64_gate(lib2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,w", [(8192, 256, 4096), (65536, 256, 2048),
                                   (8192, 256, 256), (1000, 132, 260)])
def test_masked_vt_a_holds_fp32_accuracy_over_long_reductions(cuda, m, b, w):
    """The tensor cores' truncating accumulation must not show: against
    f64, within 4x the error of torch.mm in fp32, with the reduction split
    over blocks or not; an unchunked accumulation (chunk 0) is far worse."""
    g = torch.Generator(device=cuda).manual_seed(m + w)
    V = torch.randn((m, b), generator=g, device=cuda)
    A = torch.randn((m, w), generator=g, device=cuda)
    mask = (torch.rand(w, generator=g, device=cuda) < 0.5).float()
    ref = V.double().T @ (A.double() * mask.double())
    lib = _relf(torch.mm(V.T, A * mask), ref)
    W = twy.masked_vt_a(V, A, mask)
    assert _relf(W, ref) <= _f64_gate(lib)
    assert torch.equal(W, twy.masked_vt_a(V, A, mask))
    if m >= 8192:
        assert _relf(twy.masked_vt_a(V, A, mask, chunk=0), ref) \
            > 4 * _relf(W, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,w", [(4096, 1024, 4096), (1024, 8192, 1024),
                                   (300, 36, 516)])
def test_a_minus_vz_masked_holds_fp32_accuracy(cuda, m, k, w):
    g = torch.Generator(device=cuda).manual_seed(m + k)
    A = torch.randn((m, w), generator=g, device=cuda)
    V = torch.randn((m, k), generator=g, device=cuda)
    Z = torch.randn((k, w), generator=g, device=cuda)
    mask = (torch.rand(w, generator=g, device=cuda) < 0.5).float()
    ref = A.double() - (V.double() @ Z.double()) * mask.double()
    lib = _relf(torch.addmm(A, V, Z * mask, alpha=-1.0), ref)
    out = twy.a_minus_vz_masked(A.clone(), V, Z, mask)
    assert _relf(out, ref) <= _f64_gate(lib)
    assert torch.equal(out, twy.a_minus_vz_masked(A.clone(), V, Z, mask))


@pytest.mark.cuda
def test_wy_simt_wrappers_count_on_their_own(cuda):
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(200, 132, 40, 9))
    n0 = dict(twy.LAUNCHES)
    W = twy.masked_vt_a_simt(V, A, mask)
    Wp = twy.masked_vt_a_reference(V, A, mask)
    assert float((W - Wp).abs().max()) <= 1e-4 * float(Wp.abs().max())
    Ap = twy.a_minus_vz_masked_reference(A, V, Z, mask)
    assert twy.a_minus_vz_masked_simt(A, V, Z, mask) is A
    assert float((A - Ap).abs().max()) <= 1e-4 * float(Ap.abs().max())
    assert twy.LAUNCHES == {**n0,
                            "masked_vt_a_simt": n0["masked_vt_a_simt"] + 1,
                            "a_minus_vz_masked_simt":
                            n0["a_minus_vz_masked_simt"] + 1}


@pytest.mark.cuda
def test_wy_kernels_take_misaligned_views_on_the_guarded_path(cuda):
    """A contiguous view that starts 4 bytes into its storage cannot be
    read by 16-byte copies: the wrappers send it to the SIMT kernels."""
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(96, 64, 32, 11))
    Av = torch.empty(96 * 64 + 1, device=cuda)[1:].view(96, 64).copy_(A)
    assert Av.is_contiguous() and not twy.takes_tensor_cores(Av)
    n0 = dict(twy.LAUNCHES)
    W = twy.masked_vt_a(V, Av, mask)
    Wp = twy.masked_vt_a_reference(V, A, mask)
    assert float((W - Wp).abs().max()) <= 1e-4 * float(Wp.abs().max())
    Ap = twy.a_minus_vz_masked_reference(A, V, Z, mask)
    twy.a_minus_vz_masked(Av, V, Z, mask)
    assert float((Av - Ap).abs().max()) <= 1e-4 * float(Ap.abs().max())
    assert twy.LAUNCHES["masked_vt_a_simt"] == n0["masked_vt_a_simt"] + 1
    assert twy.LAUNCHES["a_minus_vz_masked_simt"] \
        == n0["a_minus_vz_masked_simt"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,w", [(torch.float64, 90), (torch.float32, 90),
                                     (torch.float32, 92)])
def test_masked_vt_a_kernel_multiplies_the_mask(cuda, dtype, w):
    """NaN under mask 0 gives NaN (A·mask, not a skip), on the SIMT
    kernels (f64; f32 at w = 90) and on the tensor cores (f32 at w = 92)."""
    V, A, _, mask = (torch.tensor(x, dtype=dtype, device=cuda)
                     for x in _wy_operands(70, w, 8, 1))
    assert twy.takes_tensor_cores(V, A) == (dtype == torch.float32
                                            and w == 92)
    A[3, int(torch.nonzero(mask == 0)[0])] = float("nan")
    W = twy.masked_vt_a(V, A, mask)
    assert torch.equal(torch.isnan(W),
                       torch.isnan(twy.masked_vt_a_reference(V, A, mask)))
    assert torch.isnan(W).any()


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_wy_kernels_keep_the_non_finite_pattern(cuda, bad):
    """On the tensor cores an Inf may come out NaN, but the
    finite/non-finite pattern is the plain version's."""
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(72, 92, 8, 1))
    live = int(torch.nonzero(mask == 1)[0])
    dead = int(torch.nonzero(mask == 0)[0])
    A1 = A.clone()
    A1[3, live] = bad
    A1[7, dead] = bad
    V1 = V.clone()
    V1[9, 2] = bad
    assert twy.takes_tensor_cores(V1, A1, Z, mask)
    W = twy.masked_vt_a(V1, A1, mask)
    Wp = twy.masked_vt_a_reference(V1, A1, mask)
    assert torch.equal(torch.isfinite(W), torch.isfinite(Wp))
    assert not bool(torch.isfinite(W).all())
    Z1 = Z.clone()
    Z1[2, live] = bad
    Z1[4, dead] = bad
    Up = twy.a_minus_vz_masked_reference(A, V, Z1, mask)
    U = twy.a_minus_vz_masked(A.clone(), V, Z1, mask)
    assert torch.equal(torch.isfinite(U), torch.isfinite(Up))
    assert not bool(torch.isfinite(U).all())


def _lu_gates(M, F, s, tol):
    """|u_jj| >= 1 and L·U = M − diag(s) within ``tol``."""
    k = M.shape[0]
    U = torch.triu(F)
    assert float(U.diagonal().abs().min()) >= 1.0 - 1e-5
    L = torch.tril(F, -1) + torch.eye(k, dtype=M.dtype, device=M.device)
    assert float((L @ U - (M - torch.diag(s))).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 48, 128, 200, 256, 300, 2048])
def test_getrfnp_kernel_matches_plain(cuda, dtype, k):
    """The blocked kernel against the plain recursive version (s equal,
    F within 1e-4 / 1e-10) and against the model of its own schedule
    (``getrfnp_schedule``: the same terms in the same order, one rounding
    fewer a term, so within 1e-5 / 1e-12)."""
    M = torch.tensor(_orthonormal(k, k), dtype=dtype, device=cuda)
    n0 = dict(tlu.LAUNCHES)
    F, s = tlu.getrfnp_routed(M)
    torch.cuda.synchronize()
    assert tlu.LAUNCHES == {**n0, "getrfnp": n0["getrfnp"] + 1}
    f32 = dtype == torch.float32
    tol = 1e-4 if f32 else 1e-10
    Fp, sp = tlu.getrfnp(M)
    assert torch.equal(s, sp)
    assert float((F - Fp).abs().max()) <= tol
    Fm, sm = tlu.getrfnp_schedule(M)
    assert torch.equal(s, sm)
    assert float((F - Fm).abs().max()) <= (1e-5 if f32 else 1e-12)
    _lu_gates(M, F, s, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 48, 256, 300])
def test_getrfnp_flat_matches_plain(cuda, dtype, k):
    """The earlier flat kernel, reachable as ``getrfnp_flat`` and counted
    apart."""
    M = torch.tensor(_orthonormal(k, k), dtype=dtype, device=cuda)
    n0 = dict(tlu.LAUNCHES)
    F, s = tlu.getrfnp_flat(M)
    torch.cuda.synchronize()
    assert tlu.LAUNCHES == {**n0, "getrfnp_flat": n0["getrfnp_flat"] + 1}
    Fp, sp = tlu.getrfnp(M)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert torch.equal(s, sp)
    assert float((F - Fp).abs().max()) <= tol
    _lu_gates(M, F, s, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [128, 256])
def test_getrfnp_kernel_is_deterministic_and_agrees_with_the_library(
        cuda, dtype, k):
    """Two launches give the same bits, and F agrees with cuSOLVER's
    unpivoted LU of M − diag(s) (the signs handed to it) within the K3
    gates."""
    M = torch.tensor(_orthonormal(k, 3 * k), dtype=dtype, device=cuda)
    F, s = tlu.getrfnp_cuda(M)
    F2, s2 = tlu.getrfnp_cuda(M)
    assert torch.equal(F, F2) and torch.equal(s, s2)
    LU, _, info = torch.linalg.lu_factor_ex(M - torch.diag(s), pivot=False)
    assert int(info) == 0
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((F - LU).abs().max()) <= tol


@pytest.mark.cuda
def test_getrfnp_kernel_takes_the_adversarial_rotations(cuda):
    """The rotation block on which a fixed sign choice is singular."""
    th = 0.7
    R2 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    for dtype in (torch.float32, torch.float64):
        M = torch.tensor(np.kron(np.eye(40), R2), dtype=dtype, device=cuda)
        F, s = tlu.getrfnp_cuda(M)
        Fp, sp = tlu.getrfnp(M)
        assert torch.equal(s, sp)
        tol = 1e-4 if dtype == torch.float32 else 1e-10
        assert float((F - Fp).abs().max()) <= tol
        _lu_gates(M, F, s, tol)


@pytest.mark.cuda
def test_cuda_path_goes_through_the_kernels(cuda):
    """On the card, f64: the whole factorization runs through K1/K2/K3
    and agrees with the CPU plain path on the same injected sketch."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((384, 320)) * np.logspace(0, -6, 320)
    S = torch.tensor(rng.standard_normal((80, 384)) / np.sqrt(80))
    kw = dict(block_size=64, pivot_candidates=2, update_defer=2)
    for counts in (twy.LAUNCHES, tlu.LAUNCHES):
        for name in counts:
            counts[name] = 0
    fg, _ = bqrrp_factored(torch.tensor(A, device=cuda), BQRRPConfig(**kw),
                           rt.RNGState(2), sketch=S.to(cuda))
    torch.cuda.synchronize()
    # 5 blocks, update groups of 2 + 2 + 1
    # every other count (SIMT bodies, the trailing-mode forms, the
    # earlier TF32 form, the pre-pass alone) stays 0
    assert twy.LAUNCHES == {**dict.fromkeys(twy.LAUNCHES, 0),
                            "masked_vt_a": 5, "a_minus_vz_masked": 3}
    assert tlu.LAUNCHES == {"getrfnp": 5, "getrfnp_flat": 0}
    fc, _ = bqrrp_factored(torch.tensor(A), BQRRPConfig(**kw),
                           rt.RNGState(2), sketch=S)
    assert torch.equal(fg.J.cpu(), fc.J)
    assert float((fg.R.cpu() - fc.R).abs().max()) \
        <= 1e-10 * float(fc.R.abs().max())
    assert float((bqrrp_q(fg).cpu() - bqrrp_q(fc)).abs().max()) <= 1e-10


def _spread(shape, seed):
    """Gaussian columns scaled by exp(-3·U): spread-out column norms."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp(-3 * rng.random(shape[1]))[None, :])


def _reset_all():
    for counts in (twy.LAUNCHES, tlu.LAUNCHES, tqrcp.LAUNCHES):
        for name in counts:
            counts[name] = 0


# K5/K6 routes: the step kernel (the shape may send it to the cooperative
# one), the cooperative kernel with slabs in shared memory where they fit,
# and with slabs in device memory
_QRCP_ROUTES = ["step", "coop", "coop_global"]


def _select_on(route, Y, b, live):
    if route == "step":
        return tqrcp.qrcp_select_pivots_cuda(Y, b, live)
    return tqrcp.qrcp_select_pivots_coop(Y, b, live,
                                         force_global=route == "coop_global")


def _panel_on(route, P, r0, pivot):
    if route == "step":
        return tqrcp.qrcp_panel_cuda(P, r0, pivot)
    return tqrcp.qrcp_panel_coop(P, r0, pivot,
                                 force_global=route == "coop_global")


def _launched(counts_before, name, route):
    """Which counter a launch of ``route`` went to: the step kernel's, or
    (for shapes it refuses, and for the cooperative routes) the
    cooperative kernel's."""
    step = tqrcp.LAUNCHES[name] - counts_before[name]
    coop = (tqrcp.LAUNCHES[name + "_coop"]
            - counts_before[name + "_coop"])
    return step, coop


@pytest.mark.cuda
@pytest.mark.parametrize("route", _QRCP_ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d,n,b", [(74, 512, 64), (26, 256, 16),
                                   (138, 8192, 128), (138, 1000, 128),
                                   (12, 37, 12), (31, 300, 31),
                                   (33, 300, 33), (64, 130, 64),
                                   (65, 130, 65), (160, 513, 128),
                                   (161, 513, 128), (256, 300, 128),
                                   (257, 400, 100)])
def test_select_pivots_kernel_matches_plain(cuda, dtype, d, n, b, route):
    """Pivots equal to the plain version's and to the step schedule's
    model, at the step kernel's row boundaries (2, 5 or 8 rows a lane:
    d 64/65, 160/161, 256/257 -- past 256 the cooperative kernel takes
    it), d below and above a warp's width and n off the 64-column slab."""
    Y = torch.tensor(_spread((d, n), d + n), dtype=dtype, device=cuda)
    live = torch.ones(n, dtype=dtype, device=cuda)
    live[torch.tensor([0, 3, 5, 8, 9, 20, n - 1])] = 0.0
    n0 = dict(tqrcp.LAUNCHES)
    out = _select_on(route, Y, b, live)
    ref = tqr.qrcp_select_pivots(Y, b, live)
    torch.cuda.synchronize()
    step, coop = _launched(n0, "qrcp_select_pivots", route)
    assert (step, coop) == ((1, 0) if route == "step" and d <= 256
                            else (0, 1))
    assert torch.equal(out, ref)
    assert torch.equal(out, tqrcp.qrcp_select_pivots_schedule(Y, b, live))
    assert not set(out.tolist()) & {0, 3, 5, 8, 9, 20, n - 1}


@pytest.mark.cuda
@pytest.mark.parametrize("route", _QRCP_ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,b,r0,pivot", [(512, 64, 0, True),
                                          (512, 64, 128, True),
                                          (512, 64, 128, False),
                                          (8192, 128, 0, True),
                                          (8192, 128, 4096, True),
                                          (1000, 100, 333, True),
                                          (64, 64, 0, True),
                                          (300, 1, 299, True),
                                          (700, 31, 669, True),
                                          (700, 33, 667, True),
                                          (700, 33, 100, False),
                                          (1000, 128, 872, True),
                                          (1000, 129, 0, True),
                                          (1000, 256, 744, True),
                                          (2000, 256, 0, True)])
def test_panel_kernel_matches_plain(cuda, dtype, m, b, r0, pivot, route):
    """sigma equal to the plain version's and to the step schedule's
    model, W and taus within 1e-4 (f32) / 1e-10 (f64) of the largest
    entry, at b 1, 31, 33, 128 (the step kernel's most), 129 and 256
    (past it: the cooperative kernel), row0 = m - b and rows not a
    multiple of the 256- (f32) or 128-row (f64) slab."""
    P = torch.tensor(_spread((m, b), m + b + r0), dtype=dtype, device=cuda)
    n0 = dict(tqrcp.LAUNCHES)
    if route == "step":
        W, V, taus, sigma = tqrcp.qrcp_panel_routed(P, r0, pivot)
    else:
        W, taus, sigma = _panel_on(route, P, r0, pivot)
        V = None
    Wp, Vp, tp, sp = tqr.qrcp_panel(P, r0, pivot)
    torch.cuda.synchronize()
    step, coop = _launched(n0, "qrcp_panel", route)
    assert (step, coop) == ((1, 0) if route == "step" and b <= 128
                            else (0, 1))
    assert torch.equal(sigma, sp)
    assert torch.equal(sigma, tqrcp.qrcp_panel_schedule(P, r0, pivot)[3])
    assert torch.equal(W[:r0], P[:r0, sigma])
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((W - Wp).abs().max()) <= tol * float(Wp.abs().max())
    assert float((taus - tp).abs().max()) <= tol
    if V is not None:
        assert float((V - Vp).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("route", _QRCP_ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qrcp_kernels_break_exact_ties_to_the_lower_index(cuda, dtype,
                                                          route):
    """A duplicated column of the largest norm ties at the first step,
    where every kernel and the plain version take the same norms of the
    same values: the lower index goes first, as torch.argmax decides. Its
    twin is left at rounding level, so K5 (30 steps) never takes it and
    K6 takes it last."""
    Y = _spread((40, 200), 17)
    Y[:, 60] *= 2 * np.linalg.norm(Y, axis=0).max() / np.linalg.norm(
        Y[:, 60])
    Y[:, 150] = Y[:, 60]
    Y = torch.tensor(Y, dtype=dtype, device=cuda)
    live = torch.ones(200, dtype=dtype, device=cuda)
    out = _select_on(route, Y, 30, live)
    ref = tqr.qrcp_select_pivots(Y, 30, live)
    assert torch.equal(out, ref) and int(out[0]) == 60
    assert 150 not in out.tolist()
    P = _spread((600, 48), 18)
    P[:, 7] *= 2 * np.linalg.norm(P, axis=0).max() / np.linalg.norm(
        P[:, 7])
    P[:, 40] = P[:, 7]
    P = torch.tensor(P, dtype=dtype, device=cuda)
    W, taus, sigma = _panel_on(route, P, 200, True)
    _, _, _, sp = tqr.qrcp_panel(P, 200, True)
    assert torch.equal(sigma, sp)
    assert int(sigma[0]) == 7 and int(sigma[-1]) == 40


@pytest.mark.cuda
@pytest.mark.parametrize("route", _QRCP_ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qrcp_kernels_take_zero_and_nan_columns(cuda, dtype, route):
    """A zero column is chosen last, with tau 0 and alpha = x_i; a NaN
    column is chosen first (torch.argmax's rule) and the kernels still
    return a permutation; K5 with all but 5 columns retired picks them,
    then column 0, as the plain version does."""
    P = _spread((500, 40), 19)
    P[:, 13] = 0.0
    Pt = torch.tensor(P, dtype=dtype, device=cuda)
    W, taus, sigma = _panel_on(route, Pt, 50, True)
    Wp, _, tp, sp = tqr.qrcp_panel(Pt, 50, True)
    assert torch.equal(sigma, sp) and int(sigma[-1]) == 13
    assert float(taus[-1]) == 0.0 and float(W[50 + 39, 39]) == 0.0
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((W - Wp).abs().max()) <= tol * float(Wp.abs().max())
    P[3, 21] = np.nan
    W, taus, sigma = _panel_on(route, torch.tensor(P, dtype=dtype,
                                                   device=cuda), 0, True)
    assert int(sigma[0]) == 21
    assert sorted(sigma.tolist()) == list(range(40))
    Y = _spread((30, 300), 20)
    Y[5, 77] = np.nan
    Yt = torch.tensor(Y, dtype=dtype, device=cuda)
    live = torch.ones(300, dtype=dtype, device=cuda)
    assert int(_select_on(route, Yt, 10, live)[0]) == 77
    live = torch.zeros(300, dtype=dtype, device=cuda)
    live[torch.tensor([250, 4, 131, 66, 299])] = 1.0
    Yt = torch.tensor(_spread((30, 300), 21), dtype=dtype, device=cuda)
    out = _select_on(route, Yt, 8, live)
    assert torch.equal(out, tqr.qrcp_select_pivots(Yt, 8, live))
    assert set(out[:5].tolist()) == {250, 4, 131, 66, 299}
    assert out[5:].tolist() == [0, 0, 0]


@pytest.mark.cuda
def test_hqrrp_main_path_takes_the_step_kernels(cuda):
    """HQRRP at 8192^2 f32, b 128 (64 blocks): 64 launches of each step
    kernel and none of the cooperative ones."""
    from randlapack_tpu_torch.drivers import hqrrp_lapack_format
    from randlapack_tpu_torch.gen import fast_decay_matrix
    A, st = fast_decay_matrix(8192, 8192, rt.RNGState(7), device=cuda)
    _reset_all()
    hqrrp_lapack_format(A, HQRRPConfig(block_size=128, update_defer=4), st)
    torch.cuda.synchronize()
    assert tqrcp.LAUNCHES == {"qrcp_select_pivots": 64, "qrcp_panel": 64,
                              "qrcp_select_pivots_coop": 0,
                              "qrcp_panel_coop": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(384, 320), (256, 400)])
def test_hqrrp_goes_through_the_qrcp_kernels(cuda, m, n):
    """On the card, f64, tall and wide: K5 and K6 launch once per block,
    and the result agrees with the CPU plain path on the same injected
    sketch; ``"never"`` raises on a CUDA tensor and launches neither."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((m, n)) * np.logspace(0, -6, n)
    G = torch.tensor(rng.uniform(-1, 1, (74, m)))
    nblocks = -(-min(m, n) // 64)
    cfg = HQRRPConfig(block_size=64, update_defer=2)
    _reset_all()
    Qg, Rg, Jg, _, fg, _ = hqrrp(torch.tensor(A, device=cuda), cfg,
                                 rt.RNGState(2), sketch=G.to(cuda))
    torch.cuda.synchronize()
    assert tqrcp.LAUNCHES == {"qrcp_select_pivots": nblocks,
                              "qrcp_panel": nblocks,
                              "qrcp_select_pivots_coop": 0,
                              "qrcp_panel_coop": 0}
    assert not any(twy.LAUNCHES.values())
    assert tlu.LAUNCHES == {"getrfnp": 0, "getrfnp_flat": 0}
    Qc, Rc, Jc, _, fc, _ = hqrrp(torch.tensor(A), cfg, rt.RNGState(2),
                                 sketch=G)
    assert torch.equal(Jg.cpu(), Jc) and not bool(fg)
    assert float((Rg.cpu() - Rc).abs().max()) \
        <= 1e-10 * float(Rc.abs().max())
    assert float((Qg.cpu() - Qc).abs().max()) <= 1e-10
    _reset_all()
    Ag = torch.tensor(A, device=cuda)
    for kw in ({"pallas_qrcp": "never"}, {"pallas_panel": "never"}):
        with pytest.raises(NotImplementedError, match="only 'auto'"):
            hqrrp(Ag, HQRRPConfig(block_size=64, **kw), rt.RNGState(2))
    live = torch.ones(n, dtype=Ag.dtype, device=cuda)
    with pytest.raises(NotImplementedError, match="only 'auto'"):
        tqrcp.qrcp_select_pivots_routed(Ag, 8, live, use_pallas="never")
    with pytest.raises(NotImplementedError, match="only 'auto'"):
        tqrcp.qrcp_panel_routed(Ag[:, :64].contiguous(), 0,
                                use_pallas="never")
    assert not any(tqrcp.LAUNCHES.values())
    # CholQR panels go through K3 instead of K6
    _reset_all()
    chol = HQRRPConfig(block_size=64, panel_qr=PanelQR.cholqr)
    hqrrp(torch.tensor(A, device=cuda), chol, rt.RNGState(2))
    torch.cuda.synchronize()
    assert tqrcp.LAUNCHES == {"qrcp_select_pivots": nblocks,
                              "qrcp_panel": 0, "qrcp_select_pivots_coop": 0,
                              "qrcp_panel_coop": 0}
    assert tlu.LAUNCHES == {"getrfnp": nblocks, "getrfnp_flat": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d,n,s", [(8, 8192, 1), (8, 4096, 4), (3, 1000, 1),
                                   (70, 1000, 5), (8, 1000, 130),
                                   (17, 257, 16), (1, 1, 1)])
def test_kernel_matmat_matches_plain(cuda, dtype, d, n, s):
    rng = np.random.default_rng(d + n + s)
    X = torch.tensor(rng.standard_normal((d, n)), dtype=dtype, device=cuda)
    V = torch.tensor(rng.standard_normal((n, s)), dtype=dtype, device=cuda)
    bw = 0.9 * np.sqrt(d)
    n0 = dict(tk.LAUNCHES)
    out = tk.kernel_matmat_routed(X, V, bw)
    again = tk.kernel_matmat(X, V, bw)
    ref = tk.kernel_matmat_reference(X, V, bw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["kernel_matmat"] == n0["kernel_matmat"] + 2
    # f32 beyond 32 coordinates is the SIMT kernel's, like all of f64
    simt = int(dtype == torch.float32 and d > 32)
    assert tk.LAUNCHES["kernel_matmat_simt"] \
        == n0["kernel_matmat_simt"] + 2 * simt
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(out, again)          # no race decides a bit


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,s", [(8, 8192, 1), (8, 4096, 4), (3, 1000, 1),
                                   (17, 257, 16), (30, 1000, 130),
                                   (32, 515, 5), (8, 65536, 1)])
def test_kernel_matmat_tensor_cores_hold_fp32_accuracy(cuda, d, n, s):
    """f32, d ≤ 32: against the f64 plain version at most 4x the SIMT
    kernel's error; from the split emulation, whose products cuBLAS sums
    in fp32 in its own order, no further than that plus the emulation's
    own distance from f64; two launches bit-equal; the SIMT kernel counted
    apart."""
    rng = np.random.default_rng(d + n + s)
    X = torch.tensor(rng.standard_normal((d, n)), dtype=torch.float32,
                     device=cuda)
    V = torch.tensor(rng.standard_normal((n, s)), dtype=torch.float32,
                     device=cuda)
    bw = 1.36 * np.sqrt(d)
    n0 = dict(tk.LAUNCHES)
    wide = int(s >= tk._WIDE_MIN_S)
    out = tk.kernel_matmat(X, V, bw)
    assert tk.LAUNCHES == {**n0, "kernel_matmat": n0["kernel_matmat"] + 1,
                           "kernel_matmat_wide":
                           n0["kernel_matmat_wide"] + wide}
    simt = tk.kernel_matmat_simt(X, V, bw)
    assert tk.LAUNCHES == {**n0, "kernel_matmat": n0["kernel_matmat"] + 1,
                           "kernel_matmat_wide":
                           n0["kernel_matmat_wide"] + wide,
                           "kernel_matmat_simt":
                           n0["kernel_matmat_simt"] + 1}
    ref = tk.kernel_matmat_reference(X.double(), V.double(), bw, block=4096)
    gate = _f64_gate(_relf(simt, ref))
    assert _relf(out, ref) <= gate
    emul = tk.kernel_matmat_split_reference(X, V, bw, block=4096)
    assert _relf(out, emul.double()) <= gate + _relf(emul, ref)
    assert torch.equal(out, tk.kernel_matmat(X, V, bw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 8, 17, 32])
def test_kernel_matmat_has_a_unit_diagonal(cuda, d):
    """K·I is K: 1 on the diagonal within 1e-6 at the median-heuristic
    bandwidth, never above 1, symmetric to rounding."""
    rng = np.random.default_rng(d)
    X = torch.tensor(rng.standard_normal((d, 700)), dtype=torch.float32,
                     device=cuda)
    K = tk.kernel_matmat(X, torch.eye(700, device=cuda), 1.36 * np.sqrt(d))
    assert float((K.diagonal() - 1).abs().max()) <= 1e-6
    assert float(K.max()) <= 1.0
    assert float((K - K.T).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_kernel_linop_matmat_takes_the_kernel(cuda):
    from randlapack_tpu_torch.pdkernels import (SquaredExpKernelLinOp,
                                                standardize_dataset)
    rng = np.random.default_rng(0)
    X = standardize_dataset(torch.tensor(rng.standard_normal((5, 700)),
                                         device=cuda))
    V = torch.tensor(rng.standard_normal((700, 3)), device=cuda)
    mus = [1e-1, 1e-2, 1e-3]
    n0 = tk.LAUNCHES["kernel_matmat"]
    out = SquaredExpKernelLinOp(X, 1.7, mus).matmat(V)
    assert tk.LAUNCHES["kernel_matmat"] == n0 + 1
    ref = SquaredExpKernelLinOp(X.cpu(), 1.7, mus).matmat(
        V.cpu())
    assert float((out.cpu() - ref).abs().max()) <= 1e-11 * float(
        ref.abs().max())
    # and in f32 the tensor-core body, not the SIMT one
    n0 = dict(tk.LAUNCHES)
    out32 = SquaredExpKernelLinOp(X.float(), 1.7, mus).matmat(V.float())
    assert tk.LAUNCHES == {**n0, "kernel_matmat": n0["kernel_matmat"] + 1}
    assert float((out32.cpu() - ref).abs().max()) <= 1e-4 * float(
        ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,d", [(2048, 256, 64), (1000, 300, 13),
                                   (512, 512, 320), (37, 5, 3),
                                   (4096, 130, 200)])
def test_gaussian_sketch_matches_plain(cuda, dtype, m, n, d):
    rng = np.random.default_rng(m + n + d)
    A = torch.tensor(rng.standard_normal((m, n)), dtype=dtype, device=cuda)
    n0 = dict(tk.LAUNCHES)
    out = tk.gaussian_sketch(A, d, 11)
    again = tk.gaussian_sketch(A, d, 11)
    other = tk.gaussian_sketch(A, d, 12)
    ref = tk.gaussian_sketch_reference(A, d, 11)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["gaussian_sketch"] == n0["gaussian_sketch"] + 3
    # f32 with n not a multiple of 4 is the SIMT kernel's, like all of f64
    simt = int(dtype == torch.float32 and n % 4 != 0)
    assert tk.LAUNCHES["gaussian_sketch_simt"] \
        == n0["gaussian_sketch_simt"] + 3 * simt
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(out, again)
    assert not torch.allclose(out, other)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(2048, 256, 64), (1000, 300, 13),
                                   (512, 512, 320), (65536, 128, 128),
                                   (8192, 1028, 200), (40, 8, 1),
                                   (4096, 2048, 130), (300, 516, 257)])
def test_gaussian_sketch_tensor_cores_hold_fp32_accuracy(cuda, m, n, d):
    """f32 on the tensor cores: against the f64 product of the stored S at
    most 4x torch.mm's fp32 error, as close to the three-product
    emulation, two launches bit-equal, no SIMT launch. The shapes leave
    0 to 3 blocks of a cluster past the columns of A, rows of S ragged.
    m 65536 is a long reduction: the chunked accumulation must hide the
    tensor cores' truncation, which shows without it (chunk 0)."""
    rng = np.random.default_rng(m + n + d)
    A = torch.tensor(rng.standard_normal((m, n)), dtype=torch.float32,
                     device=cuda)
    assert twy.takes_tensor_cores(A)
    S = tk.gaussian_sketch_matrix(d, m, 11, torch.float32, cuda)
    ref = S.double() @ A.double()
    gate = _f64_gate(_relf(S @ A, ref))
    n0 = dict(tk.LAUNCHES)
    out = tk.gaussian_sketch_cuda(A, d, 11)
    assert tk.LAUNCHES == {**n0, "gaussian_sketch": n0["gaussian_sketch"] + 1}
    assert _relf(out, ref) <= gate
    assert _relf(out, tk.gaussian_sketch_split_reference(A, d, 11).double()) \
        <= gate
    assert torch.equal(out, tk.gaussian_sketch_cuda(A, d, 11))
    if m >= 65536:
        assert _relf(tk.gaussian_sketch_cuda(A, d, 11, chunk=0), ref) \
            > 4 * _relf(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1025, 300])
def test_gaussian_sketch_guarded_shapes_take_the_simt_kernel(cuda, n):
    """n not a multiple of 4, or a contiguous view that starts 4 bytes
    into its storage, cannot be read by 16-byte copies: the wrapper sends
    them to the SIMT kernel, which also answers on its own."""
    rng = np.random.default_rng(n)
    A = torch.tensor(rng.standard_normal((600, n)), dtype=torch.float32,
                     device=cuda)
    if n % 4 == 0:
        A = torch.empty(600 * n + 1, device=cuda)[1:].view(600, n).copy_(A)
    assert A.is_contiguous() and not twy.takes_tensor_cores(A)
    n0 = dict(tk.LAUNCHES)
    out = tk.gaussian_sketch(A, 70, 3)
    assert tk.LAUNCHES == {**n0, "gaussian_sketch": n0["gaussian_sketch"] + 1,
                           "gaussian_sketch_simt":
                           n0["gaussian_sketch_simt"] + 1}
    ref = tk.gaussian_sketch_reference(A, 70, 3)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(out, tk.gaussian_sketch_simt(A, 70, 3))
    assert tk.LAUNCHES["gaussian_sketch"] == n0["gaussian_sketch"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_gaussian_sketch_keeps_the_non_finite_pattern(cuda, bad):
    """On the tensor cores an Inf in A may come out NaN, but the columns
    that are non-finite are the plain version's."""
    rng = np.random.default_rng(3)
    A = torch.tensor(rng.standard_normal((300, 64)), dtype=torch.float32,
                     device=cuda)
    A[17, 5] = bad
    A[250, 40] = bad
    out = tk.gaussian_sketch(A, 24, 9)
    ref = tk.gaussian_sketch_reference(A, 24, 9)
    assert torch.equal(torch.isfinite(out), torch.isfinite(ref))
    assert not bool(torch.isfinite(out[:, 5]).any())
    assert bool(torch.isfinite(out[:, 6]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [515, 516])
def test_gaussian_sketch_of_identity_is_the_plain_S(cuda, dtype, m):
    """m 516 takes the tensor cores in f32 (their cheaper evaluation of
    S's formulas must stay within 1e-6 of the plain S), m 515 the SIMT
    kernel."""
    d = 70
    n0 = tk.LAUNCHES["gaussian_sketch_simt"]
    S = tk.gaussian_sketch(torch.eye(m, dtype=dtype, device=cuda), d, 2**40 + 5)
    assert tk.LAUNCHES["gaussian_sketch_simt"] - n0 \
        == int(dtype == torch.float32 and m % 4 != 0)
    Sp = tk.gaussian_sketch_matrix(d, m, 2**40 + 5, dtype, cuda)
    Sc = tk.gaussian_sketch_matrix(d, m, 2**40 + 5, dtype, "cpu")
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    assert float((S - Sp).abs().max()) <= tol
    assert float((S.cpu() - Sc).abs().max()) <= tol


@pytest.mark.cuda
def test_krill_and_the_sketch_run_on_the_tensor_core_bodies(cuda):
    """A small f32 KRILL solve and the sketch through their entry points:
    K4 launches once per PCG iteration and once more, K7 once, and
    neither SIMT body runs."""
    from randlapack_tpu_torch.comps import PCGConfig
    from randlapack_tpu_torch.drivers import KrillConfig, krill_full_rpchol
    from randlapack_tpu_torch.pdkernels import (SquaredExpKernelLinOp,
                                                standardize_dataset)
    rng = np.random.default_rng(6)
    X = standardize_dataset(torch.tensor(rng.standard_normal((8, 2048)),
                                         dtype=torch.float32, device=cuda))
    H = torch.tensor(rng.standard_normal((2048, 1)), dtype=torch.float32,
                     device=cuda)
    G = SquaredExpKernelLinOp(X, 3.85, 1e-2)
    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    _, hist, iters, _ = krill_full_rpchol(
        G, H, 1e-2, KrillConfig(k=128, rpchol_block=32,
                                pcg=PCGConfig(tol=1e-5, max_iters=100)),
        rt.RNGState(0))
    assert iters < 100 and float(hist[iters, 0] / hist[0, 0]) <= 1e-5
    assert tk.LAUNCHES == {"kernel_matmat": iters + 1, "gaussian_sketch": 0,
                           "kernel_matmat_simt": 0, "gaussian_sketch_simt": 0,
                           "kernel_matmat_wide": 0}
    from randlapack_tpu_torch import ops
    ops.gaussian_sketch(X.T.contiguous(), 16, 1)
    assert tk.LAUNCHES["gaussian_sketch"] == 1
    assert tk.LAUNCHES["gaussian_sketch_simt"] == 0


# -- the tall-QR slice: CQRRPT, CQRRT and the sketches ------------------------

EPS32 = float(np.finfo(np.float32).eps)
_TALL_GATE = 10 * EPS32 ** 0.75      # tests/test_qr_drivers.py at f32


def _tall_gates(A, Q, R, J, k):
    """Residual ≤ 10·eps^0.75 and orthogonality ≤ 10·eps^0.75·√k at the
    rank k, measured in f64."""
    Qk, Rk = Q[:, :k].double(), R[:k].double()
    AJ = A[:, J].double()
    res = float(torch.linalg.norm(Qk @ Rk - AJ) / torch.linalg.norm(AJ))
    orth = float(torch.linalg.norm(
        Qk.T @ Qk - torch.eye(k, dtype=Qk.dtype, device=Qk.device)))
    assert res <= _TALL_GATE, res
    assert orth <= _TALL_GATE * np.sqrt(k), orth


@pytest.fixture
def tall_f32(cuda):
    from randlapack_tpu_torch.gen import fast_decay_matrix
    A, st = fast_decay_matrix(8192, 512, rt.RNGState(2), decay=9.0,
                              device=cuda)
    return A, st


@pytest.mark.cuda
@pytest.mark.parametrize("kw,k5k6", [
    (dict(), 0),
    (dict(sketch="srht", qrcp=QRCPKind.bqrrp, bqrrp_block=64,
          bqrrp_pivot_candidates=2, trsm_mode="blockinv"), 0),
    (dict(sketch="gaussian", qrcp=QRCPKind.hqrrp, bqrrp_block=32), 16),
    (dict(sketch="srht", qrcp=QRCPKind.hqrrp, bqrrp_block=32,
          trsm_mode="blockinv", q_form="trsm", gram_block=0), 16),
])
def test_cqrrpt_on_the_card_f32(tall_f32, kw, k5k6):
    """8192x512 f32 under the JAX tests' f32 gates; the sketch QRCP
    through HQRRP at b 32 (16 blocks on the 640x512 sketch) launches K5
    and K6 once a block, and nothing else launches a kernel."""
    A, st = tall_f32
    _reset_all()
    Q, R, J, rank, fail, _ = cqrrpt(A, CQRRPTConfig(**kw), st)
    torch.cuda.synchronize()
    assert tqrcp.LAUNCHES == {"qrcp_select_pivots": k5k6,
                              "qrcp_panel": k5k6,
                              "qrcp_select_pivots_coop": 0,
                              "qrcp_panel_coop": 0}
    assert not any(twy.LAUNCHES.values()) and not any(tlu.LAUNCHES.values())
    assert not bool(fail) and int(rank) == 512
    assert torch.equal(torch.sort(J).values, torch.arange(512, device=J.device))
    _tall_gates(A, Q, R, J, int(rank))


@pytest.mark.cuda
@pytest.mark.parametrize("sketch", list(SketchKind))
def test_cqrrt_on_the_card_f32(tall_f32, sketch):
    A, st = tall_f32
    _reset_all()
    Q, R, fail, _ = cqrrt(A, CQRRTConfig(sketch=sketch), st)
    torch.cuda.synchronize()
    assert not any(tqrcp.LAUNCHES.values())
    assert not bool(fail)
    _tall_gates(A, Q, R, torch.arange(512, device=A.device), 512)
    Qn, Rn, fail_n, _ = cqrrt(A, CQRRTConfig(sketch=sketch, compute_q=False),
                              st)
    assert Qn is None and not bool(fail_n)
    assert float((Rn - R).abs().max() / R.abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_saso_scatter_and_gather_agree_on_the_card(cuda, dtype):
    """The two SASO applications agree within 1e-5 (f32) / 1e-12 (f64)
    relative; the scatter sums duplicate rows with atomics, so two of its
    runs need not be bit-equal and are held to the same bound."""
    from randlapack_tpu_torch import sketching as tsk
    g = torch.Generator(device=cuda).manual_seed(3)
    A = torch.randn((65536, 256), generator=g, dtype=dtype, device=cuda)
    op, _ = tsk.fill_sparse(tsk.SparseDist(320, 65536), rt.RNGState(4),
                            dtype=dtype, device=cuda)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    sc = tsk.saso_left_apply(op, A, method="scatter")
    again = tsk.saso_left_apply(op, A, method="scatter")
    ga = tsk.saso_left_apply(op, A, method="gather")
    dense = tsk.saso_to_dense(op).double() @ A.double()
    for out in (sc, again, ga):
        assert float(torch.linalg.norm(out.double() - dense)
                     / torch.linalg.norm(dense)) <= tol
    assert float(torch.linalg.norm(sc - ga) / torch.linalg.norm(ga)) <= tol
    assert all(len(set(c)) == 2 for c in op.rows.T[:2000].tolist())


@pytest.mark.cuda
def test_srht_on_the_card_matches_the_cpu(cuda):
    from randlapack_tpu_torch import sketching as tsk
    rng = np.random.default_rng(8)
    A = torch.tensor(rng.standard_normal((3000, 40)))
    op, _ = tsk.srht_skop(256, 3000, rt.RNGState(2), dtype=torch.float64,
                          device="cpu")
    gop = tsk.SRHTSkOp(256, 3000, op.signs.to(cuda), op.rows.to(cuda))
    out = tsk.srht_left_apply(gop, A.to(cuda)).cpu()
    ref = tsk.srht_left_apply(op, A)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("kw,qs_rows", [
    (dict(), 0),
    (dict(sketch="srht", qrcp=QRCPKind.bqrrp, bqrrp_block=64,
          bqrrp_pivot_candidates=2, trsm_mode="blockinv", trsm_block=64,
          gram_block=128), 80),
    (dict(sketch="gaussian", qrcp=QRCPKind.hqrrp, bqrrp_block=64,
          orthogonalization=True), 74),
])
def test_cqrrpt_card_matches_the_cpu_f64(cuda, kw, qs_rows):
    """The same operators (drawn on the CPU) on both devices, f64: same
    pivots and rank, R within 1e-10 of max|R|, Q within 1e-10."""
    import dataclasses
    from randlapack_tpu_torch import sketching as tsk
    rng = np.random.default_rng(6)
    m, n = 4096, 256
    d = int(1.25 * n)
    A = torch.tensor(rng.standard_normal((m, n)) * np.logspace(0, -6, n))
    cfg = CQRRPTConfig(**kw)
    st = rt.RNGState(3)
    if cfg.sketch == "saso":
        op, _ = tsk.fill_sparse(tsk.SparseDist(d, m), st,
                                dtype=torch.float64, device="cpu")
    elif cfg.sketch == "srht":
        op, _ = tsk.srht_skop(d, m, st, dtype=torch.float64, device="cpu")
    else:
        op = torch.tensor(rng.standard_normal((d, m)) / np.sqrt(d))
    qs = None
    if qs_rows:
        qs = torch.tensor(rng.uniform(-1, 1, (qs_rows, d)))
    noise = torch.tensor(rng.standard_normal((m, n)))

    def on(x):
        if isinstance(x, torch.Tensor):
            return x.to(cuda)
        return dataclasses.replace(x, **{
            f.name: getattr(x, f.name).to(cuda) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})

    _reset_all()
    Qg, Rg, Jg, rg, fg, _ = cqrrpt(A.to(cuda), cfg, st, sketch=on(op),
                                   qrcp_sketch=None if qs is None
                                   else qs.to(cuda), noise=noise.to(cuda))
    torch.cuda.synchronize()
    k = 4 if cfg.qrcp == QRCPKind.hqrrp else 0
    assert tqrcp.LAUNCHES["qrcp_select_pivots"] == tqrcp.LAUNCHES[
        "qrcp_panel"] == k
    Qc, Rc, Jc, rc, fc, _ = cqrrpt(A, cfg, st, sketch=op, qrcp_sketch=qs,
                                   noise=noise)
    assert torch.equal(Jg.cpu(), Jc) and int(rg) == int(rc) == n
    assert bool(fg) == bool(fc) is False
    assert float((Rg.cpu() - Rc).abs().max()) <= 1e-10 * float(
        Rc.abs().max())
    assert float((Qg.cpu() - Qc).abs().max()) <= 1e-10


# -- the low-rank slice: K4 at wide s, RSVD and REVD2 on the card -------------

@pytest.mark.cuda
@pytest.mark.parametrize("s", [16, 17, 256, 1024])
def test_kernel_matmat_wide_s_holds_fp32_accuracy(cuda, s):
    """REVD2's shapes (V n×k, k in the hundreds to thousands): against the
    split emulation within its own distance from f64 plus the gate, and
    against the f64 plain version at most 4x the SIMT kernel's error."""
    rng = np.random.default_rng(s)
    d, n = 8, 2048
    X = torch.tensor(rng.standard_normal((d, n)), dtype=torch.float32,
                     device=cuda)
    V = torch.tensor(rng.standard_normal((n, s)), dtype=torch.float32,
                     device=cuda)
    bw = 1.36 * np.sqrt(d)
    out = tk.kernel_matmat(X, V, bw)
    ref = tk.kernel_matmat_reference(X.double(), V.double(), bw, block=1024)
    gate = _f64_gate(_relf(tk.kernel_matmat_simt(X, V, bw), ref))
    assert _relf(out, ref) <= gate
    emul = tk.kernel_matmat_split_reference(X, V, bw, block=1024)
    assert _relf(out, emul.double()) <= gate + _relf(emul, ref)
    assert torch.equal(out, tk.kernel_matmat(X, V, bw))


def _narrow_by_slices(X, V, bw):
    """K·V by the narrow tensor-core body alone: V in slices of fewer
    than _WIDE_MIN_S columns, one launch each."""
    w = min(16, tk._WIDE_MIN_S - 1)
    n0 = tk.LAUNCHES["kernel_matmat_wide"]
    out = torch.cat([tk.kernel_matmat(X, V[:, c:c + w].contiguous(), bw)
                     for c in range(0, V.shape[1], w)], dim=1)
    assert tk.LAUNCHES["kernel_matmat_wide"] == n0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,s", [
    (1, 1000, 17), (8, 4097, 100), (9, 1000, 1000), (32, 4097, 128),
    (8, 1000, 128), (9, 4097, 17), (32, 1000, 100), (1, 4097, 1000),
    (8, 8192, 1024),                  # two parts of the sum over j
    (8, 65536, 1024)])                # REVD2's
def test_kernel_matmat_wide_body_matches_the_plain_versions(cuda, d, n, s):
    """The wide body (three TF32 wgmma products of the split entries
    and V) at s ≥ _WIDE_MIN_S, where it runs, against the f64 plain
    version at most 4x the SIMT kernel's error (as the narrow body is
    held); against its own arithmetic in plain PyTorch
    (``kernel_matmat_wide_reference``, with the launch's splits) and
    against the narrow body on slices of V no further than that plus
    their own distance from f64; two launches bit-equal; counted."""
    rng = np.random.default_rng(d + n + s)
    X = torch.tensor(rng.standard_normal((d, n)), dtype=torch.float32,
                     device=cuda)
    V = torch.tensor(rng.standard_normal((n, s)), dtype=torch.float32,
                     device=cuda)
    bw = 1.36 * np.sqrt(d)
    body, splits = tk.kernel_matmat_plan(d, n, s)
    n0 = dict(tk.LAUNCHES)
    out = tk.kernel_matmat(X, V, bw)
    wide = int(body == "wide")
    assert tk.LAUNCHES == {**n0, "kernel_matmat": n0["kernel_matmat"] + 1,
                           "kernel_matmat_wide":
                           n0["kernel_matmat_wide"] + wide}
    assert torch.equal(out, tk.kernel_matmat(X, V, bw))
    ref = tk.kernel_matmat_reference(X.double(), V.double(), bw, block=4096)
    gate = _f64_gate(_relf(tk.kernel_matmat_simt(X, V, bw), ref))
    assert _relf(out, ref) <= gate
    if wide:
        emul = tk.kernel_matmat_wide_reference(X, V, bw, splits=splits)
        assert _relf(out, emul.double()) <= gate + _relf(emul, ref)
        narrow = _narrow_by_slices(X, V, bw)
        assert _relf(out, narrow.double()) <= gate + _relf(narrow, ref)


@pytest.mark.cuda
def test_kernel_matmat_wide_body_keeps_a_nan(cuda):
    """A NaN coordinate in X: its point's entries are NaN, so is every
    output, as in the plain version (the clamp keeps the NaN)."""
    rng = np.random.default_rng(5)
    X = torch.tensor(rng.standard_normal((8, 1000)), dtype=torch.float32,
                     device=cuda)
    V = torch.tensor(rng.standard_normal((1000, 100)), dtype=torch.float32,
                     device=cuda)
    X[3, 17] = float("nan")
    out = tk.kernel_matmat(X, V, 2.0)
    assert tk.kernel_matmat_plan(8, 1000, 100)[0] == "wide"
    assert torch.equal(torch.isnan(out),
                       torch.isnan(tk.kernel_matmat_reference(X, V, 2.0)))
    assert bool(torch.isnan(out).all())


@pytest.mark.cuda
def test_kernel_matmat_takes_the_wide_body_from_the_threshold(cuda):
    """Below _WIDE_MIN_S columns the narrow body runs (the wide count
    stays), from it the wide one; both hold the plain version."""
    rng = np.random.default_rng(7)
    X = torch.tensor(rng.standard_normal((8, 4096)), dtype=torch.float32,
                     device=cuda)
    bw = 1.36 * np.sqrt(8)
    for s in (1, 4, tk._WIDE_MIN_S - 1, tk._WIDE_MIN_S):
        V = torch.tensor(rng.standard_normal((4096, s)), dtype=torch.float32,
                         device=cuda)
        n0 = dict(tk.LAUNCHES)
        out = tk.kernel_matmat(X, V, bw)
        assert tk.LAUNCHES["kernel_matmat_wide"] \
            == n0["kernel_matmat_wide"] + int(s >= tk._WIDE_MIN_S)
        assert tk.LAUNCHES["kernel_matmat"] == n0["kernel_matmat"] + 1
        ref = tk.kernel_matmat_reference(X.double(), V.double(), bw)
        gate = _f64_gate(_relf(tk.kernel_matmat_simt(X, V, bw), ref))
        assert _relf(out, ref) <= gate


def _reset_kernels():
    _reset_all()
    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0


def _launches():
    return {**twy.LAUNCHES, **tlu.LAUNCHES, **tqrcp.LAUNCHES, **tk.LAUNCHES}


def _aligned_cols(ref, x):
    s = torch.sign((ref * x).sum(0))
    return x * torch.where(s == 0, torch.ones_like(s), s)


@pytest.mark.cuda
@pytest.mark.parametrize("svd_method", ["auto", "jacobi"])
def test_rsvd_card_matches_the_cpu_f64(cuda, svd_method):
    """The same injected starts on both devices, f64: U, Vt (sign-aligned)
    within 1e-10, S and err within 1e-12 relative; no kernel launch (the
    JAX package runs RSVD outside Pallas)."""
    from randlapack_tpu_torch.comps import QBConfig
    from randlapack_tpu_torch.drivers import RSVDConfig, rsvd_fixed_rank
    rng = np.random.default_rng(9)
    m, n, k, b = 500, 300, 32, 16
    A = torch.tensor(rng.standard_normal((m, n))
                     * np.exp(-np.arange(n) / 20.0))
    omegas = [torch.tensor(rng.standard_normal((n, b))) for _ in range(k // b)]
    cfg = RSVDConfig(QBConfig(block_size=b), svd_method)
    _reset_kernels()
    Ug, Sg, Vtg, eg, sg = rsvd_fixed_rank(A.to(cuda), k, cfg, rt.RNGState(1),
                                          omegas=[o.to(cuda) for o in omegas])
    torch.cuda.synchronize()
    assert not any(_launches().values())
    Uc, Sc, Vtc, ec, sc = rsvd_fixed_rank(A, k, cfg, rt.RNGState(1),
                                          omegas=omegas)
    assert (sg.key, sg.counter) == (sc.key, sc.counter)
    assert float((Sg.cpu() - Sc).abs().max()) <= 1e-12 * float(Sc[0])
    assert abs(float(eg) - float(ec)) <= 1e-12 * float(ec)
    lead = slice(0, 16)              # well-separated triplets
    assert float((_aligned_cols(Uc[:, lead], Ug.cpu()[:, lead])
                  - Uc[:, lead]).abs().max()) <= 1e-10
    assert float((_aligned_cols(Vtc.T[:, lead], Vtg.cpu().T[:, lead])
                  - Vtc.T[:, lead]).abs().max()) <= 1e-10


def _kernel_op(n, dtype, device, seed=3):
    from randlapack_tpu_torch.pdkernels import (SquaredExpKernelLinOp,
                                                standardize_dataset)
    rng = np.random.default_rng(seed)
    X = standardize_dataset(torch.tensor(rng.standard_normal((8, n)),
                                         dtype=dtype))
    return SquaredExpKernelLinOp(X.to(device), 3.0, 0.0,
                                 evals_include_reg=False)


@pytest.mark.cuda
def test_revd2_card_matches_the_cpu_f64(cuda):
    """REVD2 over the kernel operator, f64 (K4's SIMT kernel on the card,
    its plain version on the CPU), same injected draws: λ and err within
    1e-10 of λ₁, V's leading columns (sign-aligned) within 1e-8; 15 K4
    launches (3 SYPS passes, SYRF, Y, 10 power-estimate passes)."""
    from randlapack_tpu_torch.drivers import REVD2Config, revd2_fixed_rank
    n, k = 1024, 64
    rng = np.random.default_rng(4)
    omega = torch.tensor(rng.standard_normal((n, k)))
    v0 = torch.tensor(rng.standard_normal((n, 1)))
    opc = _kernel_op(n, torch.float64, "cpu")
    opg = _kernel_op(n, torch.float64, cuda)
    _reset_kernels()
    Vg, lg, eg, _, fg, _ = revd2_fixed_rank(opg, k, REVD2Config(),
                                            rt.RNGState(0), omega=omega.to(
                                                cuda), v0=v0.to(cuda))
    torch.cuda.synchronize()
    assert _launches() == {**{name: 0 for name in _launches()},
                           "kernel_matmat": 15}
    Vc, lc, ec, _, fc, _ = revd2_fixed_rank(opc, k, REVD2Config(),
                                            rt.RNGState(0), omega=omega,
                                            v0=v0)
    assert not bool(fg) and not bool(fc)
    l1 = float(lc[0])
    assert float((lg.cpu() - lc).abs().max()) <= 1e-10 * l1
    assert abs(float(eg) - float(ec)) <= 1e-10 * l1
    lead = slice(0, 8)
    assert float((_aligned_cols(Vc[:, lead], Vg.cpu()[:, lead])
                  - Vc[:, lead]).abs().max()) <= 1e-8


@pytest.mark.cuda
def test_revd2_f32_reaches_the_tensor_core_kernel(cuda):
    """An f32 CUDA operator: every product of REVD2 is K4's tensor-core
    body (15 launches, none of the SIMT one; the 5 at s = k 128 the wide
    body), V orthonormal, λ ≥ 0 and descending, ``fail`` False."""
    from randlapack_tpu_torch.drivers import REVD2Config, revd2_fixed_rank
    op = _kernel_op(4096, torch.float32, cuda)
    _reset_kernels()
    V, lam, err, _, fail, _ = revd2_fixed_rank(op, 128, REVD2Config(),
                                               rt.RNGState(2))
    torch.cuda.synchronize()
    assert _launches() == {**{name: 0 for name in _launches()},
                           "kernel_matmat": 15, "kernel_matmat_wide": 5}
    assert not bool(fail) and bool(torch.isfinite(err))
    orth = torch.linalg.norm(V.T.double() @ V.double()
                             - torch.eye(128, dtype=torch.float64,
                                         device=cuda))
    assert float(orth) <= 10 * (2.0 ** -23) ** 0.75 * np.sqrt(128)
    assert bool((lam >= 0).all()) and bool((lam[:-1] >= lam[1:]).all())


@pytest.mark.cuda
def test_svd_econ_keeps_u_orthonormal_where_the_default_driver_does_not(
        cuda):
    """A 65536×1024 f32 RPCholesky factor of the kernel matrix (KRILL's
    preconditioner basis at full size): ``torch.linalg.svd`` with the
    library's default card driver, the route ``svd_econ("xla")`` took
    before its QR-then-``gesvd`` route, leaves ‖UᵀU − I‖_F above the f32
    rule 10·eps^0.75·√k = 2.0e-3; ``svd_econ`` meets it, with σ within
    1e-5·σ₁ of the f64 SVD of the same factor."""
    from randlapack_tpu_torch.comps import RPCholConfig, rp_cholesky
    from randlapack_tpu_torch.ops.svd import svd_econ
    k = 1024
    F, _, _ = rp_cholesky(_kernel_op(65536, torch.float32, cuda), k,
                          RPCholConfig(block_size=64), rt.RNGState(6))
    eye = torch.eye(k, dtype=torch.float64, device=cuda)

    def orth(U):
        return float(torch.linalg.norm(U.double().T @ U.double() - eye))

    gate = 10 * EPS32 ** 0.75 * np.sqrt(k)
    U_lib = torch.linalg.svd(F, full_matrices=False)[0]
    U, s, _ = svd_econ(F, "xla")
    s64 = torch.linalg.svdvals(F.double())
    assert orth(U_lib) > gate, (orth(U_lib), gate)
    assert orth(U) <= gate, (orth(U), gate)
    assert float((s.double() - s64).abs().max()) <= 1e-5 * float(s64[0])


# -- the operator slice: cuSPARSE products, the sparse solve, ABRIK ----------

def _sparse_pair(m, n, density, dtype, cuda, seed):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(m, n, generator=g, dtype=dtype) \
        * (torch.rand(m, n, generator=g) < density)
    from randlapack_tpu_torch.linops import SparseLinOp
    return (SparseLinOp.from_dense(A), SparseLinOp.from_dense(A.to(cuda)),
            g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
def test_sparse_linop_products_on_the_card(cuda, dtype, tol):
    """``SparseLinOp`` matmat/tmatmat/rmatmat/cols on the card (cuSPARSE
    SpMM on int32 CSR) against the same operator on the CPU. Two card
    calls agree to rounding but need not be bit-equal: the SpMM the
    library picks (``csrmm_alg2``) splits long rows between threads and
    adds the parts in no fixed order (here ``tmatmat``, ~60 entries a
    row of Aᵀ, differed between calls; ``matmat``, ~14 a row, did not)."""
    op_c, op_g, g = _sparse_pair(3000, 700, 0.02, dtype, cuda, 1)
    assert op_g.A.crow_indices().dtype == torch.int32
    X = torch.randn(700, 64, generator=g, dtype=dtype)
    Y = torch.randn(3000, 64, generator=g, dtype=dtype)
    Z = torch.randn(5, 3000, generator=g, dtype=dtype)
    for name, args in (("matmat", (X,)), ("tmatmat", (Y,)),
                       ("rmatmat", (Z,)), ("cols", (100, 64))):
        ref = getattr(op_c, name)(*args)
        card = [getattr(op_g, name)(*(a.to(cuda) if isinstance(
            a, torch.Tensor) else a for a in args)) for _ in range(2)]
        assert card[0].is_cuda
        assert float((card[0].cpu() - ref).abs().max()) \
            <= tol * float(ref.abs().max()), name
        assert float((card[0] - card[1]).abs().max()) \
            <= tol * float(ref.abs().max()), name
    assert float(op_g.fro_nrm()) == pytest.approx(float(op_c.fro_nrm()),
                                                  rel=10 * tol)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_sparse_data_products_on_the_card(cuda, fmt):
    """``left_spmm``, ``right_spmm`` and ``spgemm`` on COO and CSR
    tensors on the card against the same calls on the CPU, f64."""
    from randlapack_tpu_torch.sketching import sparse_data as sd
    rng = np.random.default_rng(5)
    shape = (300, 200)
    rows, cols = rng.integers(0, 300, 2000), rng.integers(0, 200, 2000)
    vals = rng.standard_normal(2000)
    if fmt == "coo":
        def make(dev):
            return sd.to_bcoo(rows, cols, vals, shape, device=dev)
    else:
        csr = sd.coo_to_csr(rows, cols, vals, shape)

        def make(dev):
            return sd.to_bcsr(*csr, shape, device=dev)
    B = torch.tensor(rng.standard_normal((200, 7)))
    C = torch.tensor(rng.standard_normal((7, 300)))
    sp_c, sp_g = make("cpu"), make(cuda)
    pairs = [(sd.left_spmm(sp_c, B), sd.left_spmm(sp_g, B.to(cuda))),
             (sd.right_spmm(C, sp_c), sd.right_spmm(C.to(cuda), sp_g)),
             (sd.spgemm(sp_c, sp_c.t() if fmt == "coo"
                        else sp_c.t().to_sparse_csr()).to_dense(),
              sd.spgemm(sp_g, sp_g.t() if fmt == "coo"
                        else sp_g.t().to_sparse_csr()).to_dense())]
    for ref, got in pairs:
        assert got.is_cuda
        assert float((got.cpu() - ref).abs().max()) \
            <= 1e-12 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("lower,unit", [(True, False), (False, True)])
def test_sparse_trsm_on_the_card(cuda, lower, unit):
    from randlapack_tpu_torch.sketching import sparse_trsm
    n = 700
    rng = np.random.default_rng(3)
    T = np.where(rng.random((n, n)) < 0.02, rng.standard_normal((n, n)), 0.0)
    T = (np.tril(T, -1) if lower else np.triu(T, 1)) \
        + np.diag(2.0 + rng.random(n))
    rows, cols = np.nonzero(T)
    B = torch.tensor(rng.standard_normal((n, 4)))
    ref = sparse_trsm(rows, cols, T[rows, cols], n, B, lower, unit, 256)
    got = sparse_trsm(rows, cols, T[rows, cols], n, B.to(cuda), lower, unit,
                      256)
    assert got.is_cuda
    assert float((got.cpu() - ref).abs().max()) \
        <= 1e-12 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("qr", ["geqrf", "cqrrt"])
def test_abrik_on_the_card_f64_against_the_cpu(cuda, qr):
    """ABRIK over the sparse operator in f64 on the card and on the CPU,
    the same start and QR sketches injected: iterations equal, S within
    1e-10·σ₀, U and V within 1e-9 after sign alignment, no kernel."""
    from randlapack_tpu_torch.drivers import ABRIKConfig, abrik
    op_c, op_g, g = _sparse_pair(400, 250, 0.1, torch.float64, cuda, 4)
    cfg = ABRIKConfig(block_size=8, max_iters=5, qr_explicit=qr)
    v0 = torch.randn(250, 8, generator=g, dtype=torch.float64)
    sk = [torch.randn(10, 250 if (i % 2 == 0 and i > 0) else 400,
                      generator=g, dtype=torch.float64) for i in range(10)]
    _reset_kernels()
    Ug, Sg, Vtg, ig, _ = abrik(op_g, 12, cfg, rt.RNGState(0),
                               v0=v0.to(cuda),
                               qr_sketches=[s.to(cuda) for s in sk])
    torch.cuda.synchronize()
    assert all(v == 0 for v in _launches().values())
    Uc, Sc, Vtc, ic, _ = abrik(op_c, 12, cfg, rt.RNGState(0), v0=v0,
                               qr_sketches=sk)
    assert ig["num_krylov_iters"] == ic["num_krylov_iters"]
    assert float((Sg.cpu() - Sc).abs().max()) <= 1e-10 * float(Sc[0])
    su = torch.sign((Ug.cpu() * Uc).sum(0))
    sv = torch.sign((Vtg.cpu() * Vtc).sum(1))
    assert float((Ug.cpu() * su - Uc).abs().max()) <= 1e-9
    assert float((Vtg.cpu() * sv[:, None] - Vtc).abs().max()) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [(torch.float32, (512, 384, 64)),
                                         (torch.float32, (300, 250, 30)),
                                         (torch.float64, (300, 250, 30))])
def test_trailing_wy_update_on_the_card(cuda, dtype, shape):
    """One K1 and one K2 launch, A unchanged, the result within 1e-4 (f32)
    / 1e-12 (f64) of the plain version's largest entry."""
    m, w, b = shape
    V, A, _, mask = _wy_operands(m, w, b, 11)
    T = np.triu(np.random.default_rng(12).standard_normal((b, b)))
    Vt, At, Tt, mt = (torch.tensor(x, dtype=dtype, device=cuda)
                      for x in (V, A, T, mask))
    A0 = At.clone()
    _reset_kernels()
    out = twy.trailing_wy_update(At, Vt, Tt, mt)
    torch.cuda.synchronize()
    counts = _launches()
    assert counts["masked_vt_a"] == 1 and counts["a_minus_vz_masked"] == 1
    assert sum(counts.values()) == 2 + counts["masked_vt_a_simt"] \
        + counts["a_minus_vz_masked_simt"]
    assert torch.equal(At, A0)
    ref = twy.trailing_wy_update(*(t.cpu() for t in (At, Vt, Tt, mt)))
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    assert float((out.cpu() - ref).abs().max()) \
        <= tol * float(ref.abs().max())


# (SPLSConfig fields, μ, right-hand sides, tol, gate on x): κ 1e3; LSQR
# run to its stall stop (its iterates before it move 1e-8 with a last-bit
# change), x within 100·κ·eps; PCG (normal equations) within 10·κ²·eps
SPLS_CARD_CASES = [
    (dict(), 0.0, None, 1e-12, 100 * 1e3 * 2.2e-16),
    (dict(refine_precond=False), 0.0, None, 1e-12, 100 * 1e3 * 2.2e-16),
    (dict(precond="qr"), 0.0, None, 1e-12, 100 * 1e3 * 2.2e-16),
    (dict(solver="pcg"), 0.0, None, 1e-10, 10 * 1e6 * 2.2e-16),
    (dict(), 1e-4, None, 1e-12, 1e-10),
    (dict(), 1e-6, 3, 1e-10, 10 * 1e6 * 2.2e-16)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw,mu,b_cols,tol,gate", SPLS_CARD_CASES)
def test_spls_on_the_card_f64_against_the_cpu(cuda, kw, mu, b_cols, tol,
                                              gate):
    """spls in f64 on the card and on the CPU with one SASO: the same
    iteration count (within 1), x within the case's gate (κ 1e3), no
    kernel launch."""
    from randlapack_tpu_torch.comps import PCGSaddleConfig
    from randlapack_tpu_torch.drivers import SPLSConfig, spls
    from randlapack_tpu_torch.sketching import SparseDist, fill_sparse
    g = torch.Generator().manual_seed(21)
    m, n = 600, 50
    U = torch.linalg.qr(torch.randn(m, n, generator=g,
                                    dtype=torch.float64))[0]
    V = torch.linalg.qr(torch.randn(n, n, generator=g,
                                    dtype=torch.float64))[0]
    A = (U * torch.logspace(0, -3, n, dtype=torch.float64)) @ V.T
    shape = (n,) if b_cols is None else (n, b_cols)
    b = A @ torch.randn(shape, generator=g, dtype=torch.float64)
    cfg = SPLSConfig(pcg=PCGSaddleConfig(tol=tol, max_iters=200), **kw)
    S, _ = fill_sparse(SparseDist(4 * n, m, 8), rt.RNGState(3),
                       dtype=torch.float64, device="cpu")
    Sg = type(S)(S.dist, S.rows.to(cuda), S.vals.to(cuda))
    _reset_kernels()
    xg, _, itg, _ = spls(A.to(cuda), b.to(cuda), mu, cfg, rt.RNGState(3),
                         sketch=Sg)
    torch.cuda.synchronize()
    assert all(v == 0 for v in _launches().values())
    xc, _, itc, _ = spls(A, b, mu, cfg, rt.RNGState(3), sketch=S)
    assert xg.is_cuda and abs(itg - itc) <= 1
    assert float(torch.linalg.norm(xg.cpu() - xc)
                 / torch.linalg.norm(xc)) <= gate


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["chol", "half", "lu"])
def test_solver_linops_on_the_card_against_the_cpu(cuda, kind):
    """The device solves (packed triangular solves and gathers on the
    card) against the CPU's, f64 within 1e-12 of the largest entry and
    f32 within 1e-5; matmat and tmatmat; the host solves return on the
    card."""
    import scipy.sparse as sp
    from randlapack_tpu_torch.extras import CholSolverLinOp, LUSolverLinOp
    rng = np.random.default_rng(5)
    n = 600
    M = sp.random(n, n, density=0.01, random_state=rng)
    K = (M @ M.T + sp.eye(n) * 4 if kind != "lu"
         else M + sp.eye(n) * 3).tocoo()
    B = rng.standard_normal((n, 8))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        def make(device, device_solves=True):
            if kind == "lu":
                return LUSolverLinOp(K.row, K.col, K.data, n, dtype,
                                     device_solves=device_solves,
                                     device=device)
            return CholSolverLinOp(K.row, K.col, K.data, n, dtype,
                                   half=kind == "half",
                                   device_solves=device_solves,
                                   device=device)
        op_c, op_g = make("cpu"), make(cuda)
        host_g = make(cuda, device_solves=False)
        Bc = torch.tensor(B, dtype=dtype)
        for f in ("matmat", "tmatmat"):
            ref = getattr(op_c, f)(Bc)
            for op in (op_g, host_g):
                got = getattr(op, f)(Bc.to(cuda))
                assert got.is_cuda and got.dtype == dtype
                assert float((got.cpu() - ref).abs().max()) \
                    <= tol * float(ref.abs().max())


# -- the trailing-precision forms of K1/K2 ------------------------------------

_FORM_REFS = {
    "tf32": (twy.masked_vt_a_tf32_reference,
             twy.a_minus_vz_masked_tf32_reference),
    "bf16": (twy.masked_vt_a_bf16_reference,
             twy.a_minus_vz_masked_bf16_reference),
    "bf16x3": (twy.masked_vt_a_bf16x3_reference,
               twy.a_minus_vz_masked_bf16x3_reference)}
_MODE_OF_FORM = {"tf32": "high", "bf16": "default", "bf16x3": "bf16_3x_emul"}


@pytest.mark.cuda
@pytest.mark.parametrize("form", twy.FORMS)
@pytest.mark.parametrize("m,w,k", [(64, 64, 64), (3000, 1900, 200),
                                   (1, 1, 1), (513, 1025, 1024),
                                   (8192, 512, 256)])
def test_wy_forms_match_plain(cuda, form, m, w, k):
    """Each form of K1 and K2 against its plain version, through the
    mixed functions a driver calls; (1, 1, 1) and (513, 1025, 1024) go
    through the zero-padded copies."""
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(m, w, k, m + w + 1))
    ref1, ref2 = _FORM_REFS[form]
    tp = _MODE_OF_FORM[form]
    n0 = dict(twy.LAUNCHES)
    W = twy.masked_vt_a_mixed(V, A, mask, tp)
    Wp = ref1(V, A, mask)
    assert float((W - Wp).abs().max()) <= 1e-5 * float(Wp.abs().max())
    assert torch.equal(W, twy.masked_vt_a_mixed(V, A, mask, tp))
    Ap = ref2(A, V, Z, mask)
    Ak = twy.a_minus_vz_masked_mixed(A.clone(), V, Z, mask, tp)
    assert float((Ak - Ap).abs().max()) <= 1e-5 * float(Ap.abs().max())
    assert torch.equal(Ak, twy.a_minus_vz_masked_mixed(A.clone(), V, Z,
                                                       mask, tp))
    # against the f64 products: no worse than twice the plain version
    Vd, Ad, Zd, md = (t.double() for t in (V, A, Z, mask))
    ref = Vd.T @ (Ad * md)
    assert _relf(W, ref) <= 2 * max(_relf(Wp, ref), 2.0 ** -24)
    ref = Ad - (Vd @ Zd) * md
    assert _relf(Ak, ref) <= 2 * max(_relf(Ap, ref), 2.0 ** -24)
    assert twy.LAUNCHES == {**n0,
                            f"masked_vt_a_{form}":
                            n0[f"masked_vt_a_{form}"] + 2,
                            f"a_minus_vz_masked_{form}":
                            n0[f"a_minus_vz_masked_{form}"] + 2}


@pytest.mark.cuda
@pytest.mark.parametrize("form", twy.FORMS)
def test_wy_forms_keep_the_non_finite_pattern(cuda, form):
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(256, 132, 64, 5))
    V[3, 5] = float("inf")
    A[7, 11] = float("nan")
    Z[2, 40] = float("-inf")
    ref1, ref2 = _FORM_REFS[form]
    W = twy.masked_vt_a_form(V, A, mask, form)
    assert torch.equal(torch.isfinite(W), torch.isfinite(ref1(V, A, mask)))
    Ak = twy.a_minus_vz_masked_form(A.clone(), V, Z, mask, form)
    assert torch.equal(torch.isfinite(Ak),
                       torch.isfinite(ref2(A, V, Z, mask)))


@pytest.mark.cuda
@pytest.mark.parametrize("form", twy.FORMS)
@pytest.mark.parametrize("m,w,c", [(8448, 512, 128), (8448, 512, 8064),
                                   (1000, 1030, 129)],
                         ids=["c128", "c8064", "c129-padded"])
def test_wy_forms_on_a_row_view(cuda, form, m, w, c):
    """K1 and K2 in each form on the row view A[c:] of a contiguous A
    (HQRRP's trailing products from a block's first row c) give bit for
    bit their results on A[c:].clone(), k 512 (a group of 4 blocks of
    128), and leave A[:c] bit for bit as it was; at c·w·4 not a multiple
    of 16 the view goes through the zero-padded copy and back."""
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(m, w, 512, m + c))
    V = V[c:].clone()
    tp = _MODE_OF_FORM[form]
    above = A[:c].clone()
    view = A[c:]
    assert view.is_contiguous()
    assert (view.data_ptr() % 16 == 0) == (c * w % 4 == 0)

    def bits(t):
        return t.view(torch.int32)

    W = twy.masked_vt_a_mixed(V, view, mask, tp)
    assert torch.equal(bits(W), bits(twy.masked_vt_a_mixed(
        V, view.clone(), mask, tp)))
    ref = twy.a_minus_vz_masked_mixed(view.clone(), V, Z, mask, tp)
    twy.a_minus_vz_masked_mixed(view, V, Z, mask, tp)
    assert torch.equal(bits(A[c:]), bits(ref))
    assert torch.equal(bits(A[:c]), bits(above))


@pytest.mark.cuda
def test_wy_forms_refuse_f64_and_cpu_tensors(cuda):
    V, A, Z, mask = (torch.tensor(x, device=cuda)
                     for x in _wy_operands(64, 64, 8, 2))
    with pytest.raises(rt.errors.RandLAPACKError):
        twy.masked_vt_a_form(V, A, mask, "tf32")
    with pytest.raises(rt.errors.RandLAPACKError):
        twy.a_minus_vz_masked_form(A.float().cpu(), V.float().cpu(),
                                   Z.float().cpu(), mask.float().cpu(),
                                   "bf16")


@pytest.mark.cuda
def test_bf16x3_in_f64_takes_the_bf16_form_on_f64_halves(cuda):
    V, A, Z, mask = (torch.tensor(x) for x in _wy_operands(300, 200, 64, 4))
    n0 = dict(twy.LAUNCHES)
    W = twy.masked_vt_a_mixed(V.to(cuda), A.to(cuda), mask.to(cuda),
                              "bf16_3x_emul")
    Wc = twy.masked_vt_a_mixed(V, A, mask, "bf16_3x_emul")
    assert W.dtype == torch.float64
    assert float((W.cpu() - Wc).abs().max()) <= 1e-5 * float(Wc.abs().max())
    Ak = twy.a_minus_vz_masked_mixed(A.to(cuda), V.to(cuda), Z.to(cuda),
                                     mask.to(cuda), "bf16_3x_emul")
    Ac = twy.a_minus_vz_masked_mixed(A.clone(), V, Z, mask, "bf16_3x_emul")
    assert float((Ak.cpu() - Ac).abs().max()) <= 1e-5 * float(Ac.abs().max())
    assert twy.LAUNCHES == {**n0,
                            "masked_vt_a_bf16": n0["masked_vt_a_bf16"] + 3,
                            "a_minus_vz_masked_bf16":
                            n0["a_minus_vz_masked_bf16"] + 3}
    # "high" and "default" in f64 are the f64 kernels of "highest"
    n0 = dict(twy.LAUNCHES)
    for tp in ("high", "default"):
        assert torch.equal(
            twy.masked_vt_a_mixed(V.to(cuda), A.to(cuda), mask.to(cuda), tp),
            twy.masked_vt_a_mixed(V.to(cuda), A.to(cuda), mask.to(cuda)))
    assert twy.LAUNCHES == {**n0, "masked_vt_a": n0["masked_vt_a"] + 4}


# -- the "tf32" form's ring kernels (csrc/wy_ring.cu) ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("R,K", [(300, 77), (128, 32), (1, 1), (8192, 128)])
def test_tf32_tiles_kernel_is_the_plain_pre_pass(cuda, R, K):
    """The pre-pass kernel against ``tf32_tiles_reference`` bit for bit,
    Inf and NaN included, on a matrix and on a transposed view."""
    g = torch.Generator(device=cuda)
    g.manual_seed(R + K)
    X = torch.randn(R, K, generator=g, device=cuda)
    X.view(-1)[::7] *= 1e-39                   # subnormals
    X.view(-1)[3::11] = float("inf")
    X.view(-1)[5::13] = float("nan")
    for Y in (X, X.T):
        got = twy.tf32_tiles(Y).cpu().view(torch.int32)
        want = twy.tf32_tiles_reference(Y.cpu()).view(torch.int32)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,k", [(513, 1028, 200), (3000, 1900, 128),
                                   (8192, 2048, 128), (8192, 1024, 512),
                                   (100, 36, 33)])
def test_tf32_form_kernels_match_plain_and_their_order(cuda, m, w, k):
    """Ragged and HQRRP shapes (b 128; k 128 and 512): the ring kernels
    against the plain versions (1e-5 of the largest entry), against f64
    (at most twice the plain version's error), two launches bit-equal,
    and against the plain version of their order of sums at chunk 1, 0
    (never restarted) and 3 (1e-5)."""
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(m, w, k, m + k))
    W = twy.masked_vt_a_form(V, A, mask, "tf32")
    Wp = twy.masked_vt_a_tf32_reference(V, A, mask)
    assert float((W - Wp).abs().max()) <= 1e-5 * float(Wp.abs().max())
    assert torch.equal(W, twy.masked_vt_a_form(V, A, mask, "tf32"))
    Ak = twy.a_minus_vz_masked_form(A.clone(), V, Z, mask, "tf32")
    Ap = twy.a_minus_vz_masked_tf32_reference(A, V, Z, mask)
    assert float((Ak - Ap).abs().max()) <= 1e-5 * float(Ap.abs().max())
    assert torch.equal(Ak, twy.a_minus_vz_masked_form(A.clone(), V, Z, mask,
                                                      "tf32"))
    Vd, Ad, Zd, md = (t.double() for t in (V, A, Z, mask))
    ref = Vd.T @ (Ad * md)
    assert _relf(W, ref) <= 2 * max(_relf(Wp, ref), 2.0 ** -24)
    ref = Ad - (Vd @ Zd) * md
    assert _relf(Ak, ref) <= 2 * max(_relf(Ap, ref), 2.0 ** -24)
    splits = twy.masked_vt_a_splits(m, k, w, twy._sm_count(cuda.index or 0))
    for chunk in (1, 0, 3):
        W = twy.masked_vt_a_form(V, A, mask, "tf32", chunk=chunk)
        We = twy.masked_vt_a_tf32_order_reference(V, A, mask, splits, chunk)
        assert float((W - We).abs().max()) <= 1e-5 * float(We.abs().max())
        Ak = twy.a_minus_vz_masked_form(A.clone(), V, Z, mask, "tf32",
                                        chunk=chunk)
        Ae = twy.a_minus_vz_masked_tf32_order_reference(A, V, Z, mask, chunk)
        assert float((Ak - Ae).abs().max()) <= 1e-5 * float(Ae.abs().max())


@pytest.mark.cuda
def test_tf32_form_zero_mask_over_inf_gives_nan(cuda):
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(300, 132, 40, 9))
    dead = int(torch.nonzero(mask == 0)[0])
    live = int(torch.nonzero(mask == 1)[0])
    A[7, dead] = float("inf")
    A[9, live] = float("-inf")
    Z[3, dead] = float("inf")
    W = twy.masked_vt_a_form(V, A, mask, "tf32")
    assert bool(torch.isnan(W[:, dead]).all())
    assert torch.equal(torch.isfinite(W), torch.isfinite(
        twy.masked_vt_a_tf32_reference(V, A, mask)))
    Ak = twy.a_minus_vz_masked_form(A.clone(), V, Z, mask, "tf32")
    assert bool(torch.isnan(Ak[:, dead]).all())
    assert torch.equal(torch.isfinite(Ak), torch.isfinite(
        twy.a_minus_vz_masked_tf32_reference(A, V, Z, mask)))


@pytest.mark.cuda
def test_tf32_form_entry_points_refuse_misaligned_operands(cuda):
    """A misaligned A, or a row length w that is not a multiple of 4, is
    refused by the entry points (the launch raises); the wrappers hand
    them zero-padded aligned copies instead."""
    from randlapack_tpu_torch import _build
    m, w, k, b = 64, 36, 16, 8
    buf = torch.zeros(m * w + 1, device=cuda)
    A_bad = buf[1:].view(m, w)                 # 4 bytes off alignment
    V = torch.randn(m, k, device=cuda)
    Z = torch.randn(k, w, device=cuda)
    mask = torch.ones(w, device=cuda)
    vr = torch.empty(twy._tiles_floats(m, k), device=cuda)
    zt = torch.empty(twy._tiles_floats(w, k), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.call("rl_a_minus_vz_masked_tf32", A_bad, A_bad, V, Z, mask,
                    vr, zt, m, k, w, 1)
    A = torch.randn(m, w - 1, device=cuda)     # w % 4 != 0
    W = torch.empty(b, w - 1, device=cuda)
    vt = torch.empty(twy._tiles_floats(b, m), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.call("rl_masked_vt_a_tf32", W, torch.randn(m, b, device=cuda),
                    A, mask[:w - 1], W, W, vt, m, b, w - 1, 1, 1)
    # through the wrapper, the same operands are padded and taken
    Wk = twy.masked_vt_a_form(torch.randn(m, b, device=cuda), A_bad,
                              mask, "tf32")
    assert Wk.shape == (b, w) and bool(torch.isfinite(Wk).all())


@pytest.mark.cuda
def test_high_mode_launches_the_ring_kernels_not_the_earlier_form(cuda):
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(512, 256, 64, 4))
    n0 = dict(twy.LAUNCHES)
    W = twy.masked_vt_a_mixed(V, A, mask, "high")
    twy.a_minus_vz_masked_mixed(A.clone(), V, Z, mask, "high")
    assert twy.LAUNCHES == {**n0,
                            "masked_vt_a_tf32": n0["masked_vt_a_tf32"] + 1,
                            "a_minus_vz_masked_tf32":
                            n0["a_minus_vz_masked_tf32"] + 1}
    # the earlier form stays reachable under its own name and count
    n0 = dict(twy.LAUNCHES)
    Wr = twy.masked_vt_a_form(V, A, mask, "tf32_wy")
    twy.a_minus_vz_masked_form(A.clone(), V, Z, mask, "tf32_wy")
    assert twy.LAUNCHES == {
        **n0, "masked_vt_a_tf32_wy": n0["masked_vt_a_tf32_wy"] + 1,
        "a_minus_vz_masked_tf32_wy": n0["a_minus_vz_masked_tf32_wy"] + 1}
    assert float((W - Wr).abs().max()) <= 1e-5 * float(Wr.abs().max())


# residual gates of the f32 drivers in each mode (PERF.md §2): twice the
# unit roundoff of the operands the mode's trailing products round to,
# TF32 2⁻¹¹, bf16 2⁻⁸, and for three bf16 products the dropped lo·lo term,
# 2⁻¹⁶ (an operand rounded once errs by up to u, uniformly, so a product of
# two by about 0.8·u, which the first trailing updates leave in R)
_MODE_RES = {"high": 2 * 2.0 ** -11, "default": 2 * 2.0 ** -8,
             "bf16_3x_emul": 2 * 2.0 ** -16}


@pytest.mark.cuda
@pytest.mark.parametrize("tp", ["high", "default", "bf16_3x_emul"])
def test_drivers_take_their_mode_forms(cuda, tp):
    """bqrrp_factored, the explicit bqrrp and hqrrp in f32 launch their
    mode's K1/K2 forms (5 K1 and 3 K2 at 5 blocks in groups of 2) and no
    "highest" K1/K2, with ``fail`` False and the residual within the
    mode's gate."""
    form = {"high": "tf32", "default": "bf16"}.get(tp, "bf16x3")
    A, st = rt.gen.fast_decay_matrix(640, 320, rt.RNGState(3), device=cuda)
    zero = dict.fromkeys(twy.LAUNCHES, 0)
    cfgs = (
        (lambda: bqrrp_factored(A, BQRRPConfig(
            block_size=64, pivot_candidates=2, update_defer=2,
            trailing_precision=tp), st)[0], 5, 3),
        (lambda: bqrrp(A, BQRRPConfig(
            block_size=64, update_defer=2, trailing_precision=tp), st),
         0, 3),
        (lambda: hqrrp(A, HQRRPConfig(block_size=64, update_defer=2,
                                      trailing_precision=tp), st), 5, 3),
        (lambda: hqrrp(A, HQRRPConfig(block_size=64, update_defer=1,
                                      trailing_precision=tp), st), 5, 5))
    for run, k1, k2 in cfgs:
        twy.LAUNCHES.update(zero)
        out = run()
        torch.cuda.synchronize()
        assert twy.LAUNCHES == {**zero, f"masked_vt_a_{form}": k1,
                                f"a_minus_vz_masked_{form}": k2}
        if hasattr(out, "V"):                 # the factored form
            Q, R, J, fail = bqrrp_q(out), out.R, out.J, out.fail
        else:
            Q, R, J, _, fail, _ = out
        res = float(torch.linalg.norm(Q @ R - A[:, J]) / torch.linalg.norm(A))
        assert not bool(fail) and res <= _MODE_RES[tp], res


# -- K2's bf16 forms on the ring kernel (csrc/wy_ring.cu) --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("R,K", [(300, 77), (128, 32), (1, 1), (8192, 128)])
def test_bf16_tiles_kernel_is_the_plain_pre_pass(cuda, R, K, split):
    """The bf16 pre-pass kernel against ``bf16_tiles_reference`` bit for
    bit (hi tiles, and hi and lo tiles), subnormals, Inf and NaN included,
    on a matrix and on a transposed view."""
    g = torch.Generator(device=cuda)
    g.manual_seed(R + K)
    X = torch.randn(R, K, generator=g, device=cuda)
    X.view(-1)[::7] *= 1e-39                   # subnormals
    X.view(-1)[3::11] = float("inf")
    X.view(-1)[5::13] = float("nan")
    X.view(-1)[9::17] = torch.finfo(torch.float32).max   # rounds up to Inf
    n0 = dict(twy.LAUNCHES)
    for Y in (X, X.T):
        got = twy.bf16_tiles(Y, split).cpu().view(torch.int16)
        want = twy.bf16_tiles_reference(Y.cpu(), split).view(torch.int16)
        assert torch.equal(got, want)
    assert twy.LAUNCHES == {**n0, "bf16_tiles": n0["bf16_tiles"] + 2}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bf16", "bf16x3"])
@pytest.mark.parametrize("m,w,k", [(513, 1028, 1), (100, 36, 33),
                                   (3000, 1900, 128), (8192, 1024, 512),
                                   (640, 1025, 1024)])
def test_bf16_ring_forms_match_plain_and_their_order(cuda, form, m, w, k):
    """Ragged m, w, k (k 1, 33, 128, 512, 1024; w 1025 through the padded
    copy): the ring kernel against the plain version (1e-5 of the largest
    entry), against f64 (at most twice the plain version's error), two
    launches bit-equal, and against the plain version of its order of sums
    at chunk 1, 0 (never restarted) and 3 (1e-5)."""
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(m, w, k, m + k))
    plain = getattr(twy, f"a_minus_vz_masked_{form}_reference")
    order = getattr(twy, f"a_minus_vz_masked_{form}_order_reference")
    n0 = dict(twy.LAUNCHES)
    Ak = twy.a_minus_vz_masked_form(A.clone(), V, Z, mask, form)
    Ap = plain(A, V, Z, mask)
    assert float((Ak - Ap).abs().max()) <= 1e-5 * float(Ap.abs().max())
    assert torch.equal(Ak, twy.a_minus_vz_masked_form(A.clone(), V, Z, mask,
                                                      form))
    assert twy.LAUNCHES == {**n0, f"a_minus_vz_masked_{form}":
                            n0[f"a_minus_vz_masked_{form}"] + 2}
    Vd, Ad, Zd, md = (t.double() for t in (V, A, Z, mask))
    ref = Ad - (Vd @ Zd) * md
    assert _relf(Ak, ref) <= 2 * max(_relf(Ap, ref), 2.0 ** -24)
    for chunk in (1, 0, 3):
        Ak = twy.a_minus_vz_masked_form(A.clone(), V, Z, mask, form,
                                        chunk=chunk)
        Ae = order(A, V, Z, mask, chunk)
        assert float((Ak - Ae).abs().max()) <= 1e-5 * float(Ae.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bf16", "bf16x3"])
def test_bf16_ring_forms_zero_mask_over_inf_gives_nan(cuda, form):
    """Inf and NaN in A, V and Z: the plain version's finite/non-finite
    pattern; a mask of 0 over Inf gives NaN, as A ⊙ mask does."""
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(300, 132, 40, 9))
    dead = int(torch.nonzero(mask == 0)[0])
    live = int(torch.nonzero(mask == 1)[0])
    A[7, dead] = float("inf")
    A[9, live] = float("-inf")
    A[11, 3] = float("nan")
    Z[3, dead] = float("inf")
    V[5, 6] = float("-inf")
    Ak = twy.a_minus_vz_masked_form(A.clone(), V, Z, mask, form)
    assert bool(torch.isnan(Ak[:, dead]).all())
    assert torch.equal(torch.isfinite(Ak), torch.isfinite(
        getattr(twy, f"a_minus_vz_masked_{form}_reference")(A, V, Z, mask)))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bf16", "bf16x3"])
def test_bf16_ring_entry_points_refuse_misaligned_operands(cuda, form):
    """A misaligned A, or w % 4, is refused by the entry point (the launch
    raises); the wrapper hands it a zero-padded aligned copy instead."""
    from randlapack_tpu_torch import _build
    m, w, k = 64, 36, 16
    sets = twy._RING_SETS[form]
    buf = torch.zeros(m * w + 1, device=cuda)
    A_bad = buf[1:].view(m, w)                 # 4 bytes off alignment
    V = torch.randn(m, k, device=cuda)
    Z = torch.randn(k, w, device=cuda)
    mask = torch.ones(w, device=cuda)
    vr = torch.empty(twy._tiles_floats(m, k) * sets, dtype=torch.bfloat16,
                     device=cuda)
    zt = torch.empty(twy._tiles_floats(w, k) * sets, dtype=torch.bfloat16,
                     device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.call(twy.FORM_KERNELS[form][1], A_bad, A_bad, V, Z, mask, vr,
                    zt, m, k, w, 1)
    A3 = torch.randn(m, w - 1, device=cuda)    # w % 4 != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.call(twy.FORM_KERNELS[form][1], A3, A3, V, Z[:, :w - 1],
                    mask[:w - 1], vr, zt, m, k, w - 1, 1)
    want = getattr(twy, f"a_minus_vz_masked_{form}_reference")(
        A_bad.clone(), V, Z, mask)
    got = twy.a_minus_vz_masked_form(A_bad, V, Z, mask, form)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tp,form", [("default", "bf16"),
                                     ("bf16_3x_emul", "bf16x3")])
def test_bf16_modes_launch_the_ring_kernel_not_the_earlier_form(cuda, tp,
                                                                form):
    V, A, Z, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(512, 256, 64, 4))
    n0 = dict(twy.LAUNCHES)
    W = twy.masked_vt_a_mixed(V, A, mask, tp)
    Ak = twy.a_minus_vz_masked_mixed(A.clone(), V, Z, mask, tp)
    assert twy.LAUNCHES == {**n0, f"masked_vt_a_{form}":
                            n0[f"masked_vt_a_{form}"] + 1,
                            f"a_minus_vz_masked_{form}":
                            n0[f"a_minus_vz_masked_{form}"] + 1}
    # the earlier forms stay reachable as the yardsticks of both kernels,
    # under their own names and counts
    n0 = dict(twy.LAUNCHES)
    Wr = twy.masked_vt_a_form(V, A, mask, f"{form}_wy")
    Ar = twy.a_minus_vz_masked_form(A.clone(), V, Z, mask, f"{form}_wy")
    assert twy.LAUNCHES == {
        **n0, f"masked_vt_a_{form}_wy": n0[f"masked_vt_a_{form}_wy"] + 1,
        f"a_minus_vz_masked_{form}_wy":
        n0[f"a_minus_vz_masked_{form}_wy"] + 1}
    assert float((W - Wr).abs().max()) <= 1e-5 * float(Wr.abs().max())
    assert float((Ak - Ar).abs().max()) <= 1e-5 * float(Ar.abs().max())


# -- K1's bf16 forms on the ring kernel (csrc/wy_ring.cu) --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("m,b", [(8192, 256), (300, 72), (8192, 128)])
def test_k1_bf16_pre_pass_of_vt_is_the_plain_one(cuda, m, b, split):
    """K1's operand: the bf16 pre-pass of Vᵀ (a transposed view of V, b
    rows by m of the reduction) against ``bf16_tiles_reference`` bit for
    bit, Inf and NaN included."""
    g = torch.Generator(device=cuda)
    g.manual_seed(m + b)
    V = torch.randn(m, b, generator=g, device=cuda)
    V.view(-1)[3::101] = float("inf")
    V.view(-1)[5::103] = float("nan")
    got = twy.bf16_tiles(V.T, split).cpu().view(torch.int16)
    want = twy.bf16_tiles_reference(V.T.cpu(), split).view(torch.int16)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bf16", "bf16x3"])
@pytest.mark.parametrize("m,w,b", [(300, 132, 72), (1000, 36, 200),
                                   (33, 4, 5), (520, 260, 130), (1, 4, 1),
                                   (8192, 1024, 256), (8192, 2048, 128),
                                   (3000, 1025, 64)])
def test_k1_bf16_ring_forms_match_plain_and_their_order(cuda, form, m, w, b):
    """The CPU tests' shapes (ragged m, w % 4 == 0, b off 128), the main
    path's and HQRRP's (b 256, 128; split reductions) and w 1025 through
    the padded copy: K1's ring form against its plain version (1e-5 of
    the largest entry), against f64 (at most twice the plain version's
    error), two launches bit-equal, and against the plain version of its
    order of sums at chunk 1, 0 (never restarted) and 3 (1e-5)."""
    V, A, _, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(m, w, b, m + b))
    plain = getattr(twy, f"masked_vt_a_{form}_reference")
    order = getattr(twy, f"masked_vt_a_{form}_order_reference")
    n0 = dict(twy.LAUNCHES)
    W = twy.masked_vt_a_form(V, A, mask, form)
    Wp = plain(V, A, mask)
    assert float((W - Wp).abs().max()) <= 1e-5 * float(Wp.abs().max())
    assert torch.equal(W, twy.masked_vt_a_form(V, A, mask, form))
    assert twy.LAUNCHES == {**n0, f"masked_vt_a_{form}":
                            n0[f"masked_vt_a_{form}"] + 2}
    ref = V.double().T @ (A.double() * mask.double())
    assert _relf(W, ref) <= 2 * max(_relf(Wp, ref), 2.0 ** -24)
    splits = twy.masked_vt_a_splits(m, b, -(-w // 4) * 4,
                                    twy._sm_count(cuda.index or 0))
    for chunk in (1, 0, 3):
        W = twy.masked_vt_a_form(V, A, mask, form, chunk=chunk)
        We = order(V, A, mask, splits, chunk)
        assert float((W - We).abs().max()) <= 1e-5 * float(We.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bf16", "bf16x3"])
def test_k1_bf16_ring_forms_zero_mask_over_inf_gives_nan(cuda, form):
    """Inf and NaN in A and V: the plain version's finite/non-finite
    pattern; a mask of 0 over Inf gives NaN, as A ⊙ mask does."""
    V, A, _, mask = (torch.tensor(x, dtype=torch.float32, device=cuda)
                     for x in _wy_operands(300, 132, 40, 9))
    dead = int(torch.nonzero(mask == 0)[0])
    live = int(torch.nonzero(mask == 1)[0])
    A[7, dead] = float("inf")
    A[9, live] = float("-inf")
    A[11, 3] = float("nan")
    V[5, 6] = float("-inf")
    W = twy.masked_vt_a_form(V, A, mask, form)
    assert bool(torch.isnan(W[:, dead]).all())
    assert torch.equal(torch.isfinite(W), torch.isfinite(
        getattr(twy, f"masked_vt_a_{form}_reference")(V, A, mask)))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bf16", "bf16x3"])
def test_k1_bf16_ring_entry_points_refuse_misaligned_operands(cuda, form):
    """A misaligned A, or w % 4, is refused by the entry point (the launch
    raises); the wrapper hands it a zero-padded aligned copy instead."""
    from randlapack_tpu_torch import _build
    m, w, b = 64, 36, 8
    vt = torch.empty(twy._tiles_floats(b, m) * twy._RING_SETS[form],
                     dtype=torch.bfloat16, device=cuda)
    buf = torch.zeros(m * w + 1, device=cuda)
    A_bad = buf[1:].view(m, w)                 # 4 bytes off alignment
    A_bad.copy_(torch.randn(m, w, device=cuda))
    V = torch.randn(m, b, device=cuda)
    mask = torch.ones(w, device=cuda)
    W = torch.empty(b, w, device=cuda)
    name = twy.FORM_KERNELS[form][0]
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.call(name, W, V, A_bad, mask, W, W, vt, m, b, w, 1, 1)
    A3 = torch.randn(m, w - 1, device=cuda)    # w % 4 != 0
    W3 = torch.empty(b, w - 1, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.call(name, W3, V, A3, mask[:w - 1], W3, W3, vt, m, b, w - 1,
                    1, 1)
    want = getattr(twy, f"masked_vt_a_{form}_reference")(V, A_bad, mask)
    got = twy.masked_vt_a_form(V, A_bad, mask, form)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tp,form", [("default", "bf16"),
                                     ("bf16_3x_emul", "bf16x3")])
def test_speed_modes_at_8192_launch_the_ring_forms(cuda, tp, form):
    """bench.py's speed modes at 8192² f32 (BQRRP b 256, 2 candidates, 2
    stages, defer 4; HQRRP b 128, defer 4): K2's form 8 and 16 times, K1's
    32 and 64, no earlier ("_wy") form and no "highest" K1/K2; ``fail``
    False and R finite."""
    A, st = rt.gen.fast_decay_matrix(8192, 8192, rt.RNGState(0),
                                     device=cuda)
    zero = dict.fromkeys(twy.LAUNCHES, 0)
    runs = (
        (lambda: bqrrp_factored(A, BQRRPConfig(
            block_size=256, pivot_candidates=2, stages=2, update_defer=4,
            trailing_precision=tp), st)[0], 32, 8),
        (lambda: hqrrp(A, HQRRPConfig(block_size=128, update_defer=4,
                                      trailing_precision=tp), st), 64, 16))
    for run, k1, k2 in runs:
        twy.LAUNCHES.update(zero)
        out = run()
        torch.cuda.synchronize()
        assert twy.LAUNCHES == {**zero, f"masked_vt_a_{form}": k1,
                                f"a_minus_vz_masked_{form}": k2}
        R, fail = (out.R, out.fail) if hasattr(out, "R") else (out[1],
                                                               out[4])
        assert not bool(fail) and bool(torch.isfinite(R).all())


# -- the driver-level precision= ------------------------------------------

def _tf32_trunc(t):
    """t (float32) with the low 13 mantissa bits cleared."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_rne(t):
    """t (float32) rounded to TF32, to nearest, ties to even."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF).view(
        torch.float32)


@pytest.mark.cuda
def test_precision_matmul_rounds_as_its_mode(cuda):
    """``ops.util.matmul`` on 1000×700 · 700×900 f32 (and on column-major
    views, and a vector): "high" within fp32 summation error (16·√k units
    of fp32 roundoff, relative Frobenius) of the f64 product of the
    operands rounded to TF32 to nearest even, as cuBLAS rounds them
    (truncation and the exact product are both ~1e-4 away); for one
    column the library takes its fp32 path, within the same bound of the
    exact product. "default" matches the operands rounded to bf16 to
    nearest even; "highest" and f64 are ``@`` bit for bit; the TF32
    switches read as before every call."""
    from randlapack_tpu_torch.ops import util
    g = torch.Generator(device=cuda).manual_seed(0)
    X = torch.randn((1000, 700), generator=g, device=cuda)
    Y = torch.randn((700, 900), generator=g, device=cuda)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    bound = 16 * 700 ** 0.5 * 2.0 ** -24

    def f64_of(r, a, b):
        return r(a).double() @ r(b).double()

    # row-major, column-major views (the transposes of contiguous
    # tensors) on either side, and a vector
    for a, b in ((X, Y), (X.T.contiguous().T, Y), (X, Y.T.contiguous().T),
                 (X, Y[:, 0])):
        hi = util.matmul(a, b, "high")
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision()) == before
        exact = _relf(hi, a.double() @ b.double())
        if b.dim() == 1:
            assert exact <= bound
        else:
            assert _relf(hi, f64_of(_tf32_rne, a, b)) <= bound
            assert min(exact, _relf(hi, f64_of(_tf32_trunc, a, b))) \
                > 10 * bound                # the check tells them apart
        lo = util.matmul(a, b, "default")
        bf = f64_of(lambda t: t.to(torch.bfloat16).float(), a, b)
        assert _relf(lo, bf) <= bound
        assert torch.equal(util.matmul(a, b, "highest"), a @ b)
        assert torch.equal(util.matmul(a.double(), b.double(), "high"),
                           a.double() @ b.double())
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision()) == before


@pytest.mark.cuda
def test_grad_through_qb_and_rsvd_on_the_card(cuda):
    """QB's loss ‖A − QB‖²_F and RSVD's Σ S[:4] at the CPU tests' f64
    shapes (96×64, k 32, block 16): the card's gradient (cuBLAS and
    cuSOLVER, no kernel) within 1e-8 relative of the CPU's on the same
    starts."""
    from randlapack_tpu_torch.comps import QBConfig, qb_blocked
    from randlapack_tpu_torch.drivers import RSVDConfig, rsvd_fixed_rank
    rng = np.random.default_rng(0)
    A = rng.standard_normal((96, 64)) * np.logspace(0, -2, 64)
    om = [rng.standard_normal((64, 16)) for _ in range(2)]

    def grads(dev):
        oms = [torch.tensor(o, device=dev) for o in om]

        def loss_qb(a):
            Q, B = qb_blocked(a, 32, QBConfig(block_size=16), rt.RNGState(1),
                              omegas=oms)[:2]
            return torch.sum((a - Q @ B) ** 2)

        def loss_rsvd(a):
            return torch.sum(rsvd_fixed_rank(
                a, 16, RSVDConfig(QBConfig(block_size=16)), rt.RNGState(2),
                omegas=oms[:1])[1][:4])

        out = []
        for loss in (loss_qb, loss_rsvd):
            At = torch.tensor(A, device=dev, requires_grad=True)
            loss(At).backward()
            out.append(At.grad.cpu())
        return out

    for g_card, g_cpu in zip(grads(cuda), grads("cpu")):
        assert _relf(g_card, g_cpu.double()) <= 1e-8


@pytest.mark.cuda
def test_kernel_paths_refuse_grad_and_vmap_on_the_card(cuda):
    """HQRRP (K5/K6) and BQRRP (K1–K3) on a CUDA tensor that requires
    grad raise instead of handing back a detached result; under
    ``torch.func.vmap`` (the sketches injected, one for the batch) they
    raise too."""
    from randlapack_tpu_torch.errors import RandLAPACKError
    A = torch.randn((64, 48), device=cuda)
    G = torch.rand((26, 64), device=cuda) * 2 - 1
    S = torch.randn((20, 64), device=cuda) / 20 ** 0.5
    for run in (lambda a: hqrrp(a, HQRRPConfig(block_size=16),
                                rt.RNGState(0), sketch=G)[1],
                lambda a: bqrrp_factored(a, BQRRPConfig(block_size=16),
                                         rt.RNGState(0), sketch=S)[0].R):
        with pytest.raises(RandLAPACKError, match="autograd"):
            run(A.clone().requires_grad_(True))
        with pytest.raises(RandLAPACKError, match="vmap"):
            torch.func.vmap(run)(torch.stack([A, A]))


# -- the distributed layer on the card (randlapack_tpu_torch.parallel) --------

def _ranks():
    import _torch_parallel_ranks
    return _torch_parallel_ranks


@pytest.mark.cuda
def test_dist_bqrrp_factored_two_gloo_ranks_on_one_card(cuda):
    """Two gloo ranks share cuda:0 (NCCL refuses two ranks on one device):
    each launches K1, K2 and K3 once a block on its 512 rows, and the
    factorization holds the f32 gates of tests/test_bqrrp_factored.py."""
    from randlapack_tpu_torch.parallel import run_ranks
    m, n, b = 1024, 512, 64
    out = run_ranks(_ranks().cuda_bqrrp_body, 2, m, n, b, backend="gloo",
                    device="cuda", timeout=300)
    eps = float(np.finfo(np.float32).eps)
    for r in out:
        c = r["counts"]
        assert (c["masked_vt_a"], c["a_minus_vz_masked"], c["getrfnp"]) \
            == (n // b,) * 3
        assert r["res"] <= 10 * eps ** 0.75
        assert r["orth"] <= 10 * eps ** 0.75 * np.sqrt(n)
        assert not r["fail"]
        assert np.array_equal(r["R"], out[0]["R"])
        assert np.array_equal(r["J"], out[0]["J"])
        assert sorted(r["J"].tolist()) == list(range(n))


def _spread_columns(m, n, seed, dtype=np.float64):
    """A Gaussian m×n matrix with exp(-3·U) column scaling (pivots well
    above rounding level) as numpy."""
    g = np.random.default_rng(seed)
    return (g.standard_normal((m, n))
            * np.exp(-3.0 * g.random(n))).astype(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,launches", [
    ("hqrrp", {"qrcp_select_pivots": 6, "qrcp_panel": 6, "getrfnp": 0}),
    ("hqrrp_cholqr", {"qrcp_select_pivots": 6, "qrcp_panel": 0,
                      "getrfnp": 6})])
def test_dist_hqrrp_two_gloo_ranks_on_one_card(cuda, entry, launches):
    """The row-sharded HQRRP in f64 on two gloo ranks of one card: each
    rank launches K5 and K6 (or, with CholQR panels, K5 and K3) once a
    block, and Q's rows, R and J agree with the plain versions' (the port
    on the CPU, the same G) within 1e-10 of the largest entry."""
    from randlapack_tpu_torch.drivers import HQRRPConfig, PanelQR, hqrrp
    from randlapack_tpu_torch.parallel import run_ranks
    m, n = 256, 192
    A = _spread_columns(m, n, 3)
    G = np.random.default_rng(4).uniform(-1.0, 1.0, (42, m))
    out = run_ranks(_ranks().cuda_qr_body, 2, entry, A, G, backend="gloo",
                    device="cuda", timeout=300)
    panel = PanelQR.cholqr if entry == "hqrrp_cholqr" else PanelQR.qrcp
    Q, R, J, _, fail, _ = hqrrp(torch.from_numpy(A), HQRRPConfig(
        block_size=32, panel_qr=panel), rt.RNGState(3),
        sketch=torch.from_numpy(G))
    for r in out:
        assert {k: r["counts"][k] for k in launches} == launches
        assert np.array_equal(r["R"], out[0]["R"])
        assert np.array_equal(r["J"], out[0]["J"])
        assert not r["fail"]
    np.testing.assert_array_equal(out[0]["J"], J.numpy())
    Qd = np.concatenate([r["Q"] for r in out])
    for x, ref in ((Qd, Q.numpy()), (out[0]["R"], R.numpy())):
        assert np.abs(x - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.cuda
def test_dist_bqrrp_high_two_gloo_ranks_on_one_card(cuda):
    """The row-sharded explicit BQRRP in the "high" mode, f32, on two gloo
    ranks of one card: each rank launches K2·TF32 once a block (and no
    other K1/K2 form), the factorization holds the mode's residual gate
    (2·2⁻¹¹) and f32 orthogonality, R and J the same on both ranks, and
    J agrees with the single-process card run on the leading half."""
    from randlapack_tpu_torch.drivers import bqrrp
    from randlapack_tpu_torch.parallel import run_ranks
    m, n = 1024, 512
    A = _spread_columns(m, n, 5, np.float32)
    S = (np.random.default_rng(6).standard_normal((80, m))
         / np.sqrt(80)).astype(np.float32)
    out = run_ranks(_ranks().cuda_qr_body, 2, "bqrrp_high", A, S,
                    backend="gloo", device="cuda", timeout=300)
    eps = float(np.finfo(np.float32).eps)
    At = torch.from_numpy(A).to(cuda)
    _, _, J1, _, _, _ = bqrrp(At, BQRRPConfig(
        block_size=64, trailing_precision="high"), rt.RNGState(3),
        sketch=torch.from_numpy(S).to(cuda))
    for r in out:
        c = r["counts"]
        assert c["a_minus_vz_masked_tf32"] == n // 64
        assert sum(v for k, v in c.items() if k.startswith(
            ("masked_vt_a", "a_minus_vz_masked"))) == n // 64
        assert np.array_equal(r["R"], out[0]["R"])
        assert np.array_equal(r["J"], out[0]["J"])
        assert not r["fail"]
    Q = np.concatenate([r["Q"] for r in out]).astype(np.float64)
    R, J = out[0]["R"].astype(np.float64), out[0]["J"]
    res = np.linalg.norm(Q @ R - A[:, J].astype(np.float64)) \
        / np.linalg.norm(A.astype(np.float64))
    assert res <= 2 * 2.0 ** -11
    assert np.linalg.norm(Q.T @ Q - np.eye(n)) <= 10 * eps ** 0.75 \
        * np.sqrt(n)
    np.testing.assert_array_equal(J[:n // 2], J1.cpu().numpy()[:n // 2])


@pytest.mark.cuda
def test_dist_abrik_two_gloo_ranks_on_one_card(cuda):
    """dist_abrik in f64 on two gloo ranks of one card (no kernel), k 12
    of a 64-column Krylov space: S bit-equal on both ranks and within
    1e-10·σ₀ of the port's single-process abrik on the CPU with the same
    draws injected, U's rows and Vt within 1e-9 after sign alignment
    (test_abrik_on_the_card_f64_against_the_cpu's gates)."""
    from randlapack_tpu_torch.drivers import ABRIKConfig, abrik
    from randlapack_tpu_torch.parallel import run_ranks
    m, n = 256, 128
    g = np.random.default_rng(7)
    A = (g.standard_normal((m, n)) * np.exp(-np.arange(n) / 4.0))
    v0 = g.standard_normal((n, 16))
    sk = [None if i == 1 else g.standard_normal(
        (20, m if i == 0 or i % 2 else n)) for i in range(8)]
    out = run_ranks(_ranks().cuda_abrik_body, 2, A, v0, sk, backend="gloo",
                    device="cuda", timeout=300)
    U, S, Vt, info, _ = abrik(
        torch.from_numpy(A), 12, ABRIKConfig(block_size=16, max_iters=4,
                                             qr_explicit="cqrrt"),
        rt.RNGState(8), v0=torch.from_numpy(v0),
        qr_sketches=[None if x is None else torch.from_numpy(x)
                     for x in sk])
    for r in out:
        assert not any(r["counts"].values())
        assert np.array_equal(r["S"], out[0]["S"])
        assert r["iters"] == info["num_krylov_iters"]
    Ud = np.concatenate([r["U"] for r in out])
    sv = np.sign(np.sum(out[0]["Vt"] * Vt.numpy(), axis=1))
    su = np.sign(np.sum(Ud * U.numpy(), axis=0))
    assert np.abs(out[0]["S"] - S.numpy()).max() <= 1e-10 * float(S[0])
    assert np.abs(out[0]["Vt"] * sv[:, None] - Vt.numpy()).max() <= 1e-9
    assert np.abs(Ud * su[None, :] - U.numpy()).max() <= 1e-9


@pytest.mark.cuda
def test_dist_cholqr_one_nccl_rank(cuda):
    from randlapack_tpu_torch.parallel import run_ranks
    out, = run_ranks(_ranks().cuda_cholqr_body, 1, 8192, 128,
                     backend="nccl", device="cuda", timeout=300)
    eps = float(np.finfo(np.float32).eps)
    assert out["backend"] == "nccl" and not out["fail"]
    assert out["res"] <= 10 * eps ** 0.75
    assert out["orth"] <= 10 * eps ** 0.75 * np.sqrt(128)


# -- ops.qr.lu_factor: cuSOLVER's getrf through csrc/getrf.cu ------------------

def _switched_lu(A):
    """The LU as lu_factor took it before its binding: the process-wide
    backend switched to cuSOLVER around lu_factor_ex."""
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return torch.linalg.lu_factor_ex(A)
    finally:
        torch.backends.cuda.preferred_linalg_library("default")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(8192, 320), (4096, 320), (256, 320),
                                   (4096, 64), (1024, 1024), (7, 3)])
def test_lu_factor_is_the_switched_route_bit_for_bit(cuda, dtype, shape):
    """The BQRRP headline's pivot-pass panels (b 256, d 320: the first, a
    middle and the last, wide, block), PLU stabilization's RSVD shape, a
    square and a tiny one: LU, pivots and info bit-equal to lu_factor_ex
    under the cuSOLVER preference, which lu_factor leaves at "default"."""
    A = torch.tensor(np.random.default_rng(sum(shape)).standard_normal(
        shape), dtype=dtype, device=cuda)
    A[:, 1] = 0.0                      # a zero pivot column: info > 0
    LU, piv, info = tqr.lu_factor(A)
    ref = _switched_lu(A)
    assert LU.shape == ref[0].shape and piv.dtype == torch.int32
    for got, want in zip((LU, piv, info), ref):
        assert torch.equal(got, want)
    assert int(info) == int(ref[2]) > 0
    assert torch.backends.cuda.preferred_linalg_library() \
        == torch._C._LinalgBackend.Default


@pytest.mark.cuda
def test_lu_factor_leaves_the_backend_setting_to_other_threads(cuda):
    """A thread reading preferred_linalg_library() during 100 calls sees
    "default" throughout; a backend the caller chose still stands."""
    import threading
    A = torch.randn((8192, 320), device=cuda)
    seen, stop = set(), threading.Event()

    def watch():
        while not stop.is_set():
            seen.add(torch.backends.cuda.preferred_linalg_library())

    reader = threading.Thread(target=watch)
    reader.start()
    try:
        for _ in range(100):
            tqr.lu_factor(A)
        torch.cuda.synchronize()
    finally:
        stop.set()
        reader.join(timeout=60)
    assert not reader.is_alive()
    assert seen == {torch._C._LinalgBackend.Default}
    torch.backends.cuda.preferred_linalg_library("magma")
    try:
        assert all(torch.equal(a, b) for a, b in zip(
            tqr.lu_factor(A), torch.linalg.lu_factor_ex(A)))
    finally:
        torch.backends.cuda.preferred_linalg_library("default")


@pytest.mark.cuda
def test_lu_factor_gradient_and_vmap_on_the_card(cuda):
    """The binding's backward (ops.qr.lu_factor_backward) against the
    CPU's lu_factor_ex gradient, tall and wide; vmap raises."""
    from randlapack_tpu_torch.errors import RandLAPACKError
    rng = np.random.default_rng(5)
    for shape in ((40, 12), (12, 40)):
        A0, G = rng.standard_normal(shape), rng.standard_normal(shape)
        grads = []
        for dev, lu in ((cuda, tqr.lu_factor),
                        ("cpu", torch.linalg.lu_factor_ex)):
            A = torch.tensor(A0, device=dev, requires_grad=True)
            (lu(A)[0] * torch.tensor(G, device=dev)).sum().backward()
            grads.append(A.grad.cpu())
        assert _relf(grads[0], grads[1]) <= 1e-12
    with pytest.raises(RandLAPACKError, match="vmap"):
        torch.func.vmap(tqr.lu_factor)(torch.randn((2, 8, 4), device=cuda))


@pytest.mark.cuda
def test_bqrrp_headline_pivots_unchanged_by_the_lu_binding(cuda,
                                                           monkeypatch):
    """The BQRRP headline (8192², b 256, 2 candidates, 2 stages, defer 4)
    chooses the same J with the pivot pass's LU through the binding as
    through the switched route."""
    A, st = rt.gen.fast_decay_matrix(8192, 8192, rt.RNGState(0),
                                     dtype=torch.float32, device=cuda)
    cfg = BQRRPConfig(block_size=256, pivot_candidates=2, stages=2,
                      update_defer=4)
    fac, _ = bqrrp_factored(A, cfg, st)
    monkeypatch.setattr(tqr, "lu_factor", _switched_lu)
    ref, _ = bqrrp_factored(A, cfg, st)
    assert torch.equal(fac.J, ref.J) and not bool(fac.fail)


# -- the [edge] kernel cases at a smaller size ---------------------------------

from randlapack_tpu_torch.utils import kernel_checks  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,how", kernel_checks.cases(),
                         ids=[f"{k}-{h}" for k, h in kernel_checks.cases()])
def test_kernel_on_adversarial_operands(cuda, kernel, how):
    """chip_smoke.py's [edge] kernel cases at 256 rows: each kernel and
    form on operands under tools/fuzz_sweep.py's mutators (and one Inf or
    NaN entry) against its plain version, by kernel_checks' rules: the
    finite pattern equal, the finite entries within the kernel's gate,
    pivots equal or parting at a tie."""
    r = kernel_checks.hold(kernel, *kernel_checks.operands(kernel, how, True,
                                                            cuda))
    assert r["ok"], r
