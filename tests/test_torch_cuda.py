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
same operands. The f32 K4 (TF32 ``mma`` cross term, ``ex2``) and K7
(three TF32 ``wgmma`` products, S made by producer warps) are held the
same way: K7 to 4x ``torch.mm``'s error on the stored S, K4 to 4x its SIMT
kernel's. The QRCP kernels (K5, K6) must give exactly the plain version's pivots on inputs
whose column norms are spread out (exp(-3·U) column scaling, as the JAX
kernel test uses); their factors agree within 1e-4 (f32) / 1e-10 (f64)
of the largest entry. The kernel product (K4) sums n terms of one sign
pattern in its own order: 1e-4 (f32) / 1e-11 (f64) of the largest entry.
The Gaussian sketch (K7) generates S from the same Philox words as its
plain version, but ``logf``/``cosf`` on the card differ from PyTorch's
by an ulp or two: S within 1e-6 absolute (f32) / 1e-14 (f64), S·A within
1e-4 / 1e-11 of the largest entry."""
import numpy as np
import pytest
import torch

import randlapack_tpu_torch as rt
from randlapack_tpu_torch.drivers import (BQRRPConfig, HQRRPConfig, PanelQR,
                                          bqrrp_factored, bqrrp_q, hqrrp)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 48, 256, 300])
def test_getrfnp_kernel_matches_plain(cuda, dtype, k):
    M = torch.tensor(_orthonormal(k, k), dtype=dtype, device=cuda)
    n0 = tlu.LAUNCHES["getrfnp"]
    F, s = tlu.getrfnp_routed(M)
    Fp, sp = tlu.getrfnp(M)
    torch.cuda.synchronize()
    assert tlu.LAUNCHES["getrfnp"] == n0 + 1
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert torch.equal(s, sp)
    assert float((F - Fp).abs().max()) <= tol
    U = torch.triu(F)
    assert float(U.diagonal().abs().min()) >= 1.0 - 1e-5
    L = torch.tril(F, -1) + torch.eye(k, dtype=dtype, device=cuda)
    assert float((L @ U - (M - torch.diag(s))).abs().max()) <= tol


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
    assert twy.LAUNCHES == {"masked_vt_a": 5, "a_minus_vz_masked": 3,
                            "masked_vt_a_simt": 0,
                            "a_minus_vz_masked_simt": 0}
    assert tlu.LAUNCHES == {"getrfnp": 5}
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


@pytest.mark.cuda
@pytest.mark.parametrize("force_global", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d,n,b", [(74, 512, 64), (26, 256, 16),
                                   (138, 8192, 128), (138, 1000, 128),
                                   (12, 37, 12)])
def test_select_pivots_kernel_matches_plain(cuda, dtype, d, n, b,
                                            force_global):
    Y = torch.tensor(_spread((d, n), d + n), dtype=dtype, device=cuda)
    live = torch.ones(n, dtype=dtype, device=cuda)
    live[torch.tensor([0, 3, 5, 8, 9, 20, n - 1])] = 0.0
    n0 = tqrcp.LAUNCHES["qrcp_select_pivots"]
    out = tqrcp.qrcp_select_pivots_cuda(Y, b, live, force_global)
    ref = tqr.qrcp_select_pivots(Y, b, live)
    torch.cuda.synchronize()
    assert tqrcp.LAUNCHES["qrcp_select_pivots"] == n0 + 1
    assert torch.equal(out, ref)
    assert not set(out.tolist()) & {0, 3, 5, 8, 9, 20, n - 1}


@pytest.mark.cuda
@pytest.mark.parametrize("force_global", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,b,r0,pivot", [(512, 64, 0, True),
                                          (512, 64, 128, True),
                                          (512, 64, 128, False),
                                          (8192, 128, 0, True),
                                          (8192, 128, 4096, True),
                                          (1000, 100, 333, True),
                                          (64, 64, 0, True)])
def test_panel_kernel_matches_plain(cuda, dtype, m, b, r0, pivot,
                                    force_global):
    P = torch.tensor(_spread((m, b), m + b + r0), dtype=dtype, device=cuda)
    n0 = tqrcp.LAUNCHES["qrcp_panel"]
    if force_global:
        W, taus, sigma = tqrcp.qrcp_panel_cuda(P, r0, pivot,
                                               force_global=True)
        V = None
    else:
        W, V, taus, sigma = tqrcp.qrcp_panel_routed(P, r0, pivot)
    Wp, Vp, tp, sp = tqr.qrcp_panel(P, r0, pivot)
    torch.cuda.synchronize()
    assert tqrcp.LAUNCHES["qrcp_panel"] == n0 + 1
    assert torch.equal(sigma, sp)
    assert torch.equal(W[:r0], P[:r0, sigma])
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((W - Wp).abs().max()) <= tol * float(Wp.abs().max())
    assert float((taus - tp).abs().max()) <= tol
    if V is not None:
        assert float((V - Vp).abs().max()) <= tol


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
                              "qrcp_panel": nblocks}
    assert not any(twy.LAUNCHES.values())
    assert tlu.LAUNCHES == {"getrfnp": 0}
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
    assert tqrcp.LAUNCHES == {"qrcp_select_pivots": 0, "qrcp_panel": 0}
    # CholQR panels go through K3 instead of K6
    _reset_all()
    chol = HQRRPConfig(block_size=64, panel_qr=PanelQR.cholqr)
    hqrrp(torch.tensor(A, device=cuda), chol, rt.RNGState(2))
    torch.cuda.synchronize()
    assert tqrcp.LAUNCHES == {"qrcp_select_pivots": nblocks,
                              "qrcp_panel": 0}
    assert tlu.LAUNCHES == {"getrfnp": nblocks}


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
    out = tk.kernel_matmat(X, V, bw)
    assert tk.LAUNCHES == {**n0, "kernel_matmat": n0["kernel_matmat"] + 1}
    simt = tk.kernel_matmat_simt(X, V, bw)
    assert tk.LAUNCHES == {**n0, "kernel_matmat": n0["kernel_matmat"] + 1,
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
                           "kernel_matmat_simt": 0, "gaussian_sketch_simt": 0}
    from randlapack_tpu_torch import ops
    ops.gaussian_sketch(X.T.contiguous(), 16, 1)
    assert tk.LAUNCHES["gaussian_sketch"] == 1
    assert tk.LAUNCHES["gaussian_sketch_simt"] == 0
