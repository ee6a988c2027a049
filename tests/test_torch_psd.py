"""The port's PSD track below KRILL — economy SVD, symmetric linops and the
spectral preconditioner, index sampling, RPCholesky and its preconditioner
data, the PCG family — against the JAX package on the CPU in f64, on the
same numpy inputs.

Random draws are injected: the tests draw RPCholesky's noise with JAX
exactly as ``randlapack_tpu/comps/rpchol.py`` does (the block's key from
``state.branch(i).spawn()``) and hand it to the port's ``noise=``. Singular
vectors and RPCholesky's factor have free signs (and F's columns rotate
with eigh's choices inside a block), so U·diag(s)·Vᵀ and F·Fᵀ are compared.
Tolerances: 1e-10 on factorizations, 1e-9 relative on PCG iterates (the
iteration amplifies summation-order differences), pivots and iteration
counts equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JState
from randlapack_tpu import comps as jc
from randlapack_tpu import linops as jl
from randlapack_tpu.ops import svd as jsvd
from randlapack_tpu.sketching import sampling as jsamp

from randlapack_tpu_torch import RNGState, comps as tc, interop, linops as tl
from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.ops import svd as tsvd
from randlapack_tpu_torch.sketching import sampling as tsamp


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _psd(n, seed, decay=6.0, rank=None):
    """A PSD matrix with an exponentially decaying spectrum."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    lam = np.exp(-decay * np.arange(n) / n)
    if rank is not None:
        lam[rank:] = 0.0
    return (Q * lam) @ Q.T


def _psd_embedded(n, r, seed):
    """A well-conditioned r×r PSD block on r scattered indices of an n×n
    matrix that is exactly zero elsewhere: n − r entries of the diagonal
    are dead from the start, in every arithmetic."""
    where = np.sort(np.random.default_rng(seed).permutation(n)[:r])
    A = np.zeros((n, n))
    A[np.ix_(where, where)] = _psd(r, seed, decay=2.0)
    return A


# -- svd_econ ------------------------------------------------------------------

@pytest.mark.parametrize("method", ["xla", "gram_eigh"])
@pytest.mark.parametrize("shape", [(60, 12), (12, 60)])
def test_svd_econ_parity(method, shape):
    rng = np.random.default_rng(sum(shape))
    B = rng.standard_normal(shape) * np.logspace(0, -3, shape[1])[None, :]
    Uj, sj, Vtj = jsvd.svd_econ(jnp.asarray(B), method)
    Ut, st, Vtt = tsvd.svd_econ(torch.tensor(B), method)
    assert _rel(st, sj) < 1e-10
    assert _rel((Ut * st) @ Vtt, np.asarray((Uj * sj) @ Vtj)) < 1e-10
    assert _rel((Ut * st) @ Vtt, B) < 1e-10
    assert Ut.shape == Uj.shape and Vtt.shape == Vtj.shape
    assert bool((st[:-1] >= st[1:]).all())


def test_svd_econ_gram_eigh_zeroes_below_sqrt_eps():
    """Vectors of σ < √eps·σ₁ are zeroed, as in the JAX route."""
    rng = np.random.default_rng(2)
    Q1 = np.linalg.qr(rng.standard_normal((40, 6)))[0]
    Q2 = np.linalg.qr(rng.standard_normal((6, 6)))[0]
    B = (Q1 * np.array([1, .5, .1, 1e-3, 1e-10, 1e-12])) @ Q2.T
    Uj, sj, _ = jsvd.svd_econ(jnp.asarray(B), "gram_eigh")
    Ut, st, _ = tsvd.svd_econ(torch.tensor(B), "gram_eigh")
    zero_j = np.asarray(jnp.all(Uj == 0, axis=0))
    zero_t = (Ut == 0).all(dim=0).numpy()
    np.testing.assert_array_equal(zero_t, zero_j)
    assert zero_t.sum() == 2 and _rel(st[:4], sj[:4]) < 1e-10


def test_svd_method_resolution():
    assert tsvd.resolve_svd_method("auto") == "xla"
    assert tsvd.resolve_svd_method("gram_eigh") == "gram_eigh"
    assert jsvd.resolve_svd_method("auto") == "xla"       # JAX on the CPU
    # "jacobi" is ported: the one-sided Jacobi route, not an error
    U, S, Vt = tsvd.svd_econ(torch.eye(3, dtype=torch.float64), "jacobi")
    assert torch.equal(S, torch.ones(3, dtype=torch.float64))
    assert torch.allclose(U @ Vt, torch.eye(3, dtype=torch.float64))
    with pytest.raises(RandLAPACKError):
        tsvd.svd_econ(torch.eye(3), "qdwh")


# -- linops ----------------------------------------------------------------------

@pytest.mark.parametrize("mus,s", [([0.3], 1), ([0.3], 4),
                                   ([0.3, 0.1, 2.0], 3)])
def test_spectral_precond_parity(mus, s):
    rng = np.random.default_rng(len(mus) + s)
    V = np.linalg.qr(rng.standard_normal((50, 8)))[0]
    lam = np.sort(rng.random(8))[::-1].copy()
    X = rng.standard_normal((50, s))
    Pj = jl.SpectralPrecond.prep(jnp.asarray(V), jnp.asarray(lam),
                                 jnp.asarray(mus))
    Pt = tl.SpectralPrecond.prep(torch.tensor(V), torch.tensor(lam), mus)
    assert Pt.D.shape == Pj.D.shape and _rel(Pt.D, Pj.D) < 1e-14
    assert _rel(Pt.matmat(torch.tensor(X)), Pj.matmat(jnp.asarray(X))) < 1e-13
    assert Pt.dim == 50 and Pt.dtype == torch.float64
    if len(mus) == 1:
        assert _rel(Pt.fro_nrm(), Pj.fro_nrm()) < 1e-14
    else:
        with pytest.raises(NotImplementedError):
            Pt.fro_nrm()
        with pytest.raises(RandLAPACKError):
            Pt.matmat(torch.tensor(X[:, :2]))
    Pm = tl.SpectralPrecond.prep(torch.tensor(V), torch.tensor(lam), mus,
                                 min_eig=0.01)
    Pmj = jl.SpectralPrecond.prep(jnp.asarray(V), jnp.asarray(lam),
                                  jnp.asarray(mus), min_eig=0.01)
    assert _rel(Pm.D, Pmj.D) < 1e-14


def test_spectral_precond_crosses_packages():
    rng = np.random.default_rng(0)
    V = np.linalg.qr(rng.standard_normal((30, 5)))[0]
    D = rng.standard_normal((5, 2))
    X = rng.standard_normal((30, 2))
    Pt = interop.spectral_precond_from_numpy({"V": V, "D": D}, device="cpu")
    Pj = jl.SpectralPrecond(jnp.asarray(V), jnp.asarray(D))
    assert _rel(Pt.matmat(torch.tensor(X)), Pj.matmat(jnp.asarray(X))) < 1e-13
    back = interop.spectral_precond_to_numpy(Pt)
    np.testing.assert_array_equal(back["V"], V)
    np.testing.assert_array_equal(back["D"], D)


@pytest.mark.parametrize("mus", [[0.5], [0.5, 0.01, 3.0]])
def test_reg_explicit_sym_linop_parity(mus):
    A = _psd(40, 1)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((40, len(mus)))
    Gj = jl.RegExplicitSymLinOp(jnp.asarray(A), jnp.asarray(mus))
    Gt = tl.RegExplicitSymLinOp(torch.tensor(A), mus)
    assert _rel(Gt.matmat(torch.tensor(X)), Gj.matmat(jnp.asarray(X))) < 1e-13
    assert _rel(Gt.with_reg(False).tmatmat(torch.tensor(X)),
                Gj.with_reg(False).tmatmat(jnp.asarray(X))) < 1e-13
    assert _rel(Gt.fro_nrm(), Gj.fro_nrm()) < 1e-14
    assert (Gt.dim, Gt.num_ops) == (40, len(mus))
    idx = np.array([3, 7, 3, 39])
    if len(mus) == 1:
        assert _rel(Gt.columns(torch.tensor(idx)),
                    Gj.columns(jnp.asarray(idx))) < 1e-15
        assert _rel(Gt.diagonal(), Gj.diagonal()) < 1e-15
    else:
        with pytest.raises(RandLAPACKError):
            Gt.columns(torch.tensor(idx))
        with pytest.raises(RandLAPACKError):
            Gt.diagonal()
    assert _rel(Gt.with_reg(False).columns(torch.tensor(idx)),
                Gj.with_reg(False).columns(jnp.asarray(idx))) < 1e-15


def test_explicit_sym_linop_parity():
    A = _psd(20, 2)
    Gj, Gt = jl.ExplicitSymLinOp(jnp.asarray(A)), tl.ExplicitSymLinOp(
        torch.tensor(A))
    X = np.random.default_rng(2).standard_normal((20, 3))
    assert _rel(Gt.matmat(torch.tensor(X)), Gj.matmat(jnp.asarray(X))) < 1e-13
    assert _rel(Gt.columns(torch.tensor([1, 5])),
                Gj.columns(jnp.asarray([1, 5]))) == 0
    assert _rel(Gt.diagonal(), Gj.diagonal()) == 0
    assert float(Gt.entry(2, 3)) == float(Gj.entry(2, 3))
    assert _rel(Gt.fro_nrm(), Gj.fro_nrm()) < 1e-14
    d = Gt.diagonal()
    d[0] = -1.0                      # a copy: the operator is not touched
    assert float(Gt.mat[0, 0]) == A[0, 0]


# -- sampling ---------------------------------------------------------------------

def test_weights_to_cdf_and_inversion_parity():
    rng = np.random.default_rng(3)
    w = rng.random(50)
    w[[4, 5, 20]] = 0.0
    w[7] = -0.5
    u = np.concatenate([rng.random(30), [0.0]])
    cj = jsamp.weights_to_cdf(jnp.asarray(w))
    ct = tsamp.weights_to_cdf(torch.tensor(w))
    assert _rel(ct, cj) < 1e-15
    u = np.concatenate([u, np.asarray(cj)[[3, 4, 5, 49]]])   # exact hits
    ij = jnp.clip(jnp.searchsorted(cj, jnp.asarray(u), side="left"), 0, 49)
    np.testing.assert_array_equal(      # the same CDF, bit for bit, in both
        tsamp.cdf_to_indices(torch.tensor(np.array(cj)),
                             torch.tensor(u)).numpy(), np.asarray(ij))
    assert np.asarray(ij)[-4:].tolist() == [3, 3, 3, 49]
    assert _rel(tsamp.weights_to_cdf(torch.zeros(4, dtype=torch.float64)),
                jsamp.weights_to_cdf(jnp.zeros(4))) == 0
    assert _rel(tsamp.weights_to_cdf(torch.tensor(w), 0.2),
                jsamp.weights_to_cdf(jnp.asarray(w), 0.2)) < 1e-15


def test_sample_indices_iid():
    cdf = tsamp.weights_to_cdf(torch.tensor([0.0, 1.0, 0.0, 3.0],
                                            dtype=torch.float64))
    idx, nxt = tsamp.sample_indices_iid(cdf, 4000, RNGState(0))
    idx2, _ = tsamp.sample_indices_iid(cdf, 4000, RNGState(0))
    assert torch.equal(idx, idx2) and nxt.counter == 1
    assert set(idx.tolist()) == {1, 3}
    assert abs(float((idx == 3).double().mean()) - 0.75) < 0.05


# -- RPCholesky --------------------------------------------------------------------

def _jax_noise(state, nblocks, sampling, n, b):
    """The draws of randlapack_tpu/comps/rpchol.py, block by block."""
    rows = []
    for i in range(nblocks):
        key, _ = state.branch(i).spawn()
        rows.append(jax.random.gumbel(key, (n,), dtype=jnp.float64)
                    if sampling == "gumbel"
                    else jax.random.uniform(key, (b,), dtype=jnp.float64))
    return np.stack([np.asarray(r) for r in rows])


# n 96 k 32 b 8 throughout: one JAX compile per sampling mode
@pytest.mark.parametrize("sampling,rank", [("gumbel", None), ("iid", None),
                                           ("gumbel", 20), ("iid", 20)])
def test_rp_cholesky_parity_with_injected_noise(sampling, rank):
    """rank 20 < k, on 20 live entries: in the third block fewer than b
    entries are live and in the fourth none, so dead entries are drawn
    (Gumbel: ties at the −1e30 floor go to the lower index; iid: repeated
    draws, and index n − 1 once every weight is zero)."""
    n, k, b = 96, 32, 8
    A = _psd(n, 5, decay=14.0) if rank is None else _psd_embedded(n, rank, 5)
    cfgj = jc.RPCholConfig(block_size=b, sampling=sampling)
    Fj, pj, _ = jc.rp_cholesky(jl.ExplicitSymLinOp(jnp.asarray(A)), k, cfgj,
                               JState(3))
    noise = _jax_noise(JState(3), k // b, sampling, n, b)
    Ft, pt, nxt = tc.rp_cholesky(
        tl.ExplicitSymLinOp(torch.tensor(A)), k,
        tc.RPCholConfig(block_size=b, sampling=sampling), RNGState(3),
        noise=torch.tensor(noise))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert _rel(Ft @ Ft.T, np.asarray(Fj @ Fj.T)) < 1e-10
    assert nxt.counter == 1 and pt.dtype == torch.int64
    if rank is None:
        assert _rel(Ft @ Ft.T, A) < 0.2
    elif sampling == "gumbel":
        assert _rel(Ft @ Ft.T, A) < 1e-10     # exact at rank 20
        assert len(set(pt[:24].tolist())) == 24 and pt[24:].tolist() == list(
            range(8))


def test_rp_cholesky_duplicate_iid_draws():
    """Uniforms chosen to repeat pivots inside a block: the winner of a
    repeated pivot is the last of its draws, as JAX's scatter leaves it on
    the CPU; the other draws become zero columns of F."""
    n, k, b = 96, 32, 8
    A = _psd(n, 5)
    noise = _jax_noise(JState(3), k // b, "iid", n, b)
    noise[0, [1, 4, 6]] = noise[0, 0]
    noise[2, 7] = noise[2, 2]
    op = tl.ExplicitSymLinOp(torch.tensor(A))
    Ft, pt, _ = tc.rp_cholesky(op, k, tc.RPCholConfig(b, "iid"), RNGState(3),
                               noise=torch.tensor(noise))
    assert pt[0] == pt[1] == pt[4] == pt[6] and pt[18] == pt[23]
    # a block's zero columns come first (eigh's order), one per repeat
    zero_cols = (Ft == 0).all(dim=0).nonzero()[:, 0].tolist()
    assert zero_cols == [i * b + j for i in range(k // b) for j in range(
        b - len(set(pt[i * b:(i + 1) * b].tolist())))]
    assert zero_cols[:3] == [0, 1, 2] and 16 in zero_cols
    # JAX's scatter keeps the same representative
    idx = jnp.asarray(pt[:b].numpy(), jnp.int32)
    winner = jnp.zeros((n,), jnp.int32).at[idx].set(
        jnp.arange(b, dtype=jnp.int32))
    keep_j = np.asarray(winner[idx] == jnp.arange(b))
    np.testing.assert_array_equal(keep_j, ~np.isin(np.arange(b), [0, 1, 4]))
    # and the factor is the one without the repeats
    d = torch.diagonal(torch.tensor(A) - Ft @ Ft.T)
    assert float(d.min()) > -1e-12 and float(d[pt].abs().max()) < 1e-12


def test_rp_cholesky_draws_its_own_noise():
    A = _psd(64, 6)
    op = tl.RegExplicitSymLinOp(torch.tensor(A), [0.1], False)
    for sampling in ("gumbel", "iid"):
        cfg = tc.RPCholConfig(8, sampling)
        F1, p1, _ = tc.rp_cholesky(op, 16, cfg, RNGState(1))
        F2, p2, _ = tc.rp_cholesky(op, 16, cfg, RNGState(1))
        _, p3, _ = tc.rp_cholesky(op, 16, cfg, RNGState(2))
        assert torch.equal(p1, p2) and torch.equal(F1, F2)
        assert not torch.equal(p1, p3)
        d = torch.diagonal(torch.tensor(A) - F1 @ F1.T)
        assert float(d.min()) > -1e-12
    assert len(set(p1.tolist())) <= 16
    with pytest.raises(RandLAPACKError, match="multiple"):
        tc.rp_cholesky(op, 12, cfg, RNGState(1))
    with pytest.raises(RandLAPACKError, match="noise must have shape"):
        tc.rp_cholesky(op, 16, cfg, RNGState(1), noise=torch.zeros(2, 64))
    with pytest.raises(RandLAPACKError, match="sampling"):
        tc.rp_cholesky(op, 16, tc.RPCholConfig(8, "uniform"), RNGState(1))


@pytest.mark.parametrize("svd_method", ["auto", "gram_eigh"])
def test_rpchol_pc_data_parity(svd_method):
    n, k, b = 96, 32, 8
    A = _psd(n, 5)
    Vj, lj, pj, _ = jc.rpchol_pc_data(jl.ExplicitSymLinOp(jnp.asarray(A)), k,
                                      JState(3), block_size=b,
                                      svd_method=svd_method)
    noise = _jax_noise(JState(3), k // b, "gumbel", n, b)
    Vt, lt, pt, _ = tc.rpchol_pc_data(
        tl.ExplicitSymLinOp(torch.tensor(A)), k, RNGState(3), block_size=b,
        svd_method=svd_method, noise=torch.tensor(noise))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert _rel(lt, lj) < 1e-10
    assert _rel((Vt * lt) @ Vt.T, np.asarray((Vj * lj) @ Vj.T)) < 1e-10
    Fn = interop.rpchol_to_numpy(*interop.rpchol_from_numpy(
        {"F": np.asarray(Vj), "pivots": np.asarray(pj)}, device="cpu"))
    np.testing.assert_array_equal(Fn["pivots"], np.asarray(pj))
    assert Fn["pivots"].dtype == np.int64


def test_make_right_orthogonalizer_parity():
    rng = np.random.default_rng(8)
    V = np.linalg.qr(rng.standard_normal((12, 12)))[0]
    sig = np.array([3., 2., 1., .5, .1, 1e-3, 1e-6, 1e-9, 1e-13, 1e-17, 0, 0])
    for mu, rel_tol in ((0.0, None), (0.3, None), (0.0, 1e-5)):
        Mj, rj = jc.make_right_orthogonalizer(jnp.asarray(V),
                                              jnp.asarray(sig), mu, rel_tol)
        Mt, rt = tc.make_right_orthogonalizer(torch.tensor(V),
                                              torch.tensor(sig), mu, rel_tol)
        assert int(rt) == int(rj) and _rel(Mt, Mj) < 1e-15


# -- PCG family -----------------------------------------------------------------------

def _pcg_problem(s, mus, seed=0):
    """A + μI with a JAX-built spectral preconditioner of its top 40
    eigenpairs, carried to the port through interop."""
    n = 80
    A = _psd(n, seed, decay=9.0)
    rng = np.random.default_rng(seed + 1)
    H = rng.standard_normal((n, s))
    lam, V = np.linalg.eigh(A)
    lam, V = lam[::-1][:40].copy(), V[:, ::-1][:, :40].copy()
    Pj = jl.SpectralPrecond.prep(jnp.asarray(V), jnp.asarray(lam),
                                 jnp.asarray(mus))
    Pt = interop.spectral_precond_from_numpy(
        {"V": np.asarray(Pj.V), "D": np.asarray(Pj.D)}, device="cpu")
    Gj = jl.RegExplicitSymLinOp(jnp.asarray(A), jnp.asarray(mus))
    Gt = tl.RegExplicitSymLinOp(torch.tensor(A), mus)
    return A, H, Gj, Gt, Pj, Pt


@pytest.mark.parametrize("mode,s,mus,seminorm,tol", [
    ("lockstep", 1, [1e-3], False, 1e-7),
    ("lockstep", 3, [1e-1, 1e-2, 1e-3], False, 1e-7),
    ("block", 3, [1e-3], False, 1e-5), ("lockstep", 3, [1e-3], True, 1e-7),
    ("block", 1, [1e-3], True, 1e-7)])
def test_pcg_parity_with_the_jax_preconditioner(mode, s, mus, seminorm, tol):
    """Block CG with three right-hand sides stops at 1e-5: below that its
    3×3 scalar systems turn singular and both packages' residuals rise
    again, each along its own rounding."""
    A, H, Gj, Gt, Pj, Pt = _pcg_problem(s, mus)
    kw = dict(tol=tol, max_iters=60, mode=mode)
    Xj, hj, ij = jc.pcg(Gj, jnp.asarray(H), Pj, jnp.zeros_like(H),
                        jc.PCGConfig(**kw),
                        seminorm=jc.frobenius_seminorm if seminorm else None)
    Xt, ht, it = tc.pcg(Gt, torch.tensor(H), Pt, torch.zeros(H.shape,
                                                             dtype=torch.float64),
                        tc.PCGConfig(**kw),
                        seminorm=tc.frobenius_seminorm if seminorm else None)
    assert isinstance(it, int) and it == int(ij) and 0 < it < 60
    assert ht.shape == hj.shape == (61, 2 if seminorm else s)
    assert _rel(Xt, Xj) < 1e-9
    assert _rel(ht[:it + 1], np.asarray(hj)[:it + 1]) < 1e-9
    # rows past iters stay zero, as in the JAX code
    assert float(ht[it + 1:].abs().max()) == 0 == float(
        jnp.abs(hj[it + 1:]).max())
    mu_cols = np.broadcast_to(np.asarray(mus), (s,))
    res = np.linalg.norm(A @ Xt.numpy() + Xt.numpy() * mu_cols - H, axis=0)
    assert (res <= (1e-5 if seminorm else 1.01 * tol)
            * np.linalg.norm(H, axis=0)).all()


def test_pcg_operand_kinds_and_early_exit(capsys):
    """G and N as tensors, callables and None; a zero right-hand side
    stops before the first iteration; max_iters caps; verbose prints."""
    A, H, _, Gt, _, Pt = _pcg_problem(2, [1e-2])
    Ad = torch.tensor(A) + 1e-2 * torch.eye(80, dtype=torch.float64)
    Ht, X0 = torch.tensor(H), torch.zeros(80, 2, dtype=torch.float64)
    cfg = tc.PCGConfig(tol=1e-9, max_iters=60)
    Xa, _, ia = tc.pcg(Gt, Ht, Pt, X0, cfg)
    Xb, _, ib = tc.pcg(Ad, Ht, Pt.matmat, X0, cfg)
    assert ia == ib and _rel(Xb, Xa) < 1e-12
    Xc, _, ic = tc.pcg(lambda X: Ad @ X, Ht, None, X0, cfg)
    assert ic > ia and _rel(Xc, Xa) < 1e-6
    _, hist, iz = tc.pcg(Gt, torch.zeros_like(Ht), Pt, X0, cfg)
    assert iz == 0 and float(hist.abs().max()) == 0
    _, hist, im = tc.pcg(Gt, Ht, None, X0, tc.PCGConfig(tol=1e-14,
                                                        max_iters=3))
    assert im == 3 and hist.shape == (4, 2) and bool((hist > 0).all())
    tc.pcg(Gt, Ht, Pt, X0, tc.PCGConfig(tol=1e-2, max_iters=5, verbose=True))
    assert "pcg iter 1: max residual" in capsys.readouterr().out
    with pytest.raises(RandLAPACKError):
        tc.pcg(Gt, Ht, Pt, X0, tc.PCGConfig(mode="pipelined"))


def test_pcg_block_mode_survives_a_singular_scalar_system():
    """Two equal right-hand sides make PᵀGP singular: Cholesky fails and
    the eigh pseudo-inverse takes over, in both packages."""
    A, H, Gj, Gt, Pj, Pt = _pcg_problem(2, [1e-2])
    H[:, 1] = H[:, 0]
    cfg = dict(tol=1e-8, max_iters=40, mode="block")
    Xj, _, ij = jc.pcg(Gj, jnp.asarray(H), Pj, jnp.zeros_like(H),
                       jc.PCGConfig(**cfg))
    Xt, _, it = tc.pcg(Gt, torch.tensor(H), Pt,
                       torch.zeros(80, 2, dtype=torch.float64),
                       tc.PCGConfig(**cfg))
    assert it == int(ij) < 40
    assert _rel(Xt, Xj) < 1e-7


@pytest.mark.parametrize("case", ["psd", "not_psd", "zero", "rank_deficient"])
def test_psd_sqrt_pinv_parity(case):
    A = {"psd": _psd(10, 1), "not_psd": _psd(10, 1) - 0.5 * np.eye(10),
         "zero": np.zeros((10, 10)),
         "rank_deficient": _psd(10, 1, rank=6)}[case]
    Bj, kj, cj = jc.psd_sqrt_pinv(jnp.asarray(A))
    Bt, kt, ct = tc.psd_sqrt_pinv(torch.tensor(A))
    assert int(kt) == int(kj) and int(ct) == int(cj)
    assert int(ct) == {"psd": 0, "not_psd": -11, "zero": -12,
                       "rank_deficient": 4}[case]
    assert _rel(Bt @ Bt.T, np.asarray(Bj @ Bj.T)) < 1e-10 or case == "zero"
    if case == "rank_deficient":
        assert float(Bt[:, :4].abs().max()) == 0
        assert _rel(Bt @ Bt.T, np.linalg.pinv(A)) < 1e-8


@pytest.mark.parametrize("mu,refresh", [(0.0, 50), (0.1, 4)])
def test_pcg_saddle_parity(mu, refresh, capsys):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((120, 15)) * np.logspace(0, -2, 15)
    b, c = rng.standard_normal(120), 0.1 * rng.standard_normal(15)
    _, sig, Vt = np.linalg.svd(A, full_matrices=False)
    M = Vt.T * (1.0 / np.sqrt((sig * (1 + 0.3 * rng.random(15))) ** 2 + mu))
    cfg = dict(tol=1e-10, max_iters=80, refresh_every=refresh)
    xj, hj, ij = jc.pcg_saddle(*map(jnp.asarray, (A, b, c)), mu,
                               jnp.asarray(M), jnp.zeros(15),
                               jc.PCGSaddleConfig(**cfg))
    xt, ht, it = tc.pcg_saddle(*map(torch.tensor, (A, b, c)), mu,
                               torch.tensor(M),
                               torch.zeros(15, dtype=torch.float64),
                               tc.PCGSaddleConfig(**cfg, verbose=True))
    assert it == int(ij) and refresh < it < 80 or refresh == 50
    assert _rel(xt, xj) < 1e-10
    assert _rel(ht[:it + 1], np.asarray(hj)[:it + 1]) < 1e-9
    assert f"pcg_saddle iter {it}: residual" in capsys.readouterr().out
    x_true = np.linalg.solve(A.T @ A + mu * np.eye(15), A.T @ b - c)
    assert _rel(xt, x_true) < 1e-8
