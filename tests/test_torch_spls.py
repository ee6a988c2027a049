"""The port's least squares (randlapack_tpu_torch.drivers.spls,
comps.lsqr, comps.rpc_data_svd_saso, comps.right_precond_saso) against
the JAX package's on the CPU in f64. Inputs are built by the JAX
generators (``mat_gen``, exponential spectrum, κ = cond_num); the SASO is
drawn by JAX from the same ``RNGState`` as its ``spls`` draws it and
injected through ``interop.saso_from_numpy`` (``sketch=``).

Gates, from the algorithms' attainable accuracy at κ = 1e4 in f64:
- LSQR runs to the stall stop (tol 1e-12): x within 100·κ·eps of the JAX
  x (relative), iterations within 1. The iterates in between are not
  compared to that gate: a last-bit change of b moves LSQR's x at
  tol 1e-8 by 1e-7 at this κ, so only the converged x is defined to
  rounding.
- PCG on the normal equations (tol 1e-10): x within 10·κ²·eps, the
  history within 1e-8 of its first entry, iterations within 1.
- Damped runs (μ 1e-4, "svd"): well conditioned, x within 1e-10.
- "qr" with μ > 0: M = R_sk⁻¹ ignores μ, so the damped system is poorly
  preconditioned and the stop falls among rounding-level steps; both
  packages are held to the damped normal equations (relative residual
  ≤ 1e-8) and their iteration counts to 5 % of each other.
- Preconditioners: σ of the sketch within 1e-12·σ₁, V within 1e-10 up
  to column signs; A·M's singular values within 1e-10, rank and
  ``fail`` equal.
The tests that mirror the JAX package's own (tests/test_psd_track.py,
test_edge_cases.py, test_property_sweeps.py) run the port with its own
draws and the same gates as those tests.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.comps import LSQRConfig as JLSQRConfig
from randlapack_tpu.comps import PCGSaddleConfig as JPCGSaddleConfig
from randlapack_tpu.comps import lsqr as j_lsqr
from randlapack_tpu.comps import right_precond_saso as j_right_precond_saso
from randlapack_tpu.comps import rpc_data_svd_saso as j_rpc_data_svd_saso
from randlapack_tpu.drivers import SPLSConfig as JSPLSConfig
from randlapack_tpu.drivers import spls as j_spls
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen
from randlapack_tpu.sketching import SparseDist as JSparseDist
from randlapack_tpu.sketching import fill_sparse as j_fill_sparse

import randlapack_tpu_torch as rt
from randlapack_tpu_torch.comps import (LSQRConfig, PCGSaddleConfig, lsqr,
                                        make_right_orthogonalizer,
                                        right_precond_saso,
                                        rpc_data_svd_saso)
from randlapack_tpu_torch.drivers import SPLSConfig, spls
from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.interop import saso_from_numpy
from randlapack_tpu_torch.ops import util

EPS = float(np.finfo(np.float64).eps)
KAPPA = 1e4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops in loops: one intra-op thread keeps each at its
    own cost beside other test processes. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.tensor(np.asarray(x))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _problem(m=300, n=40, cond=KAPPA, seed=0, rhs=None):
    A, _ = mat_gen(MatGenInfo(m, n, MatType.exponential, cond_num=cond),
                   JRNG(seed))
    shape = (n,) if rhs is None else (n, rhs)
    xt = jax.random.normal(jax.random.key(seed), shape, jnp.float64)
    return np.asarray(A), np.asarray(xt), np.asarray(A @ xt)


def _sketch(m, n, d_factor, vec_nnz, seed):
    """The SASO the JAX drivers draw first from ``JRNG(seed)``."""
    d = min(int(d_factor * n), m)
    op, _ = j_fill_sparse(JSparseDist(d, m, vec_nnz), JRNG(seed),
                          dtype=jnp.float64)
    return saso_from_numpy(dict(n_rows=d, n_cols=m, vec_nnz=vec_nnz),
                           op.rows, op.vals, device="cpu")


def _both(A, b, mu, kw, seed=1, tol=1e-12, max_iters=200):
    """spls of both packages on (A, b, μ), the JAX-drawn SASO injected."""
    jx, jh, jit, jst = j_spls(jnp.asarray(A), jnp.asarray(b), mu,
                              JSPLSConfig(pcg=JPCGSaddleConfig(
                                  tol=tol, max_iters=max_iters), **kw),
                              JRNG(seed))
    cfg = SPLSConfig(pcg=PCGSaddleConfig(tol=tol, max_iters=max_iters), **kw)
    m, n = A.shape
    d = min(int(cfg.d_factor * n), m)
    S = (None if cfg.precond == "svd" and d >= m
         else _sketch(m, n, cfg.d_factor, cfg.vec_nnz, seed))
    x, h, it, st = spls(_t(A), _t(b), mu, cfg, rt.RNGState(seed), sketch=S)
    assert isinstance(it, int)
    assert st.counter == int(jst.counter)
    return (np.asarray(jx), np.asarray(jh), int(jit)), (x.numpy(),
                                                        h.numpy(), it)


BRANCHES = {   # name -> (SPLSConfig fields, μ, tol)
    "lsqr-svd": (dict(solver="lsqr"), 0.0, 1e-12),
    "lsqr-svd-norefine": (dict(solver="lsqr", refine_precond=False), 0.0,
                          1e-12),
    "lsqr-qr": (dict(solver="lsqr", precond="qr"), 0.0, 1e-12),
    "auto-svd": (dict(), 0.0, 1e-12),
    "pcg-svd": (dict(solver="pcg"), 0.0, 1e-10),
    "pcg-svd-norefine": (dict(solver="pcg", refine_precond=False), 0.0,
                         1e-10),
    "pcg-qr": (dict(solver="pcg", precond="qr"), 0.0, 1e-10),
    "lsqr-svd-damped": (dict(solver="lsqr"), 1e-4, 1e-12),
    "lsqr-svd-norefine-damped": (dict(solver="lsqr", refine_precond=False),
                                 1e-4, 1e-12),
    "pcg-svd-damped": (dict(solver="pcg"), 1e-4, 1e-10),
    "pcg-svd-norefine-damped": (dict(solver="pcg", refine_precond=False),
                                1e-4, 1e-10),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_spls_branch_parity(branch):
    kw, mu, tol = BRANCHES[branch]
    A, xt, b = _problem()
    (jx, jh, jit), (x, h, it) = _both(A, b, mu, kw, tol=tol)
    assert abs(it - jit) <= 1, (it, jit)
    pcg = kw.get("solver") == "pcg"
    if mu > 0:
        gate = 1e-10
    else:
        gate = 10 * KAPPA ** 2 * EPS if pcg else 100 * KAPPA * EPS
    assert _rel(x, jx) <= gate, (_rel(x, jx), gate)
    k = min(it, jit) + 1
    np.testing.assert_allclose(h[:k], jh[:k], rtol=0,
                               atol=1e-8 * jh[0] if pcg else 1e-6 * jh[0])
    assert not h[it + 1:].any()
    if mu == 0:
        assert _rel(x, xt) <= gate


@pytest.mark.parametrize("solver", ["lsqr", "pcg"])
def test_spls_qr_damped_optimality(solver):
    A, _, b = _problem()
    mu = 1e-4
    (jx, _, jit), (x, _, it) = _both(A, b, mu, dict(solver=solver,
                                                    precond="qr"),
                                     tol=1e-10, max_iters=400)
    rhs = A.T @ b
    for sol in (x, jx):
        r = A.T @ (A @ sol) + mu * sol - rhs
        assert np.linalg.norm(r) / np.linalg.norm(rhs) <= 1e-8
    assert abs(it - jit) <= 0.05 * jit, (it, jit)


def test_spls_multi_rhs_pcg_saddle():
    A, xt, B = _problem(rhs=3)
    (jx, jh, jit), (x, h, it) = _both(A, B, 1e-6, dict(), tol=1e-10)
    assert x.shape == (40, 3) and abs(it - jit) <= 1
    assert _rel(x, jx) <= 1e-10
    np.testing.assert_allclose(h[:min(it, jit) + 1], jh[:min(it, jit) + 1],
                               rtol=0, atol=1e-8 * jh[0])
    with pytest.raises(RandLAPACKError, match="one right-hand side"):
        spls(_t(A), _t(B), 0.0, SPLSConfig(solver="lsqr"), rt.RNGState(1),
             sketch=_sketch(300, 40, 4.0, 8, 1))


@pytest.mark.parametrize("solver", ["lsqr", "pcg"])
def test_converged_x_ignores_the_sketch_summation_order(solver,
                                                        monkeypatch):
    """Run to tol 1e-12, both solvers give the same x (within 100·κ·eps /
    10·κ²·eps, κ 1e3) whichever order the SASO apply sums its layers in:
    the rounding-level freedom the card's atomic scatter has.
    chip_smoke.py's card-vs-CPU spls comparison rests on this."""
    import randlapack_tpu_torch.sketching.sparse_ops as so
    g = torch.Generator().manual_seed(16)
    m, n = 600, 50
    U = torch.linalg.qr(torch.randn(m, n, generator=g, dtype=torch.float64))[0]
    V = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=torch.float64))[0]
    A = (U * torch.logspace(0, -3, n, dtype=torch.float64)) @ V.T
    xt = torch.randn(n, generator=g, dtype=torch.float64)
    b = A @ xt
    S, _ = rt.sketching.fill_sparse(rt.sketching.SparseDist(4 * n, m, 8),
                                    rt.RNGState(3), dtype=torch.float64,
                                    device="cpu")
    cfg = SPLSConfig(solver=solver, pcg=PCGSaddleConfig(tol=1e-12,
                                                        max_iters=200))
    x1, _, i1, _ = spls(A, b, 0.0, cfg, rt.RNGState(3), sketch=S)
    forward = so._saso_left_scatter

    def reversed_layers(S, A, d, n):
        out = torch.zeros((d, n), dtype=A.dtype, device=A.device)
        for j in reversed(range(S.dist.vec_nnz)):
            out.index_add_(0, S.rows[j], S.vals[j, :, None] * A)
        return out

    monkeypatch.setattr(so, "_saso_left_scatter", reversed_layers)
    x2, _, i2, _ = spls(A, b, 0.0, cfg, rt.RNGState(3), sketch=S)
    monkeypatch.setattr(so, "_saso_left_scatter", forward)
    gate = 100 * 1e3 * EPS if solver == "lsqr" else 10 * 1e6 * EPS
    assert abs(i1 - i2) <= 1, (i1, i2)
    assert _rel(x1, x2) <= gate, (_rel(x1, x2), gate)


def test_spls_near_square_draws_no_sketch():
    """tests/test_edge_cases.py:188 — d = min(4n, m) = m: "svd" takes A
    itself as the sketch (nothing drawn, nothing injectable); "qr" still
    draws a square SASO."""
    A, st = mat_gen(MatGenInfo(50, 40, MatType.exponential, cond_num=10),
                    JRNG(12))
    A = np.asarray(A)
    xt = np.asarray(jax.random.normal(jax.random.key(1), (40,), jnp.float64))
    b = A @ xt
    (jx, _, jit), (x, _, it) = _both(A, b, 0.0, dict(), seed=13)
    assert _rel(x, xt) < 1e-6 and _rel(x, jx) <= 1e-12 and it == jit
    with pytest.raises(RandLAPACKError, match="own sketch"):
        spls(_t(A), _t(b), 0.0, SPLSConfig(), rt.RNGState(13),
             sketch=_sketch(50, 40, 4.0, 8, 13))
    (jx, _, _), (x, _, _) = _both(A, b, 0.0, dict(precond="qr"), seed=13)
    assert _rel(x, jx) <= 1e-12


def test_spls_end_to_end_own_draws():
    """tests/test_psd_track.py:162 on the port with its own SASO."""
    A, xt, b = _problem(5000, 100, 1e4, seed=12)
    x, hist, iters, _ = spls(_t(A), _t(b), 0.0, SPLSConfig(),
                             rt.RNGState(13))
    assert _rel(x, xt) < 1e-6
    assert iters < 60


def test_lsqr_beats_normal_equations_at_high_cond():
    """tests/test_psd_track.py:226: at κ 1e8 LSQR reaches ~κ·eps, PCG on
    the normal equations only ~κ²·eps (the port, its own draws)."""
    A, xt, b = _problem(4000, 80, 1e8, seed=41)
    x_l, _, _, _ = spls(_t(A), _t(b), 0.0, SPLSConfig(solver="lsqr",
                                                      precond="qr"),
                        rt.RNGState(42))
    x_p, _, _, _ = spls(_t(A), _t(b), 0.0, SPLSConfig(solver="pcg",
                                                      precond="svd"),
                        rt.RNGState(42))
    rel_l, rel_p = _rel(x_l, xt), _rel(x_p, xt)
    assert rel_l < 1e-3, rel_l
    assert rel_l < rel_p / 10, (rel_l, rel_p)


def test_spls_solver_grid_own_draws():
    """tests/test_property_sweeps.py:78 on the port: the normal-equations
    optimality of both solvers at μ ∈ {0, 1e-4}, and the stall stop well
    before the cap."""
    rng = random.Random(1)
    for trial in range(4):
        m, n = rng.choice([(300, 40), (500, 80)])
        mu = rng.choice([0.0, 1e-4])
        A, _, b = _problem(m, n, 1e4, seed=trial)
        for solver in ["pcg", "lsqr"]:
            cfg = SPLSConfig(solver=solver,
                             pcg=PCGSaddleConfig(tol=1e-12, max_iters=200))
            x, _, it, _ = spls(_t(A), _t(b), mu, cfg, rt.RNGState(trial + 1))
            x = x.numpy()
            r = A.T @ (A @ x - b) + mu * x
            opt = np.linalg.norm(r) / np.linalg.norm(A.T @ b)
            assert opt < 1e-7, (trial, solver, mu, opt)
            assert it < 200, (trial, solver, it)


def test_spls_scale_equivariant():
    """tests/test_property_sweeps.py:288: the relative diagonal floor of
    "qr" and the SVD route make a uniformly tiny input solve as well as
    an O(1) one (the port, one draw for both)."""
    s = 2.0 ** -60
    A, _, _ = _problem(150, 60, 1e4, seed=902)
    xt = np.asarray(jax.random.normal(jax.random.key(904), (60,),
                                      jnp.float64))
    b = A @ xt
    for precond in ["svd", "qr"]:
        cfg = SPLSConfig(precond=precond)
        x0, _, _, _ = spls(_t(A), _t(b), 0.0, cfg, rt.RNGState(905))
        x1, _, _, _ = spls(_t(A * s), _t(b * s), 0.0, cfg, rt.RNGState(905))
        np.testing.assert_allclose(x1.numpy(), x0.numpy(), rtol=1e-10)


@pytest.mark.parametrize("precond", [False, True])
def test_lsqr_parity_and_history(precond):
    """lsqr alone, plain (tests/test_psd_track.py:217, κ 50) and with the
    JAX package's M (κ 1e4), tol 1e-12: x, the φ̄ history, the zero rows
    past the stop and the iteration count. Plain LSQR needs 85-90
    iterations for 40 unknowns: past n the Lanczos vectors have lost
    orthogonality and the step that crosses tol is decided by rounding,
    so its count is held within 2, and the history is compared over the
    first 16 rows (the two packages' φ̄ agree to 1e-15 there, then their
    last-bit differences grow about 1e3-fold a step)."""
    if precond:
        A, xt, b = _problem()
        M, _, _, _ = j_right_precond_saso(jnp.asarray(A), 160, 0.0, JRNG(1))
        M, gate, slack = np.asarray(M), 100 * KAPPA * EPS, 1
    else:
        A, _ = mat_gen(MatGenInfo(300, 40, MatType.exponential,
                                  cond_num=50), JRNG(40))
        A = np.asarray(A)
        xt = np.asarray(jax.random.normal(jax.random.key(40), (40,),
                                          jnp.float64))
        b, M, gate, slack = A @ xt, None, 1e-10, 2
    jx, jh, jit = j_lsqr(jnp.asarray(A), jnp.asarray(b),
                         None if M is None else jnp.asarray(M),
                         JLSQRConfig(tol=1e-12, max_iters=500))
    x, h, it = lsqr(_t(A), _t(b)[:, None], None if M is None else _t(M),
                    LSQRConfig(tol=1e-12, max_iters=500))
    assert isinstance(it, int) and abs(it - int(jit)) <= slack
    assert _rel(x.numpy(), np.asarray(jx)) <= gate
    k = min(it, int(jit)) + 1 if M is not None else 16
    np.testing.assert_allclose(h[:k].numpy(), np.asarray(jh)[:k], rtol=0,
                               atol=1e-6 * float(jh[0]))
    assert h.shape == (501,) and not h[it + 1:].any()
    np.testing.assert_allclose(x.numpy(), xt, atol=1e-8 if M is None
                               else 1e-6)


def test_lsqr_zero_rhs_stops_at_once():
    A, _, _ = _problem()
    x, h, it = lsqr(_t(A), torch.zeros(300, dtype=torch.float64), None,
                    LSQRConfig())
    assert it == 0 and not x.any() and not h.any()


def test_rpc_data_svd_saso_parity():
    """σ of the sketch equal, V up to column signs; and
    tests/test_psd_track.py:150: A·M near-orthonormal at μ = 0."""
    A, st = mat_gen(MatGenInfo(3000, 50, MatType.exponential, cond_num=1e6),
                    JRNG(11))
    jV, js, jst = j_rpc_data_svd_saso(A, 400, st)
    op, _ = j_fill_sparse(JSparseDist(400, 3000, 8), st, dtype=jnp.float64)
    S = saso_from_numpy(dict(n_rows=400, n_cols=3000, vec_nnz=8), op.rows,
                        op.vals, device="cpu")
    V, s, nst = rpc_data_svd_saso(_t(A), 400, rt.RNGState(0), sketch=S)
    assert nst.counter == 2
    js, jV = np.asarray(js), np.asarray(jV)
    np.testing.assert_allclose(s.numpy(), js, rtol=0, atol=1e-12 * js[0])
    signs = np.sign(np.sum(V.numpy() * jV, axis=0))
    np.testing.assert_allclose(V.numpy() * signs, jV, rtol=0, atol=1e-10)
    M, rank = make_right_orthogonalizer(V, s, 0.0)
    assert int(rank) == 50
    assert float(util.cond_num_check(_t(A) @ M)) < 3.0


@pytest.mark.parametrize("case", ["refine", "norefine", "damped",
                                  "rank-deficient"])
def test_right_precond_saso_parity(case):
    """A·M's singular values, rank and ``fail`` against the JAX package
    (M itself is only defined up to V's column signs). The rank-deficient
    input (duplicated columns) takes the unit-diagonal pad of Ĝ."""
    A, _, _ = _problem(seed=3)
    if case == "rank-deficient":
        A = np.concatenate([A[:, :30], A[:, :10]], axis=1)
    mu = 1e-4 if case == "damped" else 0.0
    refine = case != "norefine"
    jM, jrank, jfail, jst = j_right_precond_saso(
        jnp.asarray(A), 160, mu, JRNG(5), refine=refine)
    S = _sketch(300, 40, 4.0, 8, 5)
    M, rank, fail, st = right_precond_saso(_t(A), 160, mu, rt.RNGState(5),
                                           refine=refine, sketch=S)
    assert int(rank) == int(jrank) and bool(fail) == bool(jfail) is False
    assert st.counter == int(jst.counter)
    sj = np.linalg.svd(A @ np.asarray(jM), compute_uv=False)
    sp = np.linalg.svd(A @ M.numpy(), compute_uv=False)
    np.testing.assert_allclose(sp, sj, rtol=0, atol=1e-10 * sj[0])


def test_injected_sketch_is_checked():
    A, _, b = _problem()
    with pytest.raises(RandLAPACKError, match="SparseSkOp"):
        spls(_t(A), _t(b), 0.0, SPLSConfig(), rt.RNGState(1),
             sketch=_sketch(300, 40, 2.0, 8, 1))
    with pytest.raises(RandLAPACKError, match="unknown precond"):
        spls(_t(A), _t(b), 0.0, SPLSConfig(precond="lu"), rt.RNGState(1))
