"""The port's factored BQRRP (randlapack_tpu_torch.drivers) against the
JAX package's on the CPU in f64, with the JAX-drawn sketch injected into
the port (the two packages' random streams differ by design).

Gates: pivots J exactly equal; R within 1e-10 of max|R|; Q (via
bqrrp_q) and Qᵀ·A[:, J] (via bqrrp_apply_qt) within 1e-10 absolute
(their entries are O(1)). Measured agreement is ~1e-15 on R and up to
~1.5e-11 on Q: Q's trailing columns move by ~eps·κ(panel) under the
change of summation order (MKL vs XLA's CPU dot), amplified through the
CholQR chain. Kahan's matrix is held to 1e-8 (its R spans 38 orders of
magnitude)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.drivers import BQRRPConfig as JCfg
from randlapack_tpu.drivers import BQRRPFactors as JFactors
from randlapack_tpu.drivers import bqrrp_apply_qt as j_apply_qt
from randlapack_tpu.drivers import bqrrp_factored as j_factored
from randlapack_tpu.drivers import bqrrp_q as j_q
from randlapack_tpu.gen import MatGenInfo, MatType, kahan_matrix, mat_gen

import randlapack_tpu_torch as rt
from randlapack_tpu_torch.drivers import (BQRRPConfig, bqrrp_apply_qt,
                                          bqrrp_factored, bqrrp_q)
from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.interop import factors_from_numpy, factors_to_numpy

EPS32 = float(np.finfo(np.float32).eps)


def _gen(m, n, kind, seed=5, **kw):
    A, _ = mat_gen(MatGenInfo(m, n, kind, **kw), JRNG(seed))
    return np.asarray(A)


def _zero_columns(m, n, nzero, seed):
    """Decaying Gaussian matrix with ``nzero`` exactly-zero columns: the
    deficiency is structural, so every pivot past the rank is decided by
    exact arithmetic (the LU δ pad), not rounding noise."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * np.logspace(0, -4, n)
    A[:, rng.permutation(n)[:nzero]] = 0.0
    return A


def _jax_sketch(seed, d, m):
    """The sketch exactly as bqrrp.py:905-906 draws it."""
    key, _ = JRNG(seed).spawn()
    return np.asarray(jax.random.normal(key, (d, m), dtype=jnp.float64)
                      / math.sqrt(d))


def _both(A, kw, seed):
    m, n = A.shape
    b = min(kw["block_size"], m, n)
    fj, _ = j_factored(jnp.asarray(A), JCfg(**kw), JRNG(seed))
    ft, st = bqrrp_factored(
        torch.tensor(A), BQRRPConfig(**kw), rt.RNGState(seed),
        sketch=torch.tensor(_jax_sketch(seed, int(1.25 * b), m)))
    assert st.counter == 1
    return fj, ft


def _abs(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# (name, A builder, config, seed, J/R/Q gate, rows compared)
CASES = [
    ("square_b100_pc2", lambda: _gen(400, 400, MatType.polynomial,
                                     cond_num=1e6),
     dict(block_size=100, pivot_candidates=2), 5, 1e-10, None),
    ("tall_b75", lambda: _gen(500, 300, MatType.polynomial, cond_num=1e6),
     dict(block_size=75, pivot_candidates=2), 5, 1e-10, None),
    ("wide_b50", lambda: _gen(200, 320, MatType.polynomial, cond_num=1e6),
     dict(block_size=50, pivot_candidates=2), 5, 1e-10, None),
    ("full_width_lu_b64", lambda: _gen(256, 256, MatType.polynomial,
                                       cond_num=1e6),
     dict(block_size=64), 5, 1e-10, None),
    ("headline_scaled_b64", lambda: _gen(512, 512, MatType.polynomial,
                                         cond_num=1e6),
     dict(block_size=64, pivot_candidates=2, stages=2, update_defer=4), 5,
     1e-10, None),
    ("remainder_300_defer4", lambda: _gen(300, 300, MatType.exponential,
                                          cond_num=1e5, seed=3),
     dict(block_size=64, update_defer=4), 6, 1e-10, None),
    # numerical rank 60: past it the pivot pass chooses among columns of
    # rounding-level norm, where the two summation orders legitimately
    # pick different columns (measured: J equal on the first 60 and not
    # after). The first 60 pivots, rows and Q columns are compared.
    ("rank_deficient_60", lambda: _gen(300, 240, MatType.polynomial,
                                       cond_num=1e4, rank=60, seed=9),
     dict(block_size=60), 9, 1e-10, 60),
    ("zero_columns", lambda: _zero_columns(300, 240, 60, 3),
     dict(block_size=60, pivot_candidates=2), 9, 1e-10, None),
    ("kahan_128", lambda: np.asarray(kahan_matrix(128, jnp.float64)),
     dict(block_size=32), 10, 1e-8, None),
]


@pytest.mark.parametrize("name,make,kw,seed,tol,r", CASES,
                         ids=[c[0] for c in CASES])
def test_factored_parity(name, make, kw, seed, tol, r):
    A = make()
    fj, ft = _both(A, kw, seed)
    K = min(A.shape)
    r = K if r is None else r
    Jj, Jt = np.asarray(fj.J), ft.J.numpy()
    np.testing.assert_array_equal(Jj[:r], Jt[:r])
    assert bool(fj.fail) == bool(ft.fail)
    assert int(fj.rank) == int(ft.rank)
    # R's leading r rows in the original column order (= Q[:, :r]ᵀ·A,
    # independent of how the columns past the rank were ordered)
    Rj = np.asarray(fj.R)[:r][:, np.argsort(Jj)]
    Rt = ft.R.numpy()[:r][:, np.argsort(Jt)]
    assert _abs(Rt, Rj) <= tol * np.abs(Rj).max()
    Qj, Qt = np.asarray(j_q(fj)), bqrrp_q(ft).numpy()
    assert _abs(Qt[:, :r], Qj[:, :r]) <= tol
    AJ = A[:, Jt]
    Xj = np.asarray(j_apply_qt(fj, jnp.asarray(A[:, Jj])))[:r]
    Xt = bqrrp_apply_qt(ft, torch.tensor(AJ)).numpy()[:r]
    assert _abs(Xt[:, np.argsort(Jt)], Xj[:, np.argsort(Jj)]) \
        <= tol * np.abs(A).max()
    # the port's own factorization is exact whatever the late pivots were
    res = np.linalg.norm(Qt @ ft.R.numpy() - AJ) / np.linalg.norm(A)
    assert res < 1e-13


def test_interop_factors_round_trip():
    A = _gen(240, 180, MatType.polynomial, cond_num=1e6)
    kw = dict(block_size=60, update_defer=2)
    fj, ft = _both(A, kw, 4)
    arrays = {f: np.asarray(getattr(fj, f)) for f in JFactors._fields}
    fac = factors_from_numpy(arrays, device="cpu")
    assert fac.J.dtype == torch.int64 and fac.fail.dtype == torch.bool
    Qj = np.asarray(j_q(fj))
    assert _abs(bqrrp_q(fac).numpy(), Qj) <= 1e-12
    back = JFactors(**{k: jnp.asarray(v)
                       for k, v in factors_to_numpy(ft).items()})
    assert _abs(np.asarray(j_q(back)), bqrrp_q(ft).numpy()) <= 1e-12


def test_q_methods_and_partial_q():
    A = torch.tensor(_gen(250, 180, MatType.polynomial, cond_num=1e6))
    fac, _ = bqrrp_factored(A, BQRRPConfig(block_size=50), rt.RNGState(5))
    Qs = bqrrp_q(fac)
    assert _abs(bqrrp_q(fac, method="tree"), Qs) < 1e-13
    assert _abs(bqrrp_q(fac, k=50, method="tree"), Qs[:, :50]) < 1e-13
    assert _abs(bqrrp_q(fac, k=50), Qs[:, :50]) < 1e-13


def test_drawn_sketch_quality_and_state():
    """Without an injected sketch: deterministic in the state, leaves A
    untouched, and meets the JAX tests' residual/orthogonality gates."""
    A = torch.tensor(_gen(320, 256, MatType.polynomial, cond_num=1e6))
    A0 = A.clone()
    cfg = BQRRPConfig(block_size=64, pivot_candidates=2, stages=2,
                      update_defer=2)
    fac, st = bqrrp_factored(A, cfg, rt.RNGState(1))
    fac2, _ = bqrrp_factored(A, cfg, rt.RNGState(1))
    assert torch.equal(A, A0) and st.counter == 1
    assert torch.equal(fac.J, fac2.J) and torch.equal(fac.R, fac2.R)
    assert sorted(fac.J.tolist()) == list(range(256)) and not bool(fac.fail)
    Q = bqrrp_q(fac)
    atol = np.finfo(np.float64).eps ** 0.75
    res = float(torch.linalg.norm(Q @ fac.R - A[:, fac.J])
                / torch.linalg.norm(A))
    orth = float(torch.linalg.norm(Q.T @ Q - torch.eye(256,
                                                       dtype=Q.dtype)))
    assert res < 10 * atol and orth < 10 * atol * np.sqrt(256)


def test_float32_headline_config_gates():
    """The headline configuration scaled to b = 64, in f32 on the CPU,
    against the f32 gates chip_smoke.py applies at 8192²."""
    A, _ = rt.gen.fast_decay_matrix(512, 512, rt.RNGState(0),
                                     device="cpu")
    cfg = BQRRPConfig(block_size=64, pivot_candidates=2, stages=2,
                      update_defer=4)
    fac, _ = bqrrp_factored(A, cfg, rt.RNGState(1))
    Q = bqrrp_q(fac)
    gate = 10 * EPS32 ** 0.75
    res = float(torch.linalg.norm(Q @ fac.R - A[:, fac.J])
                / torch.linalg.norm(A))
    orth = float(torch.linalg.norm(Q.T @ Q - torch.eye(512)))
    assert not bool(fac.fail)
    assert res <= gate and orth <= gate * math.sqrt(512), (res, orth)


def test_timing_dict():
    A = torch.tensor(_gen(120, 120, MatType.gaussian))
    out = bqrrp_factored(A, BQRRPConfig(block_size=40, stages=3),
                         rt.RNGState(11), timing=True)
    assert {"sketch", "stage_0", "stage_2", "epilogue"} <= set(out[2])


@pytest.mark.parametrize("field,value,exc", [
    ("pallas_trailing", "never", NotImplementedError),
    # refused until the row-sharded mode was ported (the id is kept): now
    # it needs a mesh of that axis set (parallel.set_mesh), and with none
    # it raises ValueError
    pytest.param("shard_axis", "rows", ValueError,
                 id="shard_axis-rows-NotImplementedError"),
    # refused until the trailing modes were ported (the id is kept): now
    # it runs, and on the CPU "default" is the "highest" product
    pytest.param("trailing_precision", "default", None,
                 id="trailing_precision-default-NotImplementedError"),
])
def test_tpu_only_options_refused(field, value, exc):
    A = torch.eye(8, dtype=torch.float64)
    if exc is None:
        A = torch.tensor(_gen(96, 80, MatType.polynomial, cond_num=1e4))
        runs = [bqrrp_factored(A, BQRRPConfig(block_size=16, update_defer=2,
                                              **kw), rt.RNGState(0))[0]
                for kw in ({field: value}, {})]
        assert all(torch.equal(x, y) for x, y in zip(*runs))
        assert not bool(runs[0].fail)
        return
    with pytest.raises(exc):
        bqrrp_factored(A, BQRRPConfig(block_size=4, **{field: value}),
                       rt.RNGState(0))


def test_tf32_refused_and_bad_sketch_shape():
    A = torch.eye(8, dtype=torch.float64)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        with pytest.raises(RandLAPACKError):
            bqrrp_factored(A, BQRRPConfig(block_size=4), rt.RNGState(0))
    finally:
        torch.set_float32_matmul_precision(prev)
    with pytest.raises(RandLAPACKError):
        bqrrp_factored(A, BQRRPConfig(block_size=4), rt.RNGState(0),
                       sketch=torch.zeros(3, 8, dtype=torch.float64))
