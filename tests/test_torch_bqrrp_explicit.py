"""The port's explicit-form BQRRP (randlapack_tpu_torch.drivers.bqrrp)
against the JAX package's on the CPU in f64, over the nine inputs of
tests/test_torch_bqrrp.py, with the JAX-drawn sketch injected into the
port (the two packages' random streams differ by design).

Gates: pivots J exactly equal; R within 1e-10 of max|R|; Q within 1e-10
absolute (its entries are O(1)); rank and ``fail`` equal. Past a
numerical rank the pivots fall among rounding-level columns, so there the
first ``rank`` pivots, rows of R and columns of Q are compared (as for
the factored form). Kahan's matrix is held to 1e-8, through its
numerical rank 127."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.drivers import BQRRPConfig as JCfg
from randlapack_tpu.drivers import QRTall as JQRTall
from randlapack_tpu.drivers import bqrrp as j_bqrrp
from randlapack_tpu.gen import MatGenInfo, MatType, kahan_matrix, mat_gen

import randlapack_tpu_torch as rt
from randlapack_tpu_torch.drivers import BQRRPConfig, QRTall, bqrrp
from randlapack_tpu_torch.errors import RandLAPACKError


def _gen(m, n, kind, seed=5, **kw):
    A, _ = mat_gen(MatGenInfo(m, n, kind, **kw), JRNG(seed))
    return np.asarray(A)


def _zero_columns(m, n, nzero, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * np.logspace(0, -4, n)
    A[:, rng.permutation(n)[:nzero]] = 0.0
    return A


def _jax_sketch(seed, d, m):
    """The sketch exactly as the explicit bqrrp draws it."""
    key, _ = JRNG(seed).spawn()
    return np.asarray(jax.random.normal(key, (d, m), dtype=jnp.float64)
                      / math.sqrt(d))


def _both(A, kw, seed, timing=False):
    m, n = A.shape
    b = min(kw["block_size"], m, n)
    jkw = dict(kw)
    if "qr_tall" in kw:
        jkw["qr_tall"] = JQRTall(kw["qr_tall"].value)
    extra = dict(timing=True) if timing else {}
    oj = j_bqrrp(jnp.asarray(A), JCfg(**jkw), JRNG(seed), **extra)
    ot = bqrrp(torch.tensor(A), BQRRPConfig(**kw), rt.RNGState(seed),
               sketch=torch.tensor(_jax_sketch(seed, int(1.25 * b), m)),
               **extra)
    return oj, ot


def _abs(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# (name, A builder, config, seed, R/Q gate, rows compared); the options
# (stages 1/2, update_defer 1/4, pivot_candidates None/2, qr_tall
# cholqr/hqr) are spread over the nine inputs
CASES = [
    ("square_b100_pc2", lambda: _gen(400, 400, MatType.polynomial,
                                     cond_num=1e6),
     dict(block_size=100, pivot_candidates=2), 5, 1e-10, None),
    ("tall_b75_stages2_defer4", lambda: _gen(500, 300, MatType.polynomial,
                                             cond_num=1e6),
     dict(block_size=75, pivot_candidates=2, stages=2, update_defer=4), 5,
     1e-10, None),
    ("wide_b50_hqr", lambda: _gen(200, 320, MatType.polynomial,
                                  cond_num=1e6),
     dict(block_size=50, pivot_candidates=2, qr_tall=QRTall.hqr), 5, 1e-10,
     None),
    ("full_width_lu_b64_defer4", lambda: _gen(256, 256, MatType.polynomial,
                                              cond_num=1e6),
     dict(block_size=64, update_defer=4), 5, 1e-10, None),
    ("headline_scaled_b64", lambda: _gen(512, 512, MatType.polynomial,
                                         cond_num=1e6),
     dict(block_size=64, pivot_candidates=2, stages=2, update_defer=4), 5,
     1e-10, None),
    ("remainder_300_hqr_stages2", lambda: _gen(300, 300, MatType.exponential,
                                               cond_num=1e5, seed=3),
     dict(block_size=64, stages=2, qr_tall=QRTall.hqr), 6, 1e-10, None),
    ("rank_deficient_60", lambda: _gen(300, 240, MatType.polynomial,
                                       cond_num=1e4, rank=60, seed=9),
     dict(block_size=60), 9, 1e-10, 60),
    ("zero_columns_defer4", lambda: _zero_columns(300, 240, 60, 3),
     dict(block_size=60, pivot_candidates=2, update_defer=4), 9, 1e-10,
     None),
    # numerical rank 127 (σ₁₂₈/σ₁ = 2.5e-22): Q's last column is a
    # rounding-level direction whose sign the two orders pick apart
    ("kahan_128", lambda: np.asarray(kahan_matrix(128, jnp.float64)),
     dict(block_size=32), 10, 1e-8, 127),
]


@pytest.mark.parametrize("name,make,kw,seed,tol,r", CASES,
                         ids=[c[0] for c in CASES])
def test_explicit_parity(name, make, kw, seed, tol, r):
    A = make()
    (Qj, Rj, Jj, rj, fj, _), (Qt, Rt, Jt, rk, ft, st) = _both(A, kw, seed)
    assert st.counter == 1
    K = min(A.shape)
    r = K if r is None else r
    Jj, Jt = np.asarray(Jj), Jt.numpy()
    np.testing.assert_array_equal(Jj[:r], Jt[:r])
    assert bool(fj) == bool(ft)
    assert int(rj) == int(rk)
    # R's leading r rows in the original column order (= Q[:, :r]ᵀ·A,
    # independent of how the columns past the rank were ordered)
    Rj_o = np.asarray(Rj)[:r][:, np.argsort(Jj)]
    Rt_o = Rt.numpy()[:r][:, np.argsort(Jt)]
    assert _abs(Rt_o, Rj_o) <= tol * np.abs(Rj_o).max()
    assert _abs(Qt[:, :r], np.asarray(Qj)[:, :r]) <= tol
    # the port's own factorization is exact and orthonormal
    res = np.linalg.norm(Qt.numpy() @ Rt.numpy() - A[:, Jt]) \
        / np.linalg.norm(A)
    assert res < 1e-13
    assert np.linalg.norm(Qt.numpy().T @ Qt.numpy() - np.eye(K)) < 1e-12


def test_explicit_timing_keys_and_outputs_match_jax():
    A = _gen(300, 300, MatType.exponential, cond_num=1e5, seed=3)
    kw = dict(block_size=64, stages=2)
    oj, ot = _both(A, kw, 6, timing=True)
    assert set(ot[-1]) == set(oj[-1]) == {"sketch", "stage_0", "stage_1",
                                          "stage_2", "final_orth"}
    np.testing.assert_array_equal(np.asarray(oj[2]), ot[2].numpy())
    assert _abs(ot[1], oj[1]) <= 1e-10 * np.abs(np.asarray(oj[1])).max()


def test_explicit_leaves_its_input_and_rejects_bad_options():
    A = torch.tensor(_gen(120, 80, MatType.polynomial, cond_num=1e3))
    A0 = A.clone()
    Q, R, J, rank, fail, st = bqrrp(A, BQRRPConfig(block_size=16,
                                                   stages=5),
                                    rt.RNGState(1),
                                    sketch=torch.eye(20, 120,
                                                     dtype=torch.float64))
    assert torch.equal(A, A0)
    assert (Q.shape, R.shape, J.shape) == ((120, 80), (80, 80), (80,))
    with pytest.raises(RandLAPACKError):
        bqrrp(A, BQRRPConfig(block_size=16), rt.RNGState(1),
              sketch=torch.zeros(19, 120, dtype=torch.float64))
    # "default" was refused until the trailing modes were ported; on the
    # CPU it is the "highest" product, bit for bit
    runs = [bqrrp(A, BQRRPConfig(block_size=16, **kw), rt.RNGState(1))
            for kw in ({"trailing_precision": "default"}, {})]
    assert all(torch.equal(x, y) for x, y in zip(*runs)
               if isinstance(x, torch.Tensor))
    # precision="high" was refused until the driver-level precision was
    # ported; on the CPU it is the "highest" product, bit for bit
    runs = [bqrrp(A, BQRRPConfig(block_size=16), rt.RNGState(1),
                  precision=p) for p in ("high", "highest")]
    assert all(torch.equal(x, y) for x, y in zip(*runs)
               if isinstance(x, torch.Tensor))
