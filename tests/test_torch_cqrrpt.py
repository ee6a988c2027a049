"""The port's CQRRPT and CQRRT (randlapack_tpu_torch.drivers) against the
JAX package's on the CPU in f64. Every random draw is made by JAX as its
driver makes it and injected into the port: the sketch operator (SASO
rows and values, SRHT signs and rows, or the dense Gaussian S, carried
through ``interop``), the sketch QRCP's own sketch (BQRRP's Gaussian,
HQRRP's uniform G) and the Gaussians of the basis completion. The inputs
are built as the JAX package's tests build them (``mat_gen``,
``RNGState``).

Gates: pivots J, rank and ``fail`` equal; the leading-rank columns of Q
and rows of R within 1e-10 (Q absolute, its entries are O(1); R of
max|R|). Past the rank the pivots fall among rounding-level columns, so
only the leading ``rank`` are compared there; where the rank itself is
decided by rounding, parity is held at a threshold above it (see
``_duplicated``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.drivers import CQRRPTConfig as JPCfg
from randlapack_tpu.drivers import CQRRTConfig as JTCfg
from randlapack_tpu.drivers import QRCPKind as JQRCP
from randlapack_tpu.drivers import SketchKind as JSketch
from randlapack_tpu.drivers import cqrrpt as j_cqrrpt
from randlapack_tpu.drivers import cqrrt as j_cqrrt
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen
from randlapack_tpu.sketching import SparseDist as JSparseDist
from randlapack_tpu.sketching import fill_sparse as j_fill_sparse
from randlapack_tpu.sketching import srht_skop as j_srht_skop

import randlapack_tpu_torch as rt
from randlapack_tpu_torch.drivers import (CQRRPTConfig, CQRRTConfig,
                                          QRCPKind, SketchKind, cqrrpt, cqrrt)
from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.interop import saso_from_numpy, srht_from_numpy

TOL = 1e-10


def _gen(m, n, kind, seed, **kw):
    A, st = mat_gen(MatGenInfo(m, n, kind, **kw), JRNG(seed))
    return np.asarray(A), st


def _draws(A, cfg, st, qrcp=None, bqrrp_block=128, orth=False):
    """The JAX drivers' draws from ``st``, in their order: the sketch
    operator, then the sketch QRCP's sketch (``qrcp``), then the
    completion Gaussians (``orth``). Returns them as the port takes
    them: ``(sketch, qrcp_sketch, noise)``."""
    m, n = A.shape
    d = int(cfg.d_factor * n)
    kind = getattr(cfg.sketch, "value", cfg.sketch)
    if d >= m:           # A itself is the sketch: no draw
        op, d = None, m
    elif kind == "saso":
        jop, st = j_fill_sparse(JSparseDist(d, m, cfg.vec_nnz), st,
                                dtype=jnp.float64)
        op = saso_from_numpy(dict(n_rows=d, n_cols=m, vec_nnz=cfg.vec_nnz),
                             jop.rows, jop.vals, device="cpu")
    elif kind == "srht":
        jop, st = j_srht_skop(d, m, st, dtype=jnp.float64)
        op = srht_from_numpy(d, m, jop.signs, jop.rows, device="cpu")
    else:
        key, st = st.spawn()
        op = torch.tensor(np.asarray(jax.random.normal(
            key, (d, m), dtype=jnp.float64) / math.sqrt(d)))
    qs = None
    b = min(bqrrp_block, d, n)
    if qrcp == "bqrrp":
        key, st = st.spawn()
        db = int(1.25 * b)
        qs = torch.tensor(np.asarray(jax.random.normal(
            key, (db, d), dtype=jnp.float64) / math.sqrt(db)))
    elif qrcp == "hqrrp":
        key, st = st.spawn()
        qs = torch.tensor(np.asarray(jax.random.uniform(
            key, (b + 10, d), dtype=jnp.float64, minval=-1.0, maxval=1.0)))
    noise = None
    if orth:
        key, st = st.spawn()
        noise = torch.tensor(np.asarray(jax.random.normal(
            key, (m, n), dtype=jnp.float64)))
    return op, qs, noise


def _cqrrpt_both(A, st, kw, timing=False):
    jkw, tkw = dict(kw), dict(kw)
    if "qrcp" in kw:
        jkw["qrcp"] = JQRCP(kw["qrcp"])
        tkw["qrcp"] = QRCPKind(kw["qrcp"])
    jcfg, tcfg = JPCfg(**jkw), CQRRPTConfig(**tkw)
    extra = dict(timing=True) if timing else {}
    oj = j_cqrrpt(jnp.asarray(A), jcfg, st, **extra)
    op, qs, noise = _draws(A, jcfg, st, kw.get("qrcp"), jcfg.bqrrp_block,
                           jcfg.orthogonalization)
    ot = cqrrpt(torch.tensor(A), tcfg, rt.RNGState(1), sketch=op,
                qrcp_sketch=qs, noise=noise, **extra)
    return oj, ot


def _abs(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _check_cqrrpt(oj, ot, A, full_orth=False, duplicates=False):
    """The parity gates; returns the rank. With ``duplicates`` (inputs
    holding exact copies of columns) a pivot may pick either copy by
    rounding, so the chosen COLUMNS are held equal instead of J."""
    Qj, Rj, Jj, rj, fj = (np.asarray(x) for x in oj[:5])
    Qt, Rt, Jt, rk, ft = (x.numpy() for x in ot[:5])
    r = int(rj)
    assert r == int(rk)
    assert bool(fj) == bool(ft)
    if duplicates:
        np.testing.assert_array_equal(A[:, Jj[:r]], A[:, Jt[:r]])
    else:
        np.testing.assert_array_equal(Jj[:r], Jt[:r])
    assert sorted(Jt.tolist()) == list(range(len(Jt)))
    assert _abs(Qt[:, :r], Qj[:, :r]) <= TOL
    # R's leading rows in the original column order (= Q[:, :r]ᵀ·A)
    Rj_o, Rt_o = Rj[:r][:, np.argsort(Jj)], Rt[:r][:, np.argsort(Jt)]
    assert _abs(Rt_o, Rj_o) <= TOL * np.abs(Rj_o).max()
    if full_orth:
        n = Qt.shape[1]
        assert np.linalg.norm(Qt.T @ Qt - np.eye(n)) < 1e-9 * math.sqrt(n)
    return r


POLY, POLY_ST = _gen(1000, 96, MatType.polynomial, 2, cond_num=1e6)


@pytest.mark.parametrize("qrcp", ["geqp3", "hqrrp", "bqrrp"])
@pytest.mark.parametrize("sketch", ["saso", "srht", "gaussian"])
def test_cqrrpt_sketch_and_qrcp_grid(sketch, qrcp):
    oj, ot = _cqrrpt_both(POLY, POLY_ST, dict(sketch=sketch, qrcp=qrcp,
                                              bqrrp_block=32))
    assert _check_cqrrpt(oj, ot, POLY) == 96
    # injected draws advance the port's state as its own draws would
    assert ot[-1].counter == (1 if sketch == "gaussian" else 2) + (
        qrcp != "geqp3")


@pytest.mark.parametrize("kw", [
    dict(trsm_mode="blockinv", trsm_block=32),
    dict(trsm_mode="blockinv", trsm_block=32, sketch="srht",
         qrcp="bqrrp", bqrrp_block=32, bqrrp_pivot_candidates=2,
         bqrrp_update_defer=2),
    dict(q_form="trsm"),
    dict(gram_block=0),
    dict(gram_block=32),
], ids=["blockinv", "blockinv_bench_shape", "q_trsm", "gram_full",
        "gram_syrk_32"])
def test_cqrrpt_options(kw):
    oj, ot = _cqrrpt_both(POLY, POLY_ST, kw)
    assert _check_cqrrpt(oj, ot, POLY) == 96


def _duplicated(seed, ncopy):
    """tests/test_qr_drivers.py's rank-deficient inputs: a 1500×50 matrix
    with copies of its first ``ncopy`` columns appended (rank 50)."""
    A, st = _gen(1500, 50, MatType.exponential, seed, cond_num=100)
    return np.concatenate([A, A[:, :ncopy]], axis=1), st


# Past rank 50 the sketch's R diagonal of these inputs is rounding noise
# (|r₅₀|/|r₀₀| 1.6e-16 in JAX's geqp3 and 2.9e-16 in the port's: other
# summation orders) and the default threshold eps·|r₀₀| = 2.2e-16 sits in
# that noise, so each package's rank is 50–52 by rounding, as the JAX
# tests allow (test_basis_completion). Parity is held at a threshold
# above the noise (eps_rank 1e-12); the default runs are held to the
# JAX tests' own gates.

def test_cqrrpt_rank_deficient():
    A, st = _duplicated(3, 50)   # test_rank_deficient's matrix
    oj, ot = _cqrrpt_both(A, st, dict(eps_rank=1e-12))
    assert _check_cqrrpt(oj, ot, A, duplicates=True) == 50
    oj, ot = _cqrrpt_both(A, st, {})
    Q, R, J, rank, fail, _ = ot
    assert 50 <= int(rank) <= 52 and not bool(fail) and not bool(oj[4])
    r = min(int(rank), int(oj[3]))
    assert _abs(Q[:, :r], np.asarray(oj[0])[:, :r]) <= TOL
    res = torch.linalg.norm(Q[:, :50] @ R[:50] - torch.tensor(A)[:, J])
    assert float(res) < 1e-12 * np.linalg.norm(A)


def test_cqrrpt_orthogonalization_completes_the_basis():
    A, st = _duplicated(30, 30)  # test_basis_completion's matrix
    oj, ot = _cqrrpt_both(A, st, dict(orthogonalization=True,
                                      eps_rank=1e-12))
    assert _check_cqrrpt(oj, ot, A, full_orth=True, duplicates=True) == 50
    # the completed columns agree too: the same Gaussians, projected
    assert _abs(ot[0].numpy(), np.asarray(oj[0])) <= TOL
    _, ot = _cqrrpt_both(A, st, dict(orthogonalization=True))
    Q, R, J, rank, fail, _ = ot
    assert 50 <= int(rank) <= 52
    assert float(torch.linalg.norm(Q.T @ Q - torch.eye(80, dtype=Q.dtype))) \
        < 1e-9 * math.sqrt(80)


@pytest.mark.parametrize("kw", [dict(), dict(trsm_mode="blockinv",
                                             trsm_block=32,
                                             orthogonalization=True)],
                         ids=["default", "blockinv_orth"])
def test_cqrrpt_timing_keys_and_outputs_match_jax(kw):
    # with blockinv the timed path gathers A[:, J] as its own phase
    oj, ot = _cqrrpt_both(POLY, POLY_ST, kw, timing=True)
    assert set(ot[-1]) == set(oj[-1])
    assert {"saso", "qrcp", "rank_reveal", "a_mod_piv", "a_mod_trsm",
            "cholqr", "cholqr_gram", "cholqr_potrf", "cholqr_qform",
            "cholqr_unprec"} <= set(ot[-1])
    assert _check_cqrrpt(oj, ot[:-1], POLY) == 96


def test_cqrrpt_near_square_uses_A_as_its_sketch():
    A, st = _gen(110, 100, MatType.polynomial, 4, cond_num=1e4)
    oj, ot = _cqrrpt_both(A, st, {})
    assert _check_cqrrpt(oj, ot, POLY) == 100


def test_cqrrpt_rejects_wide_input_and_mismatched_sketches():
    A = torch.tensor(POLY)
    with pytest.raises(RandLAPACKError):
        cqrrpt(A.T.contiguous(), CQRRPTConfig(), rt.RNGState(0))
    op, _, _ = _draws(POLY, JPCfg(sketch="srht"), POLY_ST)
    with pytest.raises(RandLAPACKError):
        cqrrpt(A, CQRRPTConfig(sketch="saso"), rt.RNGState(0), sketch=op)
    with pytest.raises(RandLAPACKError):
        cqrrpt(A, CQRRPTConfig(sketch="gaussian"), rt.RNGState(0),
               sketch=torch.zeros(5, 1000, dtype=torch.float64))
    # precision="default" was refused until the driver-level precision was
    # ported; on the CPU it is the "highest" product, bit for bit
    runs = [cqrrpt(A, CQRRPTConfig(), rt.RNGState(0), precision=p)
            for p in ("default", "highest")]
    assert all(torch.equal(x, y) for x, y in zip(*runs)
               if isinstance(x, torch.Tensor))


def test_cqrrpt_draws_its_own_operators_from_state():
    A = torch.tensor(POLY)
    for sketch in ("saso", "srht", "gaussian"):
        Q, R, J, rank, fail, st = cqrrpt(
            A, CQRRPTConfig(sketch=sketch, qrcp=QRCPKind.bqrrp,
                            bqrrp_block=32, orthogonalization=True),
            rt.RNGState(9))
        assert st.counter == (2 if sketch != "gaussian" else 1) + 2
        assert not bool(fail) and int(rank) == 96
        res = torch.linalg.norm(Q @ R - A[:, J]) / torch.linalg.norm(A)
        assert float(res) < 1e-12


# -- CQRRT ------------------------------------------------------------------

def _cqrrt_both(A, st, kw, timing=False):
    jkw, tkw = dict(kw), dict(kw)
    if "sketch" in kw:
        jkw["sketch"] = JSketch(kw["sketch"])
        tkw["sketch"] = SketchKind(kw["sketch"])
    jcfg, tcfg = JTCfg(**jkw), CQRRTConfig(**tkw)
    extra = dict(timing=True) if timing else {}
    oj = j_cqrrt(jnp.asarray(A), jcfg, st, **extra)
    op, _, noise = _draws(A, jcfg, st, orth=jcfg.orthogonalization)
    ot = cqrrt(torch.tensor(A), tcfg, rt.RNGState(1), sketch=op,
               noise=noise, **extra)
    return oj, ot


# cond 1e4: Q moves by ~eps·κ under the change of summation order
EXPO, EXPO_ST = _gen(2000, 100, MatType.exponential, 0, cond_num=1e4)


@pytest.mark.parametrize("sketch", ["saso", "srht", "gaussian"])
def test_cqrrt_sketches(sketch):
    (Qj, Rj, fj, _), (Qt, Rt, ft, st) = _cqrrt_both(EXPO, EXPO_ST,
                                                    dict(sketch=sketch))
    assert bool(fj) == bool(ft) is False
    assert _abs(Qt, Qj) <= TOL
    assert _abs(Rt, Rj) <= TOL * np.abs(np.asarray(Rj)).max()
    assert float(torch.linalg.norm(torch.tril(Rt, -1))) == 0.0


def test_cqrrt_qless_and_timed():
    (Qj, Rj, fj, _), (Qt, Rt, ft, _) = _cqrrt_both(
        EXPO, EXPO_ST, dict(compute_q=False))
    assert Qj is None and Qt is None and bool(fj) == bool(ft)
    assert _abs(Rt, Rj) <= TOL * np.abs(np.asarray(Rj)).max()
    oj, ot = _cqrrt_both(EXPO, EXPO_ST, dict(sketch="srht"), timing=True)
    assert set(ot[-1]) == set(oj[-1]) == {"saso", "qr", "precond", "gram",
                                          "potrf", "q", "finalize"}
    assert _abs(ot[0], oj[0]) <= TOL


def test_cqrrt_orthogonalization_five_tuple():
    A, st = _duplicated(60, 30)  # test_basis_completion_trailing's matrix
    oj, ot = _cqrrt_both(A, st, dict(orthogonalization=True,
                                     eps_rank=1e-12))
    Qj, Rj, rj, fj, _ = oj
    Qt, Rt, rk, ft, _ = ot
    assert int(rj) == int(rk) == 50
    assert bool(fj) == bool(ft)
    assert _abs(Qt, Qj) <= TOL
    assert _abs(Rt, Rj) <= TOL * np.abs(np.asarray(Rj)).max()
    oj, ot = _cqrrt_both(A, st, dict(orthogonalization=True), timing=True)
    assert set(ot[-1]) == set(oj[-1]) == {"total"}
    Qt, Rt, rk, ft, _, _ = ot
    assert 50 <= int(rk) <= 52
    eye = torch.eye(80, dtype=Qt.dtype)
    assert float(torch.linalg.norm(Qt.T @ Qt - eye)) < 1e-9 * math.sqrt(80)
    At = torch.tensor(A)
    assert float(torch.linalg.norm(At - Qt @ (Qt.T @ At))
                 / torch.linalg.norm(At)) < 10 * np.finfo(float).eps ** 0.75


def test_cqrrt_boundary_columns_colscale():
    # tests/test_qr_drivers.py::test_boundary_columns_colscale's input:
    # columns scaled across ~20 decades put kept columns at the eps·max
    # cutoff; `not fail` and the orthogonality bound are asserted apart
    A, st = _gen(800, 100, MatType.exponential, 850004, cond_num=1e6)
    rng = np.random.RandomState(7)
    scales = 10.0 ** rng.uniform(-18, 2, size=100)
    A = A * scales[None, :] * 1e-12
    oj, ot = _cqrrt_both(A, st, dict(sketch="saso", d_factor=1.25,
                                     orthogonalization=True))
    Qt, Rt, rk, ft, _ = ot
    assert not bool(ft)
    orth = float(torch.linalg.norm(Qt.T @ Qt - torch.eye(100,
                                   dtype=Qt.dtype)))
    assert orth < 1e-11 * math.sqrt(100)
    assert int(rk) == int(oj[2]) and not bool(oj[3])
    assert _abs(Qt, oj[0]) <= TOL
