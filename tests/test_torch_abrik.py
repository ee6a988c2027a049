"""The port's ABRIK (randlapack_tpu_torch.drivers.abrik) and Q-less CholQR
over operators (drivers.cholqr_linops) against the JAX package's on the
CPU in f64, over plain tensors and the dense, sparse and composite
operators. Inputs are built by the JAX generators; every random draw is
made by JAX as its function makes it and injected: ABRIK's start
(``v0=``, from ``state.spawn()``) and, in "cqrrt" mode, its 2q QR
sketches (``qr_sketches=``, from ``jax.random.split`` of a second
spawn), ``cqrrt_linops``' Gaussian (``sketch=``).

Gates. ABRIK: ``iters``, the zero pattern of the stopped blocks and the
``timing=True`` slot names equal; ``capture`` within 1e-12 relative; S
within 1e-10·σ₀; U, V and B within 1e-9 after aligning each column's
sign (both packages take LAPACK's Householder QR, so the signs agree,
but the alignment keeps the gate about the subspaces). CholQR: ``fail``
equal (also on the non-finite Gram path); the Grams within 1e-13 of
their largest entry; R within 1e-10·‖R‖; ``materialize_q`` within 1e-9.
Two implementations agree on Q only to the method's own error bound, so
the inputs whose Q is compared are conditioned to keep it below the
gate: κ 1e3 for one-pass CholQR (eps·κ² ≈ 1e-10), κ 1e6 for CQRRT and
the materialized sCholQR3 (eps·κ ≈ 1e-10); sCholQR3 over operators runs
at κ 1e7.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.drivers import ABRIKConfig as JABRIKConfig
from randlapack_tpu.drivers import CholQRLinopsConfig as JCholCfg
from randlapack_tpu.drivers import CQRRTLinopsConfig as JCQRRTCfg
from randlapack_tpu.drivers import abrik as j_abrik
from randlapack_tpu.drivers import abrik_factor as j_abrik_factor
from randlapack_tpu.drivers import cholqr_linops as j_cholqr_linops
from randlapack_tpu.drivers import cqrrt_linops as j_cqrrt_linops
from randlapack_tpu.drivers import materialize_q as j_materialize_q
from randlapack_tpu.drivers import scholqr3_linops as j_scholqr3_linops
from randlapack_tpu.drivers import \
    scholqr3_linops_basic as j_scholqr3_linops_basic
from randlapack_tpu.drivers.cholqr_linops import \
    blocked_gram as j_blocked_gram
from randlapack_tpu.drivers.cholqr_linops import \
    blocked_gram_precond as j_blocked_gram_precond
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen
from randlapack_tpu.gen import gen_exp_singvals
from randlapack_tpu.linops import CompositeLinOp as JComposite
from randlapack_tpu.linops import DenseLinOp as JDense
from randlapack_tpu.linops import SparseLinOp as JSparse

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import linops as tl
from randlapack_tpu_torch.drivers import (ABRIKConfig, CholQRLinopsConfig,
                                          CQRRTLinopsConfig, abrik,
                                          abrik_factor, blocked_gram,
                                          blocked_gram_precond,
                                          cholqr_linops, cqrrt_linops,
                                          materialize_q, scholqr3_linops,
                                          scholqr3_linops_basic)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops in loops: one intra-op thread keeps each at its
    own cost beside other test processes. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(x):
    return torch.tensor(np.asarray(x))


def _tstate(st, seed=0):
    return rt.RNGState(seed, _counter=int(st.counter))


def _matrix(m, n, kind="polynomial", seed=1, **kw):
    A, _ = mat_gen(MatGenInfo(m, n, MatType(kind), **kw), JRNG(seed))
    return np.array(A)


def _sparsify(A, density, seed):
    mask = np.random.default_rng(seed).random(A.shape) < density
    return A * mask


def _ops(kind, A):
    """``A`` as a JAX and a port operator of ``kind`` (a composite is
    A = A·I split as (A·P)·Pᵀ with an orthogonal P)."""
    if kind == "tensor":
        return jnp.asarray(A), _t(A)
    if kind == "dense":
        return JDense(jnp.asarray(A)), tl.DenseLinOp(_t(A))
    if kind == "sparse":
        rows, cols = np.nonzero(A)
        return (JSparse.from_coo(rows, cols, A[rows, cols], A.shape),
                tl.SparseLinOp.from_coo(rows, cols, A[rows, cols], A.shape,
                                        device="cpu"))
    P, _ = np.linalg.qr(np.random.default_rng(9).standard_normal(
        (A.shape[1], A.shape[1])))
    AP = A @ P
    return (JComposite(JDense(jnp.asarray(AP)), JDense(jnp.asarray(P.T))),
            tl.CompositeLinOp(tl.DenseLinOp(_t(AP)), tl.DenseLinOp(_t(P.T))))


# -- ABRIK --------------------------------------------------------------------

def _abrik_draws(st, m, n, cfg):
    """ABRIK's draws as the JAX package makes them from ``st``."""
    b, q = cfg.block_size, cfg.max_iters
    key, st = st.spawn()
    v0 = _t(jax.random.normal(key, (n, b), dtype=jnp.float64))
    if cfg.qr_explicit == "geqrf":
        return v0, None
    kq, _ = st.spawn()
    keys = jax.random.split(kq, 2 * q)
    sketches = []
    for i in range(2 * q):
        rows = n if (i % 2 == 0 and i > 0) else m
        d = min(rows, int(math.ceil(cfg.d_factor * b)))
        sketches.append(None if i == 1 else _t(jax.random.normal(
            keys[i], (d, rows), dtype=jnp.float64)))
    return v0, sketches


def _col_signs(ref, x):
    s = np.sign(np.sum(_np(ref) * _np(x), axis=0))
    return np.where(s == 0, 1.0, s)


def _check_factor(jout, tout):
    Uj, Vj, Bj, cj, ij, stj = jout
    Ut, Vt, Bt, ct, it, stt = tout
    assert it == int(ij) and stt.counter == int(stj.counter)
    for a, b in ((Ut, Uj), (Vt, Vj), (Bt, Bj)):
        assert np.array_equal(_np(a) == 0, np.asarray(b) == 0)
    assert _rel(ct, cj) <= 1e-12
    su, sv = _col_signs(Uj, Ut), _col_signs(Vj, Vt)
    assert _rel(_np(Ut) * su, Uj) <= 1e-9
    assert _rel(_np(Vt) * sv, Vj) <= 1e-9
    assert _rel(su[:, None] * _np(Bt) * sv[None, :], Bj) <= 1e-9


def _run_abrik(A, kind, cfg_kw, tol, k=10, seed=4):
    jcfg, tcfg = JABRIKConfig(**cfg_kw), ABRIKConfig(**cfg_kw)
    jop, top = _ops(kind, A)
    st = JRNG(seed)
    v0, sk = _abrik_draws(st, *A.shape, jcfg)
    jf = j_abrik_factor(jop, st, jcfg, tol=tol)
    tf = abrik_factor(top, _tstate(st), tcfg, tol=tol, v0=v0,
                      qr_sketches=sk)
    _check_factor(jf, tf)
    Uj, Sj, Vtj, infoj, _ = j_abrik(jop, k, jcfg, st, tol=tol)
    Ut, St, Vtt, infot, _ = abrik(top, k, tcfg, _tstate(st), tol=tol,
                                  v0=v0, qr_sketches=sk)
    assert infot["num_krylov_iters"] == int(infoj["num_krylov_iters"])
    assert np.abs(_np(St) - np.asarray(Sj)).max() <= 1e-10 * float(Sj[0])
    assert _rel(_np(Ut) * _col_signs(Uj, Ut), Uj) <= 1e-9
    assert _rel(_np(Vtt).T * _col_signs(np.asarray(Vtj).T, Vtt.T),
                np.asarray(Vtj).T) <= 1e-9
    return int(tf[4])


@pytest.mark.parametrize("qr", ["geqrf", "cqrrt"])
@pytest.mark.parametrize("kind", ["tensor", "dense", "sparse", "composite"])
def test_abrik_tall(kind, qr):
    A = _matrix(96, 60, cond_num=1e4)
    if kind == "sparse":
        A = _sparsify(A, 0.3, 2)
    iters = _run_abrik(A, kind, dict(block_size=6, max_iters=4,
                                     qr_explicit=qr), 0.0)
    assert iters == 4


@pytest.mark.parametrize("qr", ["geqrf", "cqrrt"])
@pytest.mark.parametrize("kind", ["tensor", "sparse"])
def test_abrik_wide(kind, qr):
    A = _matrix(50, 90, kind="exponential", cond_num=1e5, seed=3)
    if kind == "sparse":
        A = _sparsify(A, 0.4, 3)
    _run_abrik(A, kind, dict(block_size=5, max_iters=4, qr_explicit=qr),
               0.0)


@pytest.mark.parametrize("qr", ["geqrf", "cqrrt"])
@pytest.mark.parametrize("kind", ["tensor", "dense", "sparse"])
def test_abrik_frobenius_capture_stops_early(kind, qr):
    """tol > 0 on a spectrum the first blocks capture: the gap test ends
    the loop before max_iters (the same iteration in both packages)."""
    if kind == "sparse":     # a permuted diagonal with that spectrum
        A = np.zeros((80, 48))
        A[np.random.default_rng(4).permutation(80)[:48], np.arange(48)] = \
            np.asarray(gen_exp_singvals(48, 1e12, jnp.float64))
    else:
        A = _matrix(80, 48, kind="exponential", cond_num=1e12, seed=5)
    iters = _run_abrik(A, kind, dict(block_size=8, max_iters=6,
                                     qr_explicit=qr), 1e-3, k=8)
    assert 1 < iters < 6


@pytest.mark.parametrize("qr", ["geqrf", "cqrrt"])
def test_abrik_krylov_exhaustion_freezes_the_loop(qr):
    """Rank 10 < q·b: once a residual block is at roundoff the loop
    freezes, its blocks are written as zeros, and both packages stop at
    the same iteration."""
    A = _matrix(70, 40, kind="exponential", cond_num=1e2, rank=10, seed=6)
    iters = _run_abrik(A, "tensor", dict(block_size=5, max_iters=8,
                                         qr_explicit=qr), 0.0, k=5)
    assert iters < 8


def test_abrik_timing_slots_and_outputs():
    A = _matrix(64, 40, cond_num=1e3, seed=7)
    cfg_kw = dict(block_size=4, max_iters=3, qr_explicit="cqrrt")
    st = JRNG(8)
    v0, sk = _abrik_draws(st, 64, 40, JABRIKConfig(**cfg_kw))
    *outj, repj = j_abrik(jnp.asarray(A), 6, JABRIKConfig(**cfg_kw), st,
                          timing=True)
    *outt, rept = abrik(_t(A), 6, ABRIKConfig(**cfg_kw), _tstate(st),
                        timing=True, v0=v0, qr_sketches=sk)
    assert sorted(rept) == sorted(repj)
    assert all(v >= 0.0 for v in rept.values())
    assert outt[3]["num_krylov_iters"] == 3
    assert np.abs(_np(outt[1]) - np.asarray(outj[1])).max() \
        <= 1e-10 * float(outj[1][0])
    assert _rel(outt[3]["capture"], outj[3]["capture"]) <= 1e-12


def test_abrik_draws_its_own_start_and_advances_the_state():
    A = _t(_matrix(40, 30, cond_num=1e3))
    st = rt.RNGState(3)
    for qr, spawns in (("geqrf", 1), ("cqrrt", 2)):
        cfg = ABRIKConfig(block_size=4, max_iters=6, qr_explicit=qr)
        U, S, Vt, info, nxt = abrik(A, 6, cfg, st)
        assert nxt.counter == st.counter + spawns
        U2, S2, *_ = abrik(A, 6, cfg, st)
        assert torch.equal(S, S2)
        orth = torch.linalg.norm(U.T @ U - torch.eye(6, dtype=A.dtype))
        assert float(orth) < 1e-12
        sv = torch.linalg.svdvals(A)[:3]
        assert float(((S[:3] - sv).abs() / sv).max()) < 1e-6


# -- CholQR over operators ----------------------------------------------------

def _chol_input(kind, seed=11, m=120, n=24, cond=1e3):
    A = _matrix(m, n, cond_num=cond, seed=seed)
    if kind == "sparse":
        A = _sparsify(A, 0.5, seed)
    return A


@pytest.mark.parametrize("block", [None, 8, 10])
@pytest.mark.parametrize("kind", ["dense", "sparse", "composite"])
def test_blocked_gram(kind, block):
    A = _chol_input(kind)
    jop, top = _ops(kind, A)
    assert _rel(blocked_gram(top, block), j_blocked_gram(jop, block)) \
        <= 1e-13
    R1 = np.triu(_matrix(24, 24, seed=12)) + 5 * np.eye(24)
    R2 = np.triu(_matrix(24, 24, seed=13)) + 6 * np.eye(24)
    assert _rel(blocked_gram_precond(top, (_t(R1), _t(R2)), block),
                j_blocked_gram_precond(jop, (jnp.asarray(R1),
                                             jnp.asarray(R2)), block)) \
        <= 1e-13


def _check_r(Rt, Rj):
    Rj = np.asarray(Rj)
    assert np.abs(_np(Rt) - Rj).max() <= 1e-10 * np.linalg.norm(Rj)


def _check_chain(top, jop, chain_t, chain_j):
    Qt = materialize_q(top, chain_t)
    Qj = j_materialize_q(jop, chain_j)
    assert np.abs(_np(Qt) - np.asarray(Qj)).max() <= 1e-9


@pytest.mark.parametrize("passes,block", [(1, None), (2, 10), (3, 8)])
@pytest.mark.parametrize("kind", ["dense", "sparse", "composite"])
def test_cholqr_linops(kind, passes, block):
    A = _chol_input(kind)
    jop, top = _ops(kind, A)
    Rj, fj, cj = j_cholqr_linops(jop, JCholCfg(block, passes))
    Rt, ft, ct = cholqr_linops(top, CholQRLinopsConfig(block, passes))
    assert bool(ft) == bool(fj) is False
    _check_r(Rt, Rj)
    _check_chain(top, jop, ct, cj)


@pytest.mark.parametrize("block", [None, 10])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_scholqr3_linops(kind, block):
    A = _chol_input(kind, cond=1e7)
    jop, top = _ops(kind, A)
    Rj, fj, cj = j_scholqr3_linops(jop, JCholCfg(block))
    Rt, ft, ct = scholqr3_linops(top, CholQRLinopsConfig(block))
    assert bool(ft) == bool(fj)
    _check_r(Rt, Rj)
    _check_chain(top, jop, ct, cj)


@pytest.mark.parametrize("block", [None, 10])
@pytest.mark.parametrize("kind", ["dense", "sparse", "composite"])
def test_cqrrt_linops(kind, block):
    A = _chol_input(kind, cond=1e6)
    jop, top = _ops(kind, A)
    cfg_kw = dict(d_factor=1.5, gram_block=block)
    st = JRNG(14)
    key, _ = st.spawn()
    d = int(1.5 * A.shape[1])
    G = _t(jax.random.normal(key, (A.shape[0], d), dtype=jnp.float64))
    Rj, fj, cj, stj = j_cqrrt_linops(jop, JCQRRTCfg(**cfg_kw), st)
    Rt, ft, ct, stt = cqrrt_linops(top, CQRRTLinopsConfig(**cfg_kw),
                                   _tstate(st), sketch=G)
    assert bool(ft) == bool(fj) is False
    assert stt.counter == int(stj.counter)
    _check_r(Rt, Rj)
    _check_chain(top, jop, ct, cj)


@pytest.mark.parametrize("kind", ["dense", "sparse", "composite"])
def test_scholqr3_linops_basic(kind):
    A = _chol_input(kind, cond=1e6)
    jop, top = _ops(kind, A)
    Qj, Rj, fj = j_scholqr3_linops_basic(jop)
    Qt, Rt, ft = scholqr3_linops_basic(top)
    assert bool(ft) == bool(fj)
    _check_r(Rt, Rj)
    assert np.abs(_np(Qt) - np.asarray(Qj)).max() <= 1e-9


@pytest.mark.parametrize("driver", ["cholqr", "cholqr2", "scholqr3",
                                    "cqrrt"])
def test_non_finite_gram_raises_fail(driver):
    """An Inf entry makes the Gram non-finite: ``_finite_gram`` zeroes it
    and both packages raise ``fail``."""
    A = _chol_input("dense", m=40, n=8)
    A[3, 2] = np.inf
    jop, top = _ops("dense", A)
    if driver == "cqrrt":
        st = JRNG(2)
        key, _ = st.spawn()
        G = _t(jax.random.normal(key, (40, 10), dtype=jnp.float64))
        fj = j_cqrrt_linops(jop, JCQRRTCfg(), st)[1]
        ft = cqrrt_linops(top, CQRRTLinopsConfig(), _tstate(st),
                          sketch=G)[1]
    elif driver == "scholqr3":
        fj, ft = j_scholqr3_linops(jop)[1], scholqr3_linops(top)[1]
    else:
        passes = 2 if driver == "cholqr2" else 1
        fj = j_cholqr_linops(jop, JCholCfg(passes=passes))[1]
        ft = cholqr_linops(top, CholQRLinopsConfig(passes=passes))[1]
    assert bool(ft) == bool(fj)


def test_cholqr_and_cqrrt_linops_timing_phases():
    A = _chol_input("sparse")
    jop, top = _ops("sparse", A)
    *_, repj = j_cholqr_linops(jop, JCholCfg(8, 2), timing=True)
    Rt, ft, ct, rept = cholqr_linops(top, CholQRLinopsConfig(8, 2),
                                     timing=True)
    assert list(rept) == list(repj)
    st = JRNG(15)
    key, _ = st.spawn()
    G = _t(jax.random.normal(key, (120, 30), dtype=jnp.float64))
    *_, repj = j_cqrrt_linops(jop, JCQRRTCfg(), st, timing=True)
    *out, rept = cqrrt_linops(top, CQRRTLinopsConfig(), _tstate(st),
                              timing=True, sketch=G)
    assert list(rept) == list(repj)
    Rj = j_cqrrt_linops(jop, JCQRRTCfg(), st)[0]
    _check_r(out[0], Rj)
