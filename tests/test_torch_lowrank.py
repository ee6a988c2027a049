"""The port's low-rank layer (randlapack_tpu_torch: cholqr_auto, the Jacobi
SVD, orth/stabilize, RS, RF, blocked QB, RSVD) against the JAX package's
on the CPU in f64. Inputs are built by the JAX generators (``mat_gen``,
``bad_cholqr_matrix``, ``kahan_matrix``); every Gaussian draw is made by
JAX as its function makes it (``state.spawn()``, per QB block
``state.branch(i)``) and injected into the port (``omega=``,
``omegas=``), which still advances its state as a drawn one would.

Gates: ``errs``, S and λ within 1e-12 relative; Q, U, V within 1e-10
absolute (their entries are O(1)) after aligning each column's sign —
LAPACK fixes an SVD's signs by its own order of operations, and the two
packages' products round differently; ``fail``, ``rank`` and
``qb_status`` equal.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.comps import QBConfig as JQBConfig
from randlapack_tpu.comps import RFConfig as JRFConfig
from randlapack_tpu.comps import RSConfig as JRSConfig
from randlapack_tpu.comps import Stab as JStab
from randlapack_tpu.comps import orth as j_orth
from randlapack_tpu.comps import qb as j_qb
from randlapack_tpu.comps import qb_blocked as j_qb_blocked
from randlapack_tpu.comps import rf as j_rf
from randlapack_tpu.comps import rs as j_rs
from randlapack_tpu.comps import stabilize as j_stabilize
from randlapack_tpu.comps.qb import qb_status as j_qb_status
from randlapack_tpu.drivers import RSVDConfig as JRSVDConfig
from randlapack_tpu.drivers import rsvd as j_rsvd
from randlapack_tpu.drivers import rsvd_fixed_rank as j_rsvd_fixed_rank
from randlapack_tpu.gen import (MatGenInfo, MatType, bad_cholqr_matrix,
                                kahan_matrix, mat_gen)
from randlapack_tpu.ops.cholqr import cholqr_auto as j_cholqr_auto
from randlapack_tpu.ops.svd import svd_econ as j_svd_econ

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import interop
from randlapack_tpu_torch.comps import (QBConfig, RFConfig, RSConfig, Stab,
                                        orth, qb, qb_blocked, rf, rs,
                                        stabilize)
from randlapack_tpu_torch.comps.qb import (QB_ERROR_GREW, QB_OK,
                                           QB_RANK_EXHAUSTED, qb_status)
from randlapack_tpu_torch.drivers import RSVDConfig, rsvd, rsvd_fixed_rank
from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.ops.svd import svd_econ

tcholqr = sys.modules["randlapack_tpu_torch.ops.cholqr"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run thousands of small tensor ops. Beside other test
    processes each of PyTorch's intra-op thread pools waits on cores the
    others hold, which made single ops take milliseconds; one thread
    keeps them at their own cost. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HI = jax.lax.Precision.HIGHEST
REL = 1e-12          # errs, S, λ
ABS = 1e-10          # Q, U, V (sign-aligned)


def _gen(m, n, kind, seed, **kw):
    A, st = mat_gen(MatGenInfo(m, n, kind, **kw), JRNG(seed))
    return np.array(A), st


def _t(x):
    return torch.tensor(np.asarray(x))


def _tstate(st, seed=0):
    """A port state at the JAX state's counter: the two then advance
    alike (their streams differ; every draw is injected)."""
    return rt.RNGState(seed, _counter=int(st.counter))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _abs(a, b):
    return np.abs(_np(a) - _np(b)).max()


def _signs(ref, x):
    """Per-column signs that align x's columns with ref's."""
    s = np.sign(np.sum(_np(ref) * _np(x), axis=0))
    return np.where(s == 0, 1.0, s)


def _normal(st, shape):
    """The Gaussian the JAX package draws from ``st`` (``st.spawn()``)."""
    key, _ = st.spawn()
    return _t(jax.random.normal(key, shape, dtype=jnp.float64))


def _rs_shape(m, n, k, p):
    return (n, k) if p % 2 == 0 else (m, k)


def _qb_omegas(A, k, cfg, st):
    """QB's per-block RS starts, each drawn from ``st.branch(i)``."""
    m, n = A.shape
    b = cfg.block_size
    shape = _rs_shape(m, n, b, cfg.rf.rs.passes_over_data)
    return [_normal(st.branch(i), shape) for i in range(k // b)]


# -- cholqr_auto: each rung of the ladder --------------------------------------

class _Rungs:
    """Records which rescue rungs of the port's cholqr_auto ran."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("shifted_cholqr3", "preconditioned_cholqr"):
            fn = getattr(tcholqr, name)
            monkeypatch.setattr(tcholqr, name, self._spy(name, fn))

    def _spy(self, name, fn):
        def wrapped(*args):
            self.calls.append(name)
            return fn(*args)
        return wrapped


RUNG_CALLS = {"cholqr2": [], "shifted": ["shifted_cholqr3"],
              "householder": ["shifted_cholqr3", "preconditioned_cholqr"]}


@pytest.mark.parametrize("grade,rung", [(4, "cholqr2"), (10, "shifted"),
                                        (18, "householder")])
def test_cholqr_auto_rungs_on_graded_columns(monkeypatch, grade, rung):
    # a Gaussian with its columns scaled over 10^-grade: diag(R) ranges as
    # widely (so the estimate picks the rung) while Q, which column
    # scaling leaves alone, stays well-posed: Q within 1e-10
    G, _ = _gen(200, 40, MatType.gaussian, 3)
    A = G * np.logspace(0, -grade, 40)[None, :]
    rungs = _Rungs(monkeypatch)
    Q, R, fail = tcholqr.cholqr_auto(_t(A))
    Qj, Rj, fj = j_cholqr_auto(jnp.asarray(A), HI)
    assert rungs.calls == RUNG_CALLS[rung]
    assert bool(fail) == bool(fj) is False
    assert _abs(Q, Qj) <= ABS
    assert _rel(R, Rj) <= ABS


# inputs on which the ladder's last Cholesky is decided by rounding (see
# the test below)
ROUNDING_DECIDED = {"kahan 0.3"}


@pytest.mark.parametrize("which,rung", [
    ("bad_cholqr 1e12", "shifted"), ("bad_cholqr 1e16", "householder"),
    ("kahan 0.8", "shifted"), ("kahan 0.3", "householder")])
def test_cholqr_auto_rescue_rungs_on_adversarial_inputs(monkeypatch, which,
                                                        rung):
    # the adversarial generators reach the rescue rungs at a condition
    # number where Q itself is ill-posed (it moves by cond·eps between two
    # summation orders), so these hold R (well-posed) within 1e-10 of
    # max|R|, the residual QR − A and ``fail``
    kind, arg = which.split()
    if kind == "bad_cholqr":
        A, _ = bad_cholqr_matrix(200, 40, JRNG(1), jnp.float64,
                                 cond=float(arg))
    else:
        A = kahan_matrix(40, jnp.float64, float(arg))
    A = np.asarray(A)
    rungs = _Rungs(monkeypatch)
    Q, R, fail = tcholqr.cholqr_auto(_t(A))
    Qj, Rj, fj = j_cholqr_auto(jnp.asarray(A), HI)
    assert rungs.calls == RUNG_CALLS[rung]
    if which in ROUNDING_DECIDED:
        # the last rung's R_h has its diagonal floored at eps·max|diag|
        # (cond 5e25 here), so A·R_h⁻¹ is rounding noise in its deficient
        # directions: two BLAS triangular solves (the JAX package takes
        # scipy's OpenBLAS dtrsm, PyTorch MKL's) differ by O(10) in it and
        # its Gram is singular to rounding. Whether that Cholesky breaks
        # down, so ``fail``, is the BLAS's choice on the host. Held
        # instead: the Gram's smallest eigenvalue lies within n·eps·‖G‖ of
        # zero (this fails if the input or the ladder moves), and R and
        # the residual wherever the last rung did not break down
        n = A.shape[1]
        At = _t(A)
        R_h = tcholqr._clamp_triu_diag(
            torch.linalg.qr(At, mode="r")[1][:n, :])
        P, _, _ = tcholqr._finite_scaled(tcholqr._solve_rt(At, R_h))
        G = P.T @ P
        lam = torch.linalg.eigvalsh(0.5 * (G + G.T)).abs()
        assert lam.min() <= n * np.finfo(np.float64).eps * lam.max()
    else:
        assert bool(fail) == bool(fj)
    if not (bool(fail) or bool(fj)):
        assert _rel(R, Rj) <= ABS
    if not bool(fail):
        res = np.linalg.norm(_np(Q) @ _np(R) - A) / np.linalg.norm(A)
        assert res <= 1e-12


def test_cholqr_auto_rank_deficient_stays_finite():
    A, _ = _gen(400, 40, MatType.exponential, 8, cond_num=10)
    A[:, 20:] = A[:, :20]                       # exact rank 20
    Q, R, fail = tcholqr.cholqr_auto(_t(A))
    Qj, _, fj = j_cholqr_auto(jnp.asarray(A), HI)
    assert bool(torch.isfinite(Q).all())
    assert bool(fail) == bool(fj)


def test_cholqr_auto_holds_precision():
    # "high" was refused until the driver-level precision was ported: on
    # the CPU it is the "highest" product, bit for bit
    A = torch.tensor(np.random.default_rng(1).standard_normal((12, 4)))
    runs = [tcholqr.cholqr_auto(A, p) for p in ("high", "highest")]
    assert all(torch.equal(x, y) for x, y in zip(*runs))


# -- orth and stabilize -------------------------------------------------------

@pytest.mark.parametrize("method", ["cholqr", "cholqr2", "scholqr3", "hqr",
                                    "auto"])
def test_orth_matches_jax(method):
    # cond 100: one-pass CholQR's Q moves by cond²·eps between summation
    # orders
    A, _ = _gen(150, 30, MatType.exponential, 4, cond_num=100)
    Q, fail = orth(_t(A), Stab(method))
    Qj, fj = j_orth(jnp.asarray(A), JStab(method), HI)
    assert bool(fail) == bool(fj)
    assert _abs(Q, Qj) <= ABS


def test_orth_refuses_plu():
    with pytest.raises(ValueError):
        orth(torch.eye(4, dtype=torch.float64), Stab.plu)


def _zero_structure():
    # exact zeros: rows 0-59 empty, columns 5 and 12 zero: the δ pad
    # decides the pivots there
    A, _ = _gen(120, 20, MatType.gaussian, 5)
    A[:60] = 0.0
    A[:, [5, 12]] = 0.0
    return A


def _with_inf():
    A, _ = _gen(80, 10, MatType.gaussian, 6)
    A[3, 4] = np.inf
    A[7, 1] = -np.inf
    return A


@pytest.mark.parametrize("case", ["exponential", "wide", "zeros", "inf",
                                  "all zero"])
def test_stabilize_plu_matches_jax(case):
    A = {"exponential": lambda: _gen(120, 20, MatType.exponential, 7,
                                     cond_num=1e3)[0],
         "wide": lambda: _gen(15, 40, MatType.gaussian, 8)[0],
         "zeros": _zero_structure, "inf": _with_inf,
         "all zero": lambda: np.zeros((30, 6))}[case]()
    L, bad = stabilize(_t(A), Stab.plu)
    Lj, badj = j_stabilize(jnp.asarray(A), JStab.plu, HI)
    assert bool(bad) == bool(badj) == (case == "inf")
    # L is exact arithmetic on the pivots: equal pivots give L to eps
    assert _abs(L, Lj) <= ABS


def test_stabilize_other_methods_orthogonalize():
    A, _ = _gen(100, 12, MatType.exponential, 9, cond_num=1e3)
    for method in (Stab.cholqr2, Stab.hqr):
        L, bad = stabilize(_t(A), method)
        Lj, badj = j_stabilize(jnp.asarray(A), JStab(method.value), HI)
        assert bool(bad) == bool(badj)
        assert _abs(L, Lj) <= ABS


# -- RS and RF -----------------------------------------------------------------

@pytest.mark.parametrize("p", [0, 1, 2, 3])
@pytest.mark.parametrize("per_stab,cond_check", [(1, False), (2, True)])
def test_rs_matches_jax(p, per_stab, cond_check):
    A, st = _gen(90, 60, MatType.exponential, 10, cond_num=1e6)
    m, n = A.shape
    cfg = dict(passes_over_data=p, passes_per_stab=per_stab,
               cond_check=cond_check)
    omega = _normal(st, _rs_shape(m, n, 8, p))
    out = rs(_t(A), 8, RSConfig(**cfg), _tstate(st, 3), omega=omega)
    ref = j_rs(jnp.asarray(A), 8, JRSConfig(**cfg), st, HI)
    assert len(out) == len(ref) == (3 if cond_check else 2)
    assert _abs(out[0], ref[0]) <= ABS * max(1.0, np.abs(_np(ref[0])).max())
    # an injected draw advances the state exactly as a drawn one
    assert out[1].counter == int(ref[1].counter) == int(st.counter) + 1
    _, drawn = rs(_t(A), 8, RSConfig(**{**cfg, "cond_check": False}),
                  _tstate(st, 3))
    assert (drawn.key, drawn.counter) == (out[1].key, out[1].counter)
    if cond_check:
        assert out[2].shape == ref[2].shape
        if out[2].numel():                     # p 0: no stabilization
            assert _rel(out[2], ref[2]) <= 1e-8    # cond ~1e6: eigvalsh


def test_rs_rejects_a_misshapen_start():
    A = torch.zeros((20, 10), dtype=torch.float64)
    with pytest.raises(RandLAPACKError):
        rs(A, 4, RSConfig(passes_over_data=1), rt.RNGState(0),
           omega=torch.zeros((10, 4), dtype=torch.float64))


@pytest.mark.parametrize("rf_cc,rs_cc", [(False, False), (True, False),
                                         (False, True)])
def test_rf_matches_jax(rf_cc, rs_cc):
    # cond_check arity: RFConfig(cond_check) returns (Q, state, conds) with
    # RS's conds and cond(Y); RSConfig(cond_check) alone is dropped by rf
    A, st = _gen(100, 70, MatType.polynomial, 11, cond_num=1e5)
    cfg = dict(rs=dict(passes_over_data=2, cond_check=rs_cc),
               cond_check=rf_cc)
    omega = _normal(st, (70, 10))
    out = rf(_t(A), 10, RFConfig(RSConfig(**cfg["rs"]), cond_check=rf_cc),
             _tstate(st), omega=omega)
    ref = j_rf(jnp.asarray(A), 10,
               JRFConfig(JRSConfig(**cfg["rs"]), cond_check=rf_cc), st, HI)
    assert len(out) == len(ref) == (3 if rf_cc else 2)
    assert _abs(out[0], ref[0]) <= ABS
    assert out[1].counter == int(ref[1].counter)
    if rf_cc:
        assert out[2].shape == ref[2].shape == (3,)
        assert _rel(out[2], ref[2]) <= 1e-8


def test_rf_falls_back_to_householder():
    # Y = A·Ω of exact rank 3 in 6 columns: CholQR2 flags, Householder runs
    A, st = _gen(60, 40, MatType.polynomial, 12, cond_num=10, rank=3)
    cfg = JRFConfig(JRSConfig(passes_over_data=0), orth=JStab.cholqr)
    omega = _normal(st, (40, 6))
    q, _ = rf(_t(A), 6, RFConfig(RSConfig(passes_over_data=0),
                                 orth=Stab.cholqr), rt.RNGState(0),
              omega=omega)
    qj, _ = j_rf(jnp.asarray(A), 6, cfg, st, HI)
    _, fail = orth(_t(A) @ omega, Stab.cholqr)
    assert bool(fail)
    # past the rank, Householder's columns are set by rounding: compare the
    # leading three
    assert _abs(q[:, :3], np.asarray(qj)[:, :3]) <= ABS


# -- blocked QB, QB, RSVD ---------------------------------------------------------

def _qb_pair(A, st, k, cfg_kw):
    omegas = _qb_omegas(A, k, JQBConfig(**cfg_kw), st)
    out = qb_blocked(_t(A), k, QBConfig(**cfg_kw), _tstate(st),
                     omegas=omegas)
    ref = j_qb_blocked(jnp.asarray(A), k, JQBConfig(**cfg_kw), st, HI)
    return out, ref


@pytest.mark.parametrize("kind,cond,k,b", [
    (MatType.exponential, 1e6, 128, 32), (MatType.polynomial, 1e4, 48, 16)])
def test_qb_blocked_matches_jax(kind, cond, k, b):
    A, st = _gen(300, 200, kind, 21, cond_num=cond)
    (Q, B, errs, nst), (Qj, Bj, ej, jst) = _qb_pair(A, st, k,
                                                    dict(block_size=b))
    assert _rel(errs, ej) <= REL
    assert _abs(Q, Qj) <= ABS
    assert _rel(B, Bj) <= ABS
    assert nst.counter == int(jst.counter) == int(st.counter) + 1
    assert np.all(np.diff(_np(errs)) <= 1e-12)


def test_qb_blocked_low_rank_matches_jax():
    # tests/test_rsvd_qb.py's low-rank case: rank 32 captured by block 0.
    # In f64 the later blocks work on rounding noise, so their errors (and
    # whether the in-loop stop trips on them) are rounding-level in both
    # packages: held to the JAX test's own checks, block 0 to parity
    A, st = _gen(300, 200, MatType.polynomial, 22, cond_num=1e3, rank=32)
    (Q, B, errs, _), (Qj, Bj, ej, _) = _qb_pair(A, st, 128,
                                                dict(block_size=32))
    for Q_, B_, e_ in ((_np(Q), _np(B), _np(errs)),
                       (np.asarray(Qj), np.asarray(Bj), np.asarray(ej))):
        assert np.linalg.norm(A - Q_ @ B_) / np.linalg.norm(A) < 1e-10
        assert np.all(np.diff(e_) <= 1e-12) and e_.max() < 1e-13
    assert qb_status(errs, 1e-10) == j_qb_status(ej, 1e-10) != QB_ERROR_GREW
    assert _abs(_np(Q)[:, :32], np.asarray(Qj)[:, :32]) <= ABS


def _stop_on_negative_column_sum(Q, Y, where, one):
    """Q scaled by 1.5 (orthogonality lost) where Y's first column sums
    below 0: a loss of orthogonality decided by an O(1) margin, so the
    in-loop stop trips at the same block in both packages."""
    return Q * where(Y[:, 0].sum() < 0, 1.5 * one, one)


def test_qb_blocked_freeze_matches_jax(monkeypatch):
    # the in-loop stop (rl_qb.hh:228) in f64 trips only on rounding noise,
    # so both packages' re-orthogonalization is made to lose orthogonality
    # at a block chosen by the data; from that block on the errors freeze
    # at min(prev_err, 1) and Q, B columns are zero, equally in both
    jqb_mod = sys.modules["randlapack_tpu.comps.qb"]
    tqb_mod = sys.modules["randlapack_tpu_torch.comps.qb"]
    t_orth, j_orth_fn = tqb_mod._orth_or_hqr, jqb_mod.orth

    def t_bad(Y, method, precision):
        return _stop_on_negative_column_sum(
            t_orth(Y, method, precision), Y, torch.where,
            torch.ones((), dtype=Y.dtype))

    def j_bad(Y, method, precision):
        Qb, fail = j_orth_fn(Y, method, precision)
        return _stop_on_negative_column_sum(Qb, Y, jnp.where,
                                            jnp.ones((), Y.dtype)), fail

    monkeypatch.setattr(tqb_mod, "_orth_or_hqr", t_bad)
    monkeypatch.setattr(jqb_mod, "orth", j_bad)
    A, st = _gen(150, 100, MatType.exponential, 27, cond_num=1e4)
    cfg = dict(block_size=8)
    omegas = _qb_omegas(A, 48, JQBConfig(**cfg), st)
    Q, B, errs, _ = qb_blocked(_t(A), 48, QBConfig(**cfg), _tstate(st),
                               omegas=omegas)
    # un-jitted, so the patched orth is traced now
    Qj, Bj, ej, _ = j_qb_blocked.__wrapped__(jnp.asarray(A), 48,
                                             JQBConfig(**cfg), st, HI)
    e, ej = _np(errs), np.asarray(ej)
    stop = int(np.flatnonzero(e[1:] == e[:-1])[0]) + 1
    assert 1 <= stop <= 4
    assert np.all(e[stop:] == min(e[stop - 1], 1.0))
    assert _rel(e, ej) <= REL
    assert not _np(Q)[:, 8 * stop:].any() and not _np(B)[8 * stop:].any()
    assert not np.asarray(Qj)[:, 8 * stop:].any()
    assert not np.asarray(Bj)[8 * stop:].any()
    assert _abs(Q, Qj) <= ABS and _rel(B, Bj) <= ABS
    assert qb_status(errs, 0.0) == j_qb_status(ej, 0.0)


def test_qb_status_codes():
    for e, tol in (([0.5, 0.1, 1e-9], 1e-8), ([0.5, 0.2, 0.1], 1e-8),
                   ([0.5, 0.6, 0.6], 1e-8), ([0.5, 0.2, 0.2], 1e-8)):
        assert qb_status(torch.tensor(e), tol) == j_qb_status(e, tol)
    assert qb_status([0.5, 0.1, 1e-9], 1e-8) == QB_OK
    assert qb_status([0.5, 0.2, 0.1], 1e-8) == QB_RANK_EXHAUSTED
    assert qb_status([0.5, 0.6], 1e-8) == QB_ERROR_GREW


@pytest.mark.parametrize("tol", [0.0, 1e-2])
def test_qb_matches_jax(tol):
    A, st = _gen(200, 150, MatType.exponential, 23, cond_num=1e8)
    cfg = dict(block_size=16)
    omegas = _qb_omegas(A, 64, JQBConfig(**cfg), st)
    Q, B, rank, err, nst = qb(_t(A), 60, QBConfig(**cfg), _tstate(st),
                              tol, omegas=omegas)
    Qj, Bj, rj, ej, jst = j_qb(jnp.asarray(A), 60, JQBConfig(**cfg), st,
                               tol, HI)
    assert rank == rj and (rank < 60) == (tol > 0)
    assert abs(err - ej) <= REL * ej
    assert Q.shape == Qj.shape and _abs(Q, Qj) <= ABS
    assert nst.counter == int(jst.counter)


def _check_svd(U, S, Vt, Uj, Sj, Vtj, k=None):
    k = k or len(Sj)
    assert _rel(S, Sj) <= REL
    sg = _signs(np.asarray(Uj)[:, :k], _np(U)[:, :k])
    assert _abs(_np(U)[:, :k] * sg, np.asarray(Uj)[:, :k]) <= ABS
    assert _abs(_np(Vt)[:k] * sg[:, None], np.asarray(Vtj)[:k]) <= ABS


@pytest.mark.parametrize("svd_method", ["auto", "jacobi"])
def test_rsvd_fixed_rank_matches_jax(svd_method):
    A, st = _gen(300, 200, MatType.exponential, 24, cond_num=1e6)
    cfg = dict(block_size=16)
    omegas = _qb_omegas(A, 32, JQBConfig(**cfg), st)
    U, S, Vt, err, nst = rsvd_fixed_rank(
        _t(A), 32, RSVDConfig(QBConfig(**cfg), svd_method), _tstate(st),
        omegas=omegas)
    Uj, Sj, Vtj, ej, jst = j_rsvd_fixed_rank(
        jnp.asarray(A), 32, JRSVDConfig(JQBConfig(**cfg), svd_method), st,
        HI)
    assert abs(float(err) - float(ej)) <= REL * float(ej)
    # the leading 16 triplets: σ₁₆/σ₁ ~ 1e-1, well separated
    _check_svd(U, S, Vt, Uj, Sj, Vtj, k=16)
    assert _rel(S, Sj) <= REL
    assert nst.counter == int(jst.counter)


def test_rsvd_adaptive_matches_jax():
    A, st = _gen(200, 120, MatType.exponential, 25, cond_num=1e8)
    cfg = dict(block_size=8)
    omegas = _qb_omegas(A, 40, JQBConfig(**cfg), st)
    U, S, Vt, rank, err, _ = rsvd(_t(A), 40, RSVDConfig(QBConfig(**cfg)),
                                  rt.RNGState(0), 1e-2, omegas=omegas)
    Uj, Sj, Vtj, rj, ej, _ = j_rsvd(jnp.asarray(A), 40,
                                    JRSVDConfig(JQBConfig(**cfg)), st, 1e-2,
                                    HI)
    assert rank == rj < 40 and U.shape == (200, rank)
    assert abs(err - ej) <= REL * ej
    _check_svd(U, S, Vt, Uj, Sj, Vtj, k=8)


@pytest.mark.parametrize("k", [0, 121])
def test_rsvd_rejects_out_of_range_rank(k):
    with pytest.raises(RandLAPACKError):
        rsvd(torch.zeros((200, 120), dtype=torch.float64), k, RSVDConfig(),
             rt.RNGState(0))


@pytest.mark.parametrize("shape", [(60, 20), (20, 60), (41, 13), (13, 41),
                                   (30, 1)])
def test_svd_jacobi_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    B = rng.standard_normal(shape) * np.exp(-np.arange(shape[1]) / 3)[None]
    U, S, Vt = svd_econ(_t(B), "jacobi")
    Uj, Sj, Vtj = j_svd_econ(jnp.asarray(B), "jacobi")
    _check_svd(U, S, Vt, Uj, Sj, Vtj)
    k = min(shape)
    assert U.shape == (shape[0], k) and Vt.shape == (k, shape[1])
    assert np.all(np.diff(_np(S)) <= 0)


def test_svd_jacobi_f32_is_as_accurate_as_jax():
    # an f32 factor with singular values 1 .. e^-8: the port's σ (against
    # the f64 SVD of the same f32 input, σ ≥ 1e-3·σ₁) are no less accurate
    # than the JAX package's Jacobi reaches with the same rotations; with
    # its rotation coefficients in f32 the port erred about 2x the JAX
    # package here
    rng = np.random.default_rng(0)
    G, _ = np.linalg.qr(rng.standard_normal((1024, 64)))
    W, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    B = ((G * np.exp(-np.arange(64) / 8.0)) @ W.T).astype(np.float32)
    s64 = np.linalg.svd(B.astype(np.float64), compute_uv=False)
    top = s64 >= 1e-3 * s64[0]

    def s_err(s):
        return (np.abs(np.asarray(s, np.float64) - s64) / s64)[top].max()

    _, S, _ = svd_econ(torch.tensor(B), "jacobi")
    _, Sj, _ = j_svd_econ(jnp.asarray(B), "jacobi")
    assert S.dtype == torch.float32
    assert s_err(_np(S)) <= s_err(Sj)


# -- interop ------------------------------------------------------------------

def test_qb_and_svd_cross_through_numpy():
    A, st = _gen(120, 80, MatType.exponential, 26, cond_num=1e4)
    Qj, Bj, ej, _ = j_qb_blocked(jnp.asarray(A), 16, JQBConfig(block_size=8),
                                 st, HI)
    Q, B, errs = interop.qb_from_numpy((Qj, Bj, ej), device="cpu")
    assert Q.device.type == "cpu" and Q.dtype == torch.float64
    back = interop.qb_to_numpy(Q, B, errs)
    assert all(np.array_equal(b, np.asarray(x))
               for b, x in zip(back, (Qj, Bj, ej)))
    assert np.linalg.norm(A - back[0] @ back[1]) / np.linalg.norm(A) \
        == pytest.approx(float(ej[-1]), rel=1e-10)
    Uj, Sj, Vtj, _, _ = j_rsvd_fixed_rank(
        jnp.asarray(A), 16, JRSVDConfig(JQBConfig(block_size=8)), st, HI)
    svd = interop.lowrank_svd_from_numpy((Uj, Sj, Vtj), device="cpu")
    back = interop.lowrank_svd_to_numpy(*svd)
    assert len(back) == 3 and all(np.array_equal(b, np.asarray(x))
                                  for b, x in zip(back, (Uj, Sj, Vtj)))
