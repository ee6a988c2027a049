"""The JAX package's edge cases (``tests/test_edge_cases.py``) on the port,
on the CPU in f64 unless the case is f32. Each case runs the JAX test's own
gates on the port; where both packages are cheap on the same input it also
runs the JAX function, with every draw of the JAX driver injected into the
port (``tests/_torch_pairs.py``), and holds ``fail`` and rank equal and the
pivots and R by the rank-aware rules of ROADMAP.md §3.

Cases held elsewhere on the port, not repeated here:
- ``TestNearSquareSketchDepth::test_cqrrpt_near_square``:
  ``tests/test_torch_cqrrpt.py::test_cqrrpt_near_square_uses_A_as_its_sketch``;
- ``TestNearSquareSketchDepth::test_spls_near_square``:
  ``tests/test_torch_spls.py::test_spls_near_square_draws_no_sketch``;
- ``TestGeneratorWideShapes::test_hqrrp_cholqr_panel_breakdown_stays_finite``:
  ``tests/test_torch_hqrrp.py::test_cholqr_panel_breakdown_stays_finite``.

``TestInfSanitization``'s sanitize and ``lu_pivot_columns`` cases are one
parametrised test here with the bitwise parity cases that
``tests/test_torch_ops.py`` held before (``test_inf_sanitization``). The
JAX tests' TPU reasons (XLA's TPU LU wedging on Inf) do not apply to the
card, but the semantics they pin are the reference's, so the port keeps
them.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu import drivers as jd
from randlapack_tpu import sketching as jsk
from randlapack_tpu.gen import MatGenInfo, MatType, fast_decay_matrix, mat_gen

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import drivers as td
from randlapack_tpu_torch import linops as tl
from randlapack_tpu_torch import sketching as tsk
from randlapack_tpu_torch.comps import PCGConfig, QBConfig, qb_blocked
from randlapack_tpu_torch.errors import RandLAPACKError

from _torch_pairs import (JaxRNG, bqrrp_sketch, compare_pivoted,
                          hqrrp_sketch, qb_omegas, qr_residual,
                          tall_qr_draws)

jbq = importlib.import_module("randlapack_tpu.drivers.bqrrp")
jqr = importlib.import_module("randlapack_tpu.ops.qr")
jchol = importlib.import_module("randlapack_tpu.ops.cholqr")
jorth = importlib.import_module("randlapack_tpu.comps.orth")
tbq = importlib.import_module("randlapack_tpu_torch.drivers.bqrrp")
tqr = importlib.import_module("randlapack_tpu_torch.ops.qr")
tchol = importlib.import_module("randlapack_tpu_torch.ops.cholqr")
torth = importlib.import_module("randlapack_tpu_torch.comps.orth")
tsvd = importlib.import_module("randlapack_tpu_torch.ops.svd")
tdet = importlib.import_module("randlapack_tpu_torch.comps.determiter")

hp = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint64 if x.dtype == np.float64 else np.uint32)


def _gen(m, n, kind, seed, **kw):
    A, st = mat_gen(MatGenInfo(m, n, kind, **kw), JRNG(seed))
    return np.array(A), st


# -- TestZeroAndDegenerate -------------------------------------------------------

def test_geqp3_zero_matrix():
    Qj, Rj, Jj = jqr.geqp3(jnp.zeros((20, 10)))
    Q, R, J = tqr.geqp3(torch.zeros((20, 10), dtype=torch.float64))
    assert bool(torch.isfinite(Q).all()) and float(torch.linalg.norm(R)) == 0
    assert float(jnp.linalg.norm(Rj)) == 0.0
    assert sorted(J.tolist()) == list(range(10))


def test_bqrrp_wide_rank1():
    A = np.ones((60, 120))
    kw = dict(block_size=30)
    oj = jd.bqrrp(jnp.asarray(A), jd.BQRRPConfig(**kw), JRNG(0))
    Q, R, J, rank, fail, _ = td.bqrrp(
        _t(A), td.BQRRPConfig(**kw), rt.RNGState(0),
        sketch=_t(bqrrp_sketch(JaxRNG(JRNG(0)), A.shape, 30)))
    assert int(rank) <= 2
    res = float(torch.linalg.norm(Q[:, :1] @ R[:1] - _t(A)[:, J]))
    assert res < 1e-10 * np.linalg.norm(A)
    assert int(rank) == int(oj[3]) and bool(fail) == bool(oj[4])
    assert compare_pivoted(oj[1], oj[2], R, J) is None


def test_pcg_zero_rhs():
    X, hist, it = tdet.pcg(torch.eye(10, dtype=torch.float64),
                           torch.zeros((10, 2), dtype=torch.float64), None,
                           torch.zeros((10, 2), dtype=torch.float64),
                           PCGConfig())
    assert float(torch.linalg.norm(X)) == 0.0 and int(it) == 0


def test_qb_exact_rank():
    A, _ = mat_gen(MatGenInfo(200, 150, MatType.gaussian), JRNG(1))
    A = np.asarray(A[:, :32] @ jnp.ones((32, 150), jnp.float64) * 0.1
                   + A[:, :32] @ jax.random.normal(jax.random.key(0),
                                                   (32, 150),
                                                   dtype=jnp.float64))
    from randlapack_tpu.comps import QBConfig as JQBConfig
    from randlapack_tpu.comps import qb_blocked as j_qb_blocked
    _, _, errs_j, _ = j_qb_blocked(jnp.asarray(A), 64,
                                   JQBConfig(block_size=32), JRNG(2))
    oms = [_t(o) for o in qb_omegas(JaxRNG(JRNG(2)), A.shape, 64, 32)]
    _, _, errs, _ = qb_blocked(_t(A), 64, QBConfig(block_size=32),
                               rt.RNGState(2), omegas=oms)
    assert float(errs[0]) < 1e-10 and float(errs_j[0]) < 1e-10


def test_svd_econ_rank_deficient():
    U, s, Vt = tsvd.svd_econ(torch.ones((40, 30), dtype=torch.float64),
                             method="gram_eigh")
    assert abs(float(s[0]) - math.sqrt(40 * 30)) < 1e-8
    assert float(s[1]) < 1e-6 * float(s[0])
    assert bool(torch.isfinite(Vt).all())


def test_abrik_k_too_big():
    """JAX asserts; the port raises its named error."""
    with pytest.raises(RandLAPACKError, match="max_iters"):
        td.abrik(torch.ones((50, 40)), 30,
                 td.ABRIKConfig(block_size=4, max_iters=2),
                 rt.RNGState(3))


# -- TestSketchingEdges ----------------------------------------------------------

def test_sketch_right_dense():
    op, _ = tsk.dense_skop(tsk.DenseDist(60, 20), rt.RNGState(4),
                           dtype=torch.float64, device="cpu")
    A = _t(jax.random.normal(jax.random.key(1), (5, 60), dtype=jnp.float64))
    out = tsk.sketch_right(A, op)
    ref = A @ op.mat * op.dist.isometry_scale
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12)


def test_srht_non_pow2():
    """m = 1000 pads to 1024 inside; the JAX-drawn operator on both."""
    jop, _ = jsk.srht_skop(128, 1000, JRNG(5), dtype=jnp.float64)
    op, _ = JaxRNG(JRNG(5)).srht(128, 1000)
    A = jax.random.normal(jax.random.key(2), (1000, 8), dtype=jnp.float64)
    out = tsk.srht_left_apply(op, _t(A))
    assert tuple(out.shape) == (128, 8) and bool(torch.isfinite(out).all())
    ref = np.asarray(jsk.srht_left_apply(jop, A))
    assert np.abs(out.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_saso_single_nnz():
    op, _ = JaxRNG(JRNG(6)).saso(16, 100, 1)
    S_dense = tsk.saso_to_dense(op)
    out = tsk.saso_left_apply(op, torch.eye(100, dtype=torch.float64))
    np.testing.assert_allclose(out.numpy(), S_dense.numpy(), atol=1e-14)
    jop, _ = jsk.fill_sparse(jsk.SparseDist(16, 100, vec_nnz=1), JRNG(6),
                             dtype=jnp.float64)
    np.testing.assert_array_equal(S_dense.numpy(),
                                  np.asarray(jsk.saso_to_dense(jop)))


# -- TestValidation, TestDtypes ------------------------------------------------

def test_composite_shape_mismatch():
    with pytest.raises(RandLAPACKError):
        tl.CompositeLinOp(tl.DenseLinOp(torch.ones((5, 4))),
                          tl.DenseLinOp(torch.ones((3, 2))))


def test_cqrrt_bad_dfactor_still_works():
    """d_factor exactly 1.0: a square sketch, still valid."""
    A, st = _gen(500, 50, MatType.exponential, 7, cond_num=100)
    jcfg = jd.CQRRTConfig(d_factor=1.0)
    Qj, Rj, fj, _ = jd.cqrrt(jnp.asarray(A), jcfg, st)
    op, _, _ = tall_qr_draws(JaxRNG(st), A.shape, jcfg.sketch, 1.0,
                             jcfg.vec_nnz)
    Q, R, fail, _ = td.cqrrt(_t(A), td.CQRRTConfig(d_factor=1.0),
                             rt.RNGState(7), sketch=op)
    assert not bool(fail) and bool(fail) == bool(fj)
    orth = float(torch.linalg.norm(Q.T @ Q - torch.eye(50,
                                                       dtype=Q.dtype)))
    assert orth < 1e-9
    assert np.abs(Q.numpy() - np.asarray(Qj)).max() <= 1e-10


def test_f32_pipeline():
    """The whole RSVD stack in f32 on the CPU."""
    A, _ = mat_gen(MatGenInfo(256, 256, MatType.exponential, cond_num=100),
                   JRNG(8), dtype=jnp.float32)
    oms = [_t(o, torch.float32)
           for o in qb_omegas(JaxRNG(JRNG(9)), A.shape, 64, 32)]
    U, S, Vt, err, _ = td.rsvd_fixed_rank(
        _t(A), 64, td.RSVDConfig(QBConfig(block_size=32)), rt.RNGState(9),
        omegas=oms)
    assert U.dtype == torch.float32
    orth = float(torch.linalg.norm(U.T.double() @ U.double()
                                   - torch.eye(64, dtype=torch.float64)))
    assert orth < 1e-4


# -- TestBQRRPZeroFamily ---------------------------------------------------------

def _zero_family(case):
    if case == "zero":
        return np.zeros((96, 96))
    if case == "near_zero":
        return np.full((96, 96), 1e-290)
    A, _ = _gen(128, 128, MatType.gaussian, 10)
    A[:, 64:] = 0.0
    return A


@pytest.mark.parametrize("case", ["zero", "near_zero", "half_zero"])
def test_bqrrp_zero_family(case):
    """The reference fixture's zero-input variants (test_bqrrp.cc:265-331)
    through the explicit and the factored BQRRP, both packages."""
    A = _zero_family(case)
    n = A.shape[1]
    cfg = dict(block_size=32)
    S = _t(bqrrp_sketch(JaxRNG(JRNG(9)), A.shape, 32))
    oj = jd.bqrrp(jnp.asarray(A), jd.BQRRPConfig(**cfg), JRNG(9))
    fj, _ = jd.bqrrp_factored(jnp.asarray(A), jd.BQRRPConfig(**cfg),
                              JRNG(9))
    Q, R, J, rank, fail, _ = td.bqrrp(_t(A), td.BQRRPConfig(**cfg),
                                      rt.RNGState(9), sketch=S)
    fac, _ = td.bqrrp_factored(_t(A), td.BQRRPConfig(**cfg),
                               rt.RNGState(9), sketch=S)
    Qf = td.bqrrp_q(fac)
    eye = torch.eye(n, dtype=torch.float64)
    assert bool(torch.isfinite(Q).all() and torch.isfinite(Qf).all())
    assert bool(torch.isfinite(fac.R).all())
    if case == "zero":
        assert float(torch.linalg.norm(R)) == 0.0
        assert float(torch.linalg.norm(fac.R)) == 0.0
        assert float(torch.linalg.norm(Qf.T @ Qf - eye)) < 1e-12
    if case == "half_zero":
        AJ = _t(A)[:, fac.J]
        res = float(torch.linalg.norm(Qf[:, :64] @ fac.R[:64] - AJ)
                    / np.linalg.norm(A))
        assert res < 1e-12 and int(fac.rank) <= 70
        assert float(torch.linalg.norm(Qf.T @ Qf - eye)) < 1e-11
        assert compare_pivoted(fj.R, fj.J, fac.R, fac.J) is None
        assert compare_pivoted(oj[1], oj[2], R, J) is None
    assert bool(fail) == bool(oj[4]) and bool(fac.fail) == bool(fj.fail)
    assert int(rank) == int(oj[3]) and int(fac.rank) == int(fj.rank)


# -- TestNearSquareSketchDepth, TestGeneratorWideShapes ------------------------

def test_cqrrt_near_square():
    """d = 1.25·n ≥ m: CQRRT takes A as its own sketch, nothing drawn."""
    A, st = _gen(40, 36, MatType.gaussian, 11)
    Qj, Rj, fj, _ = jd.cqrrt(jnp.asarray(A), jd.CQRRTConfig(), st)
    Q, R, fail, _ = td.cqrrt(_t(A), td.CQRRTConfig(), rt.RNGState(11))
    assert float(torch.linalg.norm(Q @ R - _t(A)) / np.linalg.norm(A)) \
        < 1e-12
    assert bool(fail) == bool(fj)
    assert np.abs(R.numpy() - np.asarray(Rj)).max() <= 1e-10 * np.abs(
        np.asarray(Rj)).max()


def test_bad_cholqr_wide():
    A, _ = rt.gen.bad_cholqr_matrix(31, 99, rt.RNGState(0), torch.float64,
                                    device="cpu")
    assert tuple(A.shape) == (31, 99)
    s = np.linalg.svd(A.numpy(), compute_uv=False)
    assert s[0] / s[-1] > 1e6


# -- TestInfSanitization ---------------------------------------------------------

def _sanitize_parity(case):
    """Bitwise parity of _sanitize_sketch (from tests/test_torch_ops.py)."""
    rng = np.random.default_rng(2)
    Y = rng.standard_normal((20, 30))
    if case == "overflowing":
        Y *= 3.1e9
    elif case == "nonfinite":
        Y[0, 0], Y[5, 7] = -np.inf, np.nan
    Yj, fj = jbq._sanitize_sketch(jnp.asarray(Y), jnp.asarray(False),
                                  jnp.float64)
    Yt, ft = tbq._sanitize_sketch(torch.tensor(Y), torch.tensor(False))
    np.testing.assert_array_equal(_bits(Yj), _bits(Yt))
    assert bool(fj) == bool(ft) == (case == "nonfinite")


def _sanitize_rescales_and_flags():
    """The JAX edge test's f32 semantics on the port."""
    Y = torch.ones((8, 16), dtype=torch.float32) * 1e12
    Y2, fail = tbq._sanitize_sketch(Y, torch.tensor(False))
    assert not bool(fail)
    assert float(Y2.abs().max()) <= 1e8 * (1 + 1e-6)
    Yr = _t(jax.random.normal(jax.random.key(0), (8, 16), jnp.float32))
    Yr2, _ = tbq._sanitize_sketch(Yr * 1e12, torch.tensor(False))
    np.testing.assert_array_equal(np.argsort((Yr * Yr).sum(0).numpy()),
                                  np.argsort((Yr2 * Yr2).sum(0).numpy()))
    Yh2, fail_h = tbq._sanitize_sketch(Yr, torch.tensor(False))
    assert torch.equal(Yh2, Yr) and not bool(fail_h)
    Yb = Yr.clone()
    Yb[2, 3], Yb[4, 5] = math.inf, math.nan
    Yb2, fail_b = tbq._sanitize_sketch(Yb, torch.tensor(False))
    assert bool(fail_b) and bool(torch.isfinite(Yb2).all())


def _lu_pivots(case):
    """Exact parity of lu_pivot_columns (from tests/test_torch_ops.py), and
    the JAX edge test's Inf column."""
    rng = np.random.default_rng(8)
    n, d = (40, 64) if case == "wide" else (160, 40)
    P = rng.standard_normal((n, d))
    if case == "deficient":
        # fewer live rows than d: the δ pad decides the tail of the order
        P[rng.permutation(n)[:130]] = 0.0
    elif case == "zero":
        P[:] = 0.0
    elif case == "inf":
        P = np.array(jax.random.normal(jax.random.key(1), (32, 8),
                                       jnp.float64))
        P[:, 2] = np.inf
    pj = np.asarray(jqr.lu_pivot_columns(jnp.asarray(P)))
    pt = tqr.lu_pivot_columns(torch.tensor(P)).numpy()
    np.testing.assert_array_equal(pj, pt)
    assert sorted(pt.tolist()) == list(range(P.shape[0]))


SANITIZATION = {
    **{f"sanitize_{c}": (_sanitize_parity, c)
       for c in ("healthy", "overflowing", "nonfinite")},
    "sanitize_rescales_and_flags": (_sanitize_rescales_and_flags, None),
    **{f"lu_pivot_columns_{c}": (_lu_pivots, c)
       for c in ("dense", "deficient", "wide", "zero", "inf")},
}


@pytest.mark.parametrize("case", list(SANITIZATION))
def test_inf_sanitization(case):
    fn, arg = SANITIZATION[case]
    fn() if arg is None else fn(arg)


def test_stabilize_plu_inf_flags():
    A = np.array(jax.random.normal(jax.random.key(2), (24, 6),
                                   jnp.float64))
    B, fail = torth.stabilize(_t(A), torth.Stab.plu)
    Bj, _ = jorth.stabilize(jnp.asarray(A), jorth.Stab.plu)
    assert not bool(fail) and bool(torch.isfinite(B).all())
    assert np.abs(B.numpy() - np.asarray(Bj)).max() <= 1e-12
    A[3, 3] = np.inf
    B2, fail2 = torth.stabilize(_t(A), torth.Stab.plu)
    assert bool(fail2) and bool(torch.isfinite(B2).all())


def test_bqrrp_b512_wide_lu_config_cpu():
    """The worker-killer config class (full-width LU pivots, b = n/4),
    CPU-sized: correct with no flag."""
    A, st = fast_decay_matrix(256, 256, JRNG(3), dtype=jnp.float64,
                              decay=9.0)
    A = np.asarray(A)
    Q, R, J, rank, fail, _ = td.bqrrp(
        _t(A), td.BQRRPConfig(block_size=64), rt.RNGState(3),
        sketch=_t(bqrrp_sketch(JaxRNG(st), A.shape, 64)))
    res, perm = qr_residual(A, Q, R, J)
    assert res < 1e-10 and perm and not bool(fail)
    oj = jd.bqrrp(jnp.asarray(A), jd.BQRRPConfig(block_size=64), st)
    assert bool(oj[4]) == bool(fail)
    assert compare_pivoted(oj[1], oj[2], R, J, tol=1e-8) is None


def test_cholqr_inf_and_huge_inputs():
    """Inf entries: the flag with finite R; huge finite f32 inputs factor
    through the scale guard; the shifted variant likewise."""
    A = _t(jax.random.normal(jax.random.key(7), (64, 8), jnp.float64))
    assert not bool(tchol.cholqr(A)[2])
    A32 = _t(jax.random.normal(jax.random.key(8), (64, 8), jnp.float32)
             * jnp.float32(1e25))

    def rel_res(Q, R):
        D = Q.double() @ R.double() - A32.double()
        return float(torch.linalg.norm(D) / torch.linalg.norm(A32.double()))

    Qh, Rh, fh = tchol.cholqr(A32)
    assert not bool(fh) and rel_res(Qh, Rh) < 1e-5
    assert bool(torch.isfinite(Rh).all())
    Ai = A32.clone()
    Ai[3, 3] = math.inf
    Qi, Ri, fi = tchol.cholqr(Ai)
    assert bool(fi) and bool(torch.isfinite(Ri).all())
    assert bool(jchol.cholqr(jnp.asarray(Ai.numpy()), hp)[2])
    Qs, Rs, fs = tchol.shifted_cholqr3(A32)
    assert not bool(fs) and rel_res(Qs, Rs) < 1e-5


# -- TestTallOnlyContracts -------------------------------------------------------

def test_cqrrt_cqrrpt_wide_inputs_raise_loudly():
    A = _t(jax.random.normal(jax.random.key(0), (32, 48), jnp.float64))
    with pytest.raises(RandLAPACKError, match="tall"):
        td.cqrrt(A, td.CQRRTConfig(), rt.RNGState(1))
    with pytest.raises(RandLAPACKError, match="tall"):
        td.cqrrpt(A, td.CQRRPTConfig(), rt.RNGState(1))


# -- a probe of the fuzz: HQRRP with an Inf entry ------------------------------

def test_hqrrp_inf_entry_is_a_shared_reference_behaviour():
    """One Inf entry through f64 HQRRP (96×64, b 16): both packages return
    non-finite Q and R with ``fail`` False. The reference behaviour is
    kept as it is (ROADMAP.md §3, "Constraints"): ``fail`` equal in both,
    and the non-finite output in both."""
    A, st = _gen(96, 64, MatType.exponential, 41, cond_num=1e3)
    A[10, 7] = np.inf
    cfg = dict(block_size=16)
    Qj, Rj, Jj, rj, fj, _ = jd.hqrrp(jnp.asarray(A), jd.HQRRPConfig(**cfg),
                                     st)
    Q, R, J, rank, fail, _ = td.hqrrp(
        _t(A), td.HQRRPConfig(**cfg), rt.RNGState(41),
        sketch=_t(hqrrp_sketch(JaxRNG(st), A.shape, 16)))
    assert bool(fail) == bool(fj) is False
    assert not bool(np.isfinite(np.asarray(Qj)).all()
                    and np.isfinite(np.asarray(Rj)).all())
    assert not bool(torch.isfinite(Q).all() and torch.isfinite(R).all())


# -- the card's edge checks (randlapack_tpu_torch.utils.kernel_checks) ---------
# On the CPU the kernels' wrappers are pointed at their plain versions (and
# at wrong ones), so the rules that chip_smoke.py's [edge] phase and
# tools/fuzz_torch.py's card mode apply on the card are held here: a faithful
# kernel passes, a wrong or differently non-finite one fails, and pivots may
# part only at a tie.

kc = importlib.import_module("randlapack_tpu_torch.utils.kernel_checks")
twy = importlib.import_module("randlapack_tpu_torch.ops.wy")
tlu = importlib.import_module("randlapack_tpu_torch.ops.lu")
tqrcp = importlib.import_module("randlapack_tpu_torch.ops.qrcp")
tkern = importlib.import_module("randlapack_tpu_torch.ops.kernels")


@pytest.fixture
def plain_kernels(monkeypatch):
    """Every kernel wrapper pointed at its plain version."""
    monkeypatch.setattr(twy, "masked_vt_a",
                        lambda V, A, m, chunk=None:
                        twy.masked_vt_a_reference(V, A, m))
    monkeypatch.setattr(twy, "a_minus_vz_masked",
                        lambda A, V, Z, m, chunk=None: A.copy_(
                            twy.a_minus_vz_masked_reference(A, V, Z, m)))
    monkeypatch.setattr(twy, "masked_vt_a_form",
                        lambda V, A, m, f, chunk=None: getattr(
                            twy, f"masked_vt_a_{f}_reference")(V, A, m))
    monkeypatch.setattr(twy, "a_minus_vz_masked_form",
                        lambda A, V, Z, m, f, chunk=None: A.copy_(getattr(
                            twy, f"a_minus_vz_masked_{f}_reference")(
                                A, V, Z, m)))
    monkeypatch.setattr(tlu, "getrfnp_cuda", tlu.getrfnp)
    monkeypatch.setattr(tqrcp, "qrcp_select_pivots_cuda",
                        tqr.qrcp_select_pivots)
    monkeypatch.setattr(tqrcp, "qrcp_panel_cuda", lambda P, r0, pivot=True:
                        (lambda o: (o[0], o[2], o[3]))(
                            tqr.qrcp_panel(P, r0, pivot)))
    monkeypatch.setattr(tkern, "kernel_matmat", lambda X, V, bw:
                        tkern.kernel_matmat_reference(X, V, bw))
    monkeypatch.setattr(tkern, "gaussian_sketch_cuda",
                        tkern.gaussian_sketch_reference)
    return monkeypatch


@pytest.mark.parametrize("kernel", kc.KERNELS)
def test_kernel_checks_pass_a_faithful_kernel(plain_kernels, kernel):
    for how in kc.MUTATORS:
        if kernel in kc.PIVOTING and how in ("inf", "nan"):
            continue
        r = kc.hold(kernel, *kc.operands(kernel, how, True, "cpu"))
        assert r["ok"], (kernel, how, r)


def test_kernel_checks_refuse_wrong_kernels(plain_kernels):
    ops = kc.operands("masked_vt_a", "colscale", True, "cpu")
    plain_kernels.setattr(twy, "masked_vt_a", lambda V, A, m, chunk=None:
                          twy.masked_vt_a_reference(V, A, m) * (1 + 1e-3))
    assert not kc.hold("masked_vt_a", *ops)["ok"]
    # finite where the plain version is not: Inf turned into 0
    ops = kc.operands("masked_vt_a", "inf", True, "cpu")
    plain_kernels.setattr(twy, "masked_vt_a", lambda V, A, m, chunk=None:
                          twy.masked_vt_a_reference(V, A.nan_to_num(
                              posinf=0.0), m))
    r = kc.hold("masked_vt_a", *ops)
    assert not r["ok"] and "finite" in r["why"]
    # K5 choosing the plain version's pivots in another order
    ops = kc.operands("qrcp_select_pivots", "colscale", True, "cpu")
    plain_kernels.setattr(tqrcp, "qrcp_select_pivots_cuda",
                          lambda Y, k, live: tqr.qrcp_select_pivots(
                              Y, k, live).flip(0))
    r = kc.hold("qrcp_select_pivots", *ops)
    assert not r["ok"] and "part at step 0" in r["why"]
    # K3 with its first sign flipped
    ops = kc.operands("getrfnp", "colscale", True, "cpu")
    plain_kernels.setattr(tlu, "getrfnp_cuda", lambda M: (
        lambda F, s: (F, torch.cat([-s[:1], s[1:]])))(*tlu.getrfnp(M)))
    assert not kc.hold("getrfnp", *ops)["ok"]


def test_kernel_checks_allow_a_tie():
    """Two exactly equal columns: either is a right first pivot."""
    Y = torch.randn((20, 12), dtype=torch.float64)
    Y[:, 7] = Y[:, 3]
    Y[:, 3] *= 10
    Y[:, 7] *= 10
    ok, why, agree = kc._hold_pivots(Y, torch.tensor([7, 0]),
                                     torch.tensor([3, 0]))
    assert ok and not agree and "tie" in why
    ok, _, _ = kc._hold_pivots(Y, torch.tensor([1, 0]), torch.tensor([3, 0]))
    assert not ok


def test_kernel_checks_recorder(plain_kernels):
    """The recorder keeps each kernel's first operands and restores the
    wrappers; it reads the launch counts around the run."""
    V, A, mask = kc.operands("masked_vt_a", "kahan", True, "cpu")
    with kc.Recorder() as rec:
        twy.masked_vt_a(V, A, mask)
        twy.masked_vt_a_form(V, A, mask, "bf16")
        twy.masked_vt_a(V * 2, A, mask)
    assert sorted(rec.calls) == ["masked_vt_a", "masked_vt_a_bf16"]
    assert torch.equal(rec.calls["masked_vt_a"][0][0], V)
    assert all(r["ok"] for r in rec.hold().values())
    assert rec.launches == {}
    assert twy.masked_vt_a(V, A, mask).shape == (V.shape[1], A.shape[1])


def test_qrcp_panel_keeps_untouched_entries_where_a_norm_overflows():
    """A repair of the plain K6 found by [edge]: at 2^60 on 1024 rows the
    f32 column sums of squares overflow and the first tau is NaN in both
    packages and in the kernel. Rows < row0 and finished columns are
    never transformed (the docstring; the kernel keeps them), and the
    plain version now keeps them too, where it spread NaN through 0·NaN in
    its masked update as the JAX package's panel still does (a recorded
    departure, ROADMAP.md §3). On finite data the two updates agree."""
    P, r0 = kc.operands("qrcp_panel", "2^60", False, "cpu")
    W, _, taus, _ = tqr.qrcp_panel(P, r0)
    assert not bool(torch.isfinite(taus[0]))
    assert bool(torch.isfinite(W[:r0]).all())
    assert bool(torch.isfinite(W[r0 + 1:, 0]).all())
    Wj = np.asarray(jqr.qrcp_panel(jnp.asarray(P.numpy()), r0)[0])
    assert not np.isfinite(Wj[:r0]).any()
    P2 = P / 2.0 ** 60
    Wf, _, tf, sf = tqr.qrcp_panel(P2, r0)
    Wjf, _, tjf, sjf = jqr.qrcp_panel(jnp.asarray(P2.numpy()), r0)
    np.testing.assert_array_equal(sf.numpy(), np.asarray(sjf))
    assert np.abs(Wf.numpy() - np.asarray(Wjf)).max() \
        <= 1e-5 * np.abs(np.asarray(Wjf)).max()
