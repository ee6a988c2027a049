"""The port's small utilities against the JAX package's on the CPU in
f64: ``ops.util``'s helpers, ``householder_reconstruct``,
``trailing_wy_update`` (against the JAX route ``use_pallas="never"``),
``config``'s names, ``testing``, ``utils.memory`` and ``utils.timing``.
Inputs are numpy-seeded; the testing generators get the JAX package's
draws (``draws=``).

Gates: exact where both compute the same operations on the same numbers
(triangles, permutations, copies, counts, the memory models, the
formatted breakdown); 1e-13 of the largest entry where a sum or an SVD
runs in another order; Householder reconstruction within 1e-13 (the same
reflector steps on an orthonormal Q).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu import config as jconfig
from randlapack_tpu import testing as jtesting
from randlapack_tpu.ops import util as jutil
from randlapack_tpu.ops.householder import \
    householder_reconstruct as j_householder_reconstruct
from randlapack_tpu.ops.pallas_wy import \
    trailing_wy_update as j_trailing_wy_update
from randlapack_tpu.sketching import SparseDist as JSparseDist
from randlapack_tpu.sketching import fill_sparse as j_fill_sparse
from randlapack_tpu.utils import analytical_peak_bytes as j_peak_bytes
from randlapack_tpu.utils import format_phase_breakdown as j_format

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import config, testing
from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.extras import mm_read
from randlapack_tpu_torch.interop import saso_from_numpy
from randlapack_tpu_torch.ops import util
from randlapack_tpu_torch.ops import wy
from randlapack_tpu_torch.ops.householder import (apply_reflectors,
                                                  householder_reconstruct)
from randlapack_tpu_torch.utils import (PeakRSSTracker, analytical_peak_bytes,
                                        debug_checks, device_memory_stats,
                                        format_phase_breakdown, get_rss_kb,
                                        profile_trace)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(x, ref, tol=1e-13):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    ref = np.asarray(ref)
    assert x.shape == ref.shape, (x.shape, ref.shape)
    np.testing.assert_allclose(x, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


RNG = np.random.default_rng(0)
SQ = RNG.standard_normal((7, 7))
TALL = RNG.standard_normal((9, 5)) * np.exp(-RNG.random(5) * 4)
PERM = RNG.permutation(9)

# name -> (port call, JAX call); each result compared exactly or at 1e-13
UTIL_CASES = {
    "eye": (lambda: util.eye(4, 6, torch.float64, device="cpu"),
            lambda: jutil.eye(4, 6, jnp.float64)),
    "get_U": (lambda: util.get_U(_t(SQ), 1), lambda: jutil.get_U(SQ, 1)),
    "get_L": (lambda: util.get_L(_t(SQ)), lambda: jutil.get_L(SQ)),
    "get_L_unit": (lambda: util.get_L(_t(SQ), True),
                   lambda: jutil.get_L(SQ, True)),
    "row_swap": (lambda: util.row_swap(_t(TALL), _t(PERM)),
                 lambda: jutil.row_swap(TALL, PERM)),
    "normc": (lambda: util.normc(_t(np.c_[TALL, np.zeros(9)])),
              lambda: jutil.normc(np.c_[TALL, np.zeros(9)])),
    "cond_num_check": (lambda: util.cond_num_check(_t(TALL)),
                       lambda: jutil.cond_num_check(TALL)),
    "rank_check": (lambda: util.rank_check(_t(np.c_[TALL, TALL[:, :2]])),
                   lambda: jutil.rank_check(np.c_[TALL, TALL[:, :2]])),
    "fro_norm": (lambda: util.fro_norm(_t(TALL)),
                 lambda: jutil.fro_norm(TALL)),
    "diag_is_nonzero": (lambda: util.diag_is_nonzero(_t(SQ), 0.5),
                        lambda: jutil.diag_is_nonzero(SQ, 0.5)),
    "rank_search_binary": (lambda: util.rank_search_binary(
        _t(np.linspace(1, 0, 11)), 0.35),
        lambda: jutil.rank_search_binary(np.linspace(1, 0, 11), 0.35)),
    "symmetrize_upper": (lambda: util.symmetrize(_t(SQ)),
                         lambda: jutil.symmetrize(SQ)),
    "symmetrize_lower": (lambda: util.symmetrize(_t(SQ), "lower"),
                         lambda: jutil.symmetrize(SQ, "lower")),
    "safe_scal": (lambda: util.safe_scal(-3.0, _t(SQ)),
                  lambda: jutil.safe_scal(-3.0, SQ)),
    "safe_scal_huge": (lambda: util.safe_scal(1e300, _t(SQ * 1e-10)),
                       lambda: jutil.safe_scal(1e300, SQ * 1e-10)),
    "omatcopy": (lambda: util.omatcopy(_t(TALL), True, 2.5),
                 lambda: jutil.omatcopy(TALL, True, 2.5)),
    "transpose_square": (lambda: util.transpose_square(_t(SQ)),
                         lambda: jutil.transpose_square(SQ)),
    "orthogonality_check": (lambda: util.orthogonality_check(_t(TALL)),
                            lambda: jutil.orthogonality_check(TALL)),
}


@pytest.mark.parametrize("name", list(UTIL_CASES))
def test_util_helper_parity(name):
    port, ref = UTIL_CASES[name]
    out, jout = port(), np.asarray(ref())
    if out.dtype in (torch.bool, torch.int32, torch.int64):
        assert out.numpy().tolist() == jout.tolist()
    else:
        _close(out, jout)


def test_util_dims_and_refusals():
    assert util.dims_before_op(3, 5, True) == jutil.dims_before_op(3, 5,
                                                                   True)
    assert util.dims_before_op(3, 5, False) == (3, 5)
    with pytest.raises(RandLAPACKError, match="square"):
        util.transpose_square(_t(TALL))


@pytest.mark.parametrize("shape", [(30, 8), (16, 16)])
def test_householder_reconstruct_parity(shape):
    Q = np.linalg.qr(np.random.default_rng(1).standard_normal(shape))[0]
    jp, jt, js = j_householder_reconstruct(jnp.asarray(Q))
    p, t, s = householder_reconstruct(_t(Q))
    _close(p, jp)
    _close(t, jt)
    assert s.numpy().tolist() == np.asarray(js).tolist()
    # the reflectors reproduce Q·diag(signs)
    _close(apply_reflectors(p, t), Q * s.numpy()[None, :])


@pytest.mark.parametrize("case", ["live", "all", "none"])
def test_trailing_wy_update_parity(case):
    """A − V·(Tᵀ·(Vᵀ·(A⊙mask)))⊙mask against the JAX jnp route; the
    caller's A is left as it was; no kernel runs on a CPU tensor."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((48, 20))
    V = rng.standard_normal((48, 6))
    T = np.triu(rng.standard_normal((6, 6)))
    mask = {"live": (rng.random(20) < 0.6).astype(float),
            "all": np.ones(20), "none": np.zeros(20)}[case]
    ref = j_trailing_wy_update(jnp.asarray(A), jnp.asarray(V),
                               jnp.asarray(T), jnp.asarray(mask),
                               use_pallas="never")
    At = _t(A)
    before = dict(wy.LAUNCHES)
    out = wy.trailing_wy_update(At, _t(V), _t(T), _t(mask))
    _close(out, ref)
    assert torch.equal(At, _t(A)) and out.data_ptr() != At.data_ptr()
    assert wy.LAUNCHES == before
    if case == "none":
        assert torch.equal(out, At)


def test_config_names():
    assert config.eps(torch.float32) == jconfig.eps(jnp.float32)
    assert config.eps("float64") == jconfig.eps(jnp.float64)
    assert config.SKETCH_PRECISION == config.STABLE_PRECISION == "highest"
    assert config.resolve_precision(None) == config.STABLE_PRECISION
    assert config.resolve_precision(jax.lax.Precision.HIGHEST) == "highest"
    assert config.resolve_precision("float32") == "highest"
    # every JAX name maps (they were refused before the driver-level
    # precision was ported); a name JAX does not take raises
    for name, want in (("default", "default"), ("high", "high"),
                       ("bfloat16", "default"), ("tensorfloat32", "high"),
                       (jax.lax.Precision.DEFAULT, "default")):
        assert config.resolve_precision(name) == want
    with pytest.raises(ValueError):
        config.resolve_precision("medium")


# -- testing.py ----------------------------------------------------------------

def test_comparison_helpers():
    A = torch.ones(4, 4, dtype=torch.float64)
    assert testing.matrices_approx_equal(A, A + 1e-14)
    assert not testing.matrices_approx_equal(A, A + 1.0)
    assert testing.matrices_approx_equal(A, A + 1e-3, rel_tol=1e-2)
    assert testing.buffs_approx_equal([1.0], [1.0 + 1e-9], 1e-8)
    assert not testing.buffs_approx_equal(A, A + 1e-6, 1e-8)
    Q = torch.linalg.qr(torch.randn(20, 5, dtype=torch.float64))[0]
    assert testing.orthogonality_error(Q) < 1e-14
    assert testing.orthogonality_error(Q) == pytest.approx(
        float(jtesting.orthogonality_error(Q.numpy())), abs=1e-15)


def test_iid_sparsify_random_dense_parity():
    """The JAX helper's two draws (Gaussian, then uniforms) injected."""
    st = JRNG(0)
    jS, jst = jtesting.iid_sparsify_random_dense(50, 40, 0.3, st)
    k1, st2 = st.spawn()
    k2, _ = st2.spawn()
    draws = (np.asarray(jax.random.normal(k1, (50, 40), jnp.float64)),
             np.asarray(jax.random.uniform(k2, (50, 40))))
    S, nst = testing.iid_sparsify_random_dense(50, 40, 0.3, rt.RNGState(0),
                                               device="cpu", draws=draws)
    assert nst.counter == int(jst.counter) == 2
    np.testing.assert_array_equal(S.numpy(), np.asarray(jS))
    frac = float((S != 0).double().mean())
    assert 0.2 < frac < 0.4
    S2, _ = testing.iid_sparsify_random_dense(50, 40, 0.3, rt.RNGState(0),
                                              device="cpu")
    assert S2.shape == (50, 40) and 0.2 < float((S2 != 0).double().mean()) \
        < 0.4


def test_random_coo_and_coo_view_of_skop():
    (r, c, v), st = testing.random_coo(20, 30, 100, rt.RNGState(1),
                                       device="cpu")
    assert r.shape == c.shape == v.shape == (100,) and st.counter == 3
    assert int(r.max()) < 20 and int(c.max()) < 30
    for d, m in ((10, 40), (40, 10)):
        op, _ = j_fill_sparse(JSparseDist(d, m, 3), JRNG(2),
                              dtype=jnp.float64)
        S = saso_from_numpy(dict(n_rows=d, n_cols=m, vec_nnz=3), op.rows,
                            op.vals, device="cpu")
        jr, jc, jv, jshape = jtesting.coo_view_of_skop(op)
        rr, cc, vv, shape = testing.coo_view_of_skop(S)
        assert shape == jshape
        np.testing.assert_array_equal(rr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(cc.numpy(), np.asarray(jc))
        _close(vv, jv, 0.0)
        D = np.zeros(shape)
        np.add.at(D, (rr.numpy(), cc.numpy()), vv.numpy())
        _close(D, rt.sketching.saso_to_dense(S), 1e-15)


def test_materialize_linop():
    from randlapack_tpu_torch.linops import DenseLinOp
    A = torch.randn(6, 4, dtype=torch.float64)
    assert torch.equal(testing.materialize_linop(DenseLinOp(A)), A)


def test_matrix_files_parity(tmp_path):
    """write_dense_to_mtx and the two file generators against the JAX
    package's on the same draws: the files read back equal."""
    A = np.random.default_rng(3).standard_normal((6, 5))
    A[2, 3] = 1e-20                       # below eps·max|A|: dropped
    p, jp = str(tmp_path / "a.mtx"), str(tmp_path / "ja.mtx")
    testing.write_dense_to_mtx(p, _t(A))
    jtesting.write_dense_to_mtx(jp, A)
    _close(mm_read(p, dense=True), mm_read(jp, dense=True), 0.0)
    assert mm_read(p, dense=True)[2, 3] == 0.0
    st = JRNG(4)
    jst = jtesting.generate_spd_matrix_file(jp, 12, 100.0, st)
    key, _ = st.spawn()
    G = np.asarray(jax.random.normal(key, (12, 12), jnp.float64))
    nst = testing.generate_spd_matrix_file(p, 12, 100.0, rt.RNGState(4),
                                           device="cpu", draws=(G,))
    assert nst.counter == int(jst.counter)
    K = mm_read(p, dense=True)
    _close(K, mm_read(jp, dense=True), 1e-12)
    w = np.linalg.eigvalsh(K)
    assert w[-1] / w[0] == pytest.approx(100.0, rel=1e-8)
    jst = jtesting.generate_invertible_matrix_file(jp, 10, 50.0, st)
    k1, st2 = st.spawn()
    k2, _ = st2.spawn()
    draws = tuple(np.asarray(jax.random.normal(k, (10, 10), jnp.float64))
                  for k in (k1, k2))
    testing.generate_invertible_matrix_file(p, 10, 50.0, rt.RNGState(4),
                                            device="cpu", draws=draws)
    _close(mm_read(p, dense=True), mm_read(jp, dense=True), 1e-12)


def test_left_multiply_by_orthmat_parity():
    A = np.random.default_rng(5).standard_normal((8, 3))
    st = JRNG(6)
    jQA, _ = jtesting.left_multiply_by_orthmat(jnp.asarray(A), st)
    key, _ = st.spawn()
    G = np.asarray(jax.random.normal(key, (8, 8), jnp.float64))
    QA, nst = testing.left_multiply_by_orthmat(_t(A), rt.RNGState(6),
                                               draws=(G,))
    assert nst.counter == 1
    _close(QA, jQA, 1e-12)
    np.testing.assert_allclose(np.linalg.norm(QA.numpy(), axis=0),
                               np.linalg.norm(A, axis=0), rtol=1e-13)


# -- utils ---------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["cholqr_linops", "scholqr3_linops",
                                       "cqrrt", "cqrrpt", "bqrrp", "rsvd",
                                       "abrik"])
def test_analytical_peak_bytes_parity(algorithm):
    for m, n, b, db in ((8192, 8192, 256, 4), (10000, 100, 50, 8)):
        assert analytical_peak_bytes(algorithm, m, n, b, db) == \
            j_peak_bytes(algorithm, m, n, b, db) > 0
    with pytest.raises(ValueError):
        analytical_peak_bytes("nope", 1, 1)


def test_format_phase_breakdown_parity():
    times = {"sketch": 0.0125, "qrcp": 0.25, "trsm": 3e-5, "cholqr": 0.1}
    assert format_phase_breakdown(times, "CQRRPT") == j_format(times,
                                                              "CQRRPT")
    assert format_phase_breakdown({}) == j_format({})


def test_host_memory_helpers():
    assert get_rss_kb() > 0
    with PeakRSSTracker(interval_s=0.001) as trk:
        x = np.ones((2000, 1000))
        x.sum()
    assert trk.peak_kb >= get_rss_kb() - 16 * 1024 and trk.peak_kb > 0


def test_device_memory_stats_without_a_card():
    """Keys of ``torch.cuda.memory_stats`` where there is a card; an empty
    dict here, as the JAX package returns for a backend without stats."""
    stats = device_memory_stats()
    assert isinstance(stats, dict)
    if not torch.cuda.is_available():
        assert stats == {}


def test_debug_checks_raise_on_nan_and_restore():
    with debug_checks():
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor(-1.0)) * 0 + torch.sqrt(
                torch.tensor(-1.0))
        assert float(torch.sqrt(torch.tensor(4.0))) == 2.0
    assert not torch.is_anomaly_enabled()
    assert math.isnan(float(torch.log(torch.tensor(-1.0))))


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
