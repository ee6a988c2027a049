"""The port's symmetric low-rank layer (randlapack_tpu_torch: SYPS, SYRF,
REVD2, ``nystrom_pc_data``) against the JAX package's on the CPU in f64,
on a dense tensor, ``ExplicitSymLinOp`` and the implicit
``SquaredExpKernelLinOp`` (whose CPU ``matmat`` is K4's plain version).
Inputs come from the JAX generators (``psd_from_eigvals``) or from
``pdkernels``' standardized Gaussian points; every Gaussian draw is made
by JAX from the same state as its function draws it (SYPS's start, then
the power estimate's, ``state.spawn()`` each) and injected (``omega=``,
``v0=``, ``draw=``).

Gates: λ within 1e-12 of λ₁; the error estimate within 1e-12 of λ₁ (it
is a norm of size λₖ₊₁ computed from the same start); V and SYPS/SYRF's
bases within 1e-10 absolute after aligning each column's sign (V on the
leading, well-separated eigenvalues); ``fail`` and ``k_used`` equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu import linops as jl, pdkernels as jpd
from randlapack_tpu.comps import SYPSConfig as JSYPSConfig
from randlapack_tpu.comps import SYRFConfig as JSYRFConfig
from randlapack_tpu.comps import nystrom_pc_data as j_nystrom_pc_data
from randlapack_tpu.comps import syps as j_syps
from randlapack_tpu.comps import syrf as j_syrf
from randlapack_tpu.drivers import REVD2Config as JREVD2Config
from randlapack_tpu.drivers import revd2 as j_revd2
from randlapack_tpu.drivers import revd2_fixed_rank as j_revd2_fixed_rank
from randlapack_tpu.gen import psd_from_eigvals

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import interop, linops as tl, pdkernels as tpd
from randlapack_tpu_torch.comps import (SYPSConfig, SYRFConfig,
                                        nystrom_pc_data, syps, syrf)
from randlapack_tpu_torch.drivers import (REVD2Config, revd2,
                                          revd2_fixed_rank)

HI = jax.lax.Precision.HIGHEST


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


REL = 1e-12
ABS = 1e-10


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _abs(a, b):
    return np.abs(_np(a) - _np(b)).max()


def _tstate(st, seed=0):
    return rt.RNGState(seed, _counter=int(st.counter))


def _normal(st, shape):
    key, _ = st.spawn()
    return _t(jax.random.normal(key, shape, dtype=jnp.float64))


def _jax_draws(st):
    """``draw(shape, k)`` for the port's ``revd2``: JAX's draws from st,
    in its order (each round SYPS's start, then the power estimate's)."""
    state = [st]

    def draw(shape, k):
        key, state[0] = state[0].spawn()
        return _t(jax.random.normal(key, shape, dtype=jnp.float64))
    return draw


def _aligned(ref, x, k):
    ref, x = _np(ref)[:, :k], _np(x)[:, :k]
    s = np.sign(np.sum(ref * x, axis=0))
    return x * np.where(s == 0, 1.0, s), ref


def _psd(n, lam, seed):
    A, st = psd_from_eigvals(n, jnp.asarray(lam, jnp.float64), JRNG(seed))
    return np.asarray(A), st


def _kernel_pair(n=256, d=4, bw=1.5, seed=5):
    # the JAX test's operator (tests/test_determiter_more.py): standardized
    # Gaussian points, the unregularized kernel
    X = jpd.standardize_dataset(jax.random.normal(
        jax.random.key(seed), (d, n), dtype=jnp.float64))
    jop = jpd.SquaredExpKernelLinOp(X, bw, 0.0, evals_include_reg=False,
                                    block=64)
    top = tpd.SquaredExpKernelLinOp(_t(X), bw, 0.0, evals_include_reg=False,
                                    block=64)
    return jop, top, np.asarray(jpd.squared_exp_kernel(X, X, bw))


def _operators(kind):
    """(JAX operator, port operator, dense matrix, JAX state)."""
    if kind == "kernel":
        jop, top, K = _kernel_pair()
        return jop, top, K, JRNG(6)
    A, st = _psd(120, 0.8 ** np.arange(120), 31)
    if kind == "dense":
        return jnp.asarray(A), _t(A), A, st
    return jl.ExplicitSymLinOp(jnp.asarray(A)), tl.ExplicitSymLinOp(_t(A)), \
        A, st


KINDS = ["dense", "explicit", "kernel"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("passes,per_stab", [(3, 1), (2, 2)])
def test_syps_matches_jax(kind, passes, per_stab):
    jop, top, _, st = _operators(kind)
    n = top.dim if kind != "dense" else top.shape[0]
    cfg = dict(passes_over_data=passes, passes_per_stab=per_stab)
    om, nst = syps(top, 12, SYPSConfig(**cfg), _tstate(st),
                   omega=_normal(st, (n, 12)))
    omj, jst = j_syps(jop, 12, JSYPSConfig(**cfg), st, HI)
    scale = max(1.0, np.abs(np.asarray(omj)).max())
    assert _abs(om, omj) <= ABS * scale
    assert nst.counter == int(jst.counter) == int(st.counter) + 1


@pytest.mark.parametrize("kind", KINDS)
def test_syrf_matches_jax(kind):
    jop, top, _, st = _operators(kind)
    n = _np(top).shape[0] if kind == "dense" else top.dim
    Q, nst = syrf(top, 10, SYRFConfig(), _tstate(st),
                  omega=_normal(st, (n, 10)))
    Qj, jst = j_syrf(jop, 10, JSYRFConfig(), st, HI)
    assert _abs(Q, Qj) <= ABS
    assert nst.counter == int(jst.counter)


def _fixed_rank_pair(jop, top, k, st, cfg=None):
    n = _np(top).shape[0] if isinstance(top, torch.Tensor) else top.dim
    draw = _jax_draws(st)
    out = revd2_fixed_rank(top, k, REVD2Config(**(cfg or {})), _tstate(st),
                           omega=draw((n, k), k), v0=draw((n, 1), k))
    ref = j_revd2_fixed_rank(jop, k, JREVD2Config(**(cfg or {})), st, HI)
    return out, ref


@pytest.mark.parametrize("kind", KINDS)
def test_revd2_fixed_rank_matches_jax(kind):
    jop, top, K, st = _operators(kind)
    (V, lam, err, nu, fail, nst), (Vj, lj, ej, nuj, fj, jst) = \
        _fixed_rank_pair(jop, top, 24, st)
    lmax = float(np.asarray(lj)[0])
    assert bool(fail) == bool(fj) is False
    assert np.abs(_np(lam) - np.asarray(lj)).max() <= REL * lmax
    assert abs(float(err) - float(ej)) <= REL * lmax
    assert abs(float(nu) - float(nuj)) <= REL * float(nuj)
    x, ref = _aligned(Vj, V, 8)
    assert _abs(x, ref) <= ABS
    assert nst.counter == int(jst.counter) == int(st.counter) + 2
    if kind == "kernel":
        # the JAX test's own check: the top eigenvalues of K
        w = np.linalg.eigvalsh(K)[::-1]
        np.testing.assert_allclose(_np(lam)[:8], w[:8], rtol=1e-4)


def test_revd2_fixed_rank_config_variants():
    jop, top, _, st = _operators("dense")
    cfg = dict(error_est_passes=4, svd_method="gram_eigh")
    (V, lam, err, _, fail, _), (Vj, lj, ej, _, fj, _) = _fixed_rank_pair(
        jop, top, 16, st, cfg)
    lmax = float(np.asarray(lj)[0])
    assert bool(fail) == bool(fj)
    assert np.abs(_np(lam) - np.asarray(lj)).max() <= REL * lmax
    assert abs(float(err) - float(ej)) <= REL * lmax


def test_revd2_fixed_rank_breakdown_is_nan():
    # an indefinite input: the shifted Cholesky breaks down; V, λ and the
    # estimate are NaN in both packages and ``fail`` is set
    rng = np.random.default_rng(0)
    U, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    A = (U * np.linspace(1, -5, 40)) @ U.T
    st = JRNG(0)
    (V, lam, err, _, fail, _), (Vj, lj, ej, _, fj, _) = _fixed_rank_pair(
        jnp.asarray(A), _t(A), 8, st)
    assert bool(fail) and bool(fj)
    assert bool(torch.isnan(V).all() and torch.isnan(lam).all())
    assert np.isnan(float(err)) and np.isnan(float(ej))
    _, _, k_used, err, failed, _ = revd2(_t(A), 4, 1e-6, REVD2Config(),
                                         _tstate(st), draw=_jax_draws(st))
    assert (k_used, failed) == (4, True)


def _spiked(n, true_rank, seed):
    lam = np.concatenate([np.linspace(1.0, 0.5, true_rank),
                          1e-12 * np.ones(n - true_rank)])
    return _psd(n, lam, seed)


# tests/test_psd_track.py's REVD2 battery (the reference's test_revd2.cc):
# (n, true rank, seed, k0, tol, k_max)
BATTERY = {"underestimation": (256, 64, 4, 8, 1e-8, 256),
           "partial budget": (256, 128, 5, 8, 1e-10, 32),
           "overestimation": (256, 16, 6, 64, 1e-6, 256),
           "rank revealed": (200, 12, 7, 32, 1e-6, 64),
           "exactness": (128, 8, 8, 8, 1e-12, 16)}


@pytest.mark.parametrize("case", list(BATTERY))
def test_revd2_battery_matches_jax(case):
    n, r, seed, k0, tol, k_max = BATTERY[case]
    A, st = _spiked(n, r, seed)
    V, lam, k_used, err, fail, nst = revd2(
        _t(A), k0, tol, REVD2Config(), _tstate(st), k_max=k_max,
        draw=_jax_draws(st))
    Vj, lj, kj, ej, fj, jst = j_revd2(jnp.asarray(A), k0, tol,
                                      JREVD2Config(), st, k_max=k_max)
    assert (k_used, fail) == (kj, fj)
    assert np.abs(_np(lam) - np.asarray(lj)).max() <= REL
    assert abs(err - ej) <= REL
    x, ref = _aligned(Vj, V, min(r, k_used))
    assert _abs(x, ref) <= ABS
    assert nst.counter == int(jst.counter)
    # the battery's own checks, on the port
    if case == "underestimation":
        assert k_used >= 64 and err < 1e-6
    elif case == "partial budget":
        assert k_used == 32 and err > 1e-10
    elif case == "overestimation":
        assert k_used == 64 and err < 1e-6
    elif case == "rank revealed":
        assert np.all(np.abs(_np(lam)[12:]) < 1e-8)
    else:
        Ah = (_np(V)[:, :8] * _np(lam)[:8]) @ _np(V)[:, :8].T
        assert np.linalg.norm(Ah - A) < 1e-10


@functools.cache
def _jax_nystrom():
    """The JAX package's ``nystrom_pc_data`` over the kernel operator:
    adaptive REVD2 from k 16, doubling to its tolerance."""
    jop, _, _, st = _operators("kernel")
    return j_nystrom_pc_data(jop, 16, st, 1e-2, tol=1e-6)


def test_nystrom_pc_data_matches_jax():
    # REVD2's adaptive doubling over the implicit kernel operator
    _, top, _, st = _operators("kernel")
    V, lam, k_used, nst = nystrom_pc_data(top, 16, _tstate(st), 1e-2,
                                          tol=1e-6, draw=_jax_draws(st))
    Vj, lj, kj, jst = _jax_nystrom()
    assert k_used == kj > 16
    lmax = float(np.asarray(lj)[0])
    assert np.abs(_np(lam) - np.asarray(lj)).max() <= REL * lmax
    x, ref = _aligned(Vj, V, 8)
    assert _abs(x, ref) <= ABS
    assert nst.counter == int(jst.counter)


def test_nystrom_pair_builds_the_same_spectral_precond():
    # a JAX REVD2's (V, λ) crosses through numpy and gives the port's
    # SpectralPrecond the same matmat as the JAX one
    Vj, lj, _, _ = _jax_nystrom()
    V, lam = interop.nystrom_from_numpy((Vj, lj), device="cpu")
    back = interop.nystrom_to_numpy(V, lam)
    assert np.array_equal(back[0], np.asarray(Vj))
    assert np.array_equal(back[1], np.asarray(lj))
    Pj = jl.SpectralPrecond.prep(Vj, lj, 1e-2)
    P = tl.SpectralPrecond.prep(V, lam, 1e-2)
    X = np.random.default_rng(1).standard_normal((Vj.shape[0], 3))
    out, ref = P.matmat(_t(X)), np.asarray(Pj.matmat(jnp.asarray(X), HI))
    assert np.abs(_np(out) - ref).max() <= 1e-12 * np.abs(ref).max()
