"""The driver-level ``precision=`` on the CPU in f64: every JAX name maps
(``config.resolve_precision``), and every driver in "high" and "default"
is ``torch.equal`` to its own "highest" run (on the CPU, and in f64 on
any device, ``ops.util.matmul`` is the plain product, as XLA's CPU dot
ignores ``precision``) and agrees with the JAX function called with the
same precision on the same JAX-drawn random draws, at that driver's
parity tolerance (the tests named beside each case). The draw helpers
are the parity tests' own."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_abrik as pabrik
import test_torch_cqrrpt as pcq
import test_torch_krill as pkrill
import test_torch_revd2 as prevd2
import test_torch_spls as pspls
from randlapack_tpu import RNGState as JRNG
from randlapack_tpu import drivers as jd
from randlapack_tpu.comps import QBConfig as JQBConfig
from randlapack_tpu.comps import PCGConfig as JPCGConfig
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import config, drivers as td
from randlapack_tpu_torch.comps import PCGConfig, QBConfig
from randlapack_tpu_torch.linops import DenseLinOp

MODES = ["high", "default"]


def _mat(m, n, seed, kind=MatType.polynomial, **kw):
    A, st = mat_gen(MatGenInfo(m, n, kind, **kw), JRNG(seed))
    return np.asarray(A), st


def _normal(key, shape, scale=1.0):
    return torch.tensor(np.asarray(jax.random.normal(
        key, shape, dtype=jnp.float64)) * scale)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _signed(ref, x):
    """x's columns with the signs that align them with ref's."""
    ref, x = np.asarray(ref), np.asarray(x)
    s = np.sign(np.sum(ref * x, axis=0))
    return x * np.where(s == 0, 1.0, s)


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _leaves(o)]
    if hasattr(out, "_fields"):
        return _leaves(tuple(out))
    if hasattr(out, "__dataclass_fields__"):
        return _leaves([getattr(out, f) for f in out.__dataclass_fields__])
    return []


# each case: precision → (port output, a check of it against JAX's at
# that precision); the tolerance is the named parity test's

def _bqrrp_factored(p):      # test_torch_bqrrp.py
    A, _ = _mat(96, 80, 1, cond_num=1e4)
    d = int(1.25 * 16)
    S = _normal(JRNG(5).spawn()[0], (d, 96), 1 / math.sqrt(d))
    out = td.bqrrp_factored(torch.tensor(A), td.BQRRPConfig(block_size=16),
                            rt.RNGState(5), p, sketch=S)
    fj, _ = jd.bqrrp_factored(jnp.asarray(A), jd.BQRRPConfig(block_size=16),
                              JRNG(5), p)

    def check(out):
        assert np.array_equal(out[0].J.numpy(), np.asarray(fj.J))
        assert _rel(out[0].R, fj.R) <= 1e-10
    return out, check


def _bqrrp_explicit(p):      # test_torch_bqrrp_explicit.py
    A, _ = _mat(96, 80, 2, cond_num=1e4)
    d = int(1.25 * 16)
    S = _normal(JRNG(3).spawn()[0], (d, 96), 1 / math.sqrt(d))
    out = td.bqrrp(torch.tensor(A), td.BQRRPConfig(block_size=16),
                   rt.RNGState(3), p, sketch=S)
    oj = jd.bqrrp(jnp.asarray(A), jd.BQRRPConfig(block_size=16), JRNG(3), p)

    def check(out):
        assert np.array_equal(out[2].numpy(), np.asarray(oj[2]))
        assert _rel(out[1], oj[1]) <= 1e-10
    return out, check


def _hqrrp(p):               # test_torch_hqrrp.py
    A, _ = _mat(64, 48, 3, cond_num=1e4)
    cfg = td.HQRRPConfig(block_size=16)
    G = torch.tensor(np.asarray(jax.random.uniform(
        JRNG(4).spawn()[0], (16 + cfg.oversample, 64), dtype=jnp.float64,
        minval=-1.0, maxval=1.0)))
    out = td.hqrrp(torch.tensor(A), cfg, rt.RNGState(4), p, sketch=G)
    oj = jd.hqrrp(jnp.asarray(A), jd.HQRRPConfig(block_size=16), JRNG(4), p)

    def check(out):
        assert np.array_equal(out[2].numpy(), np.asarray(oj[2]))
        assert _rel(out[1], oj[1]) <= 1e-10
    return out, check


def _cqrrpt(p):              # test_torch_cqrrpt.py
    A, st = _mat(400, 40, 4, cond_num=1e6)
    op, _, _ = pcq._draws(A, jd.CQRRPTConfig(), st)
    out = td.cqrrpt(torch.tensor(A), td.CQRRPTConfig(), rt.RNGState(1), p,
                    sketch=op)
    oj = jd.cqrrpt(jnp.asarray(A), jd.CQRRPTConfig(), st, p)

    def check(out):
        assert np.array_equal(out[2].numpy(), np.asarray(oj[2]))
        assert _rel(out[1], oj[1]) <= pcq.TOL
    return out, check


def _cqrrt(p):               # test_torch_cqrrpt.py
    A, st = _mat(400, 40, 5, cond_num=1e6)
    op, _, _ = pcq._draws(A, jd.CQRRTConfig(), st)
    out = td.cqrrt(torch.tensor(A), td.CQRRTConfig(), rt.RNGState(1), p,
                   sketch=op)
    oj = jd.cqrrt(jnp.asarray(A), jd.CQRRTConfig(), st, p)

    def check(out):
        assert _rel(out[1], oj[1]) <= pcq.TOL
        assert np.abs(out[0].numpy() - np.asarray(oj[0])).max() <= pcq.TOL
    return out, check


def _rsvd(p):                # test_torch_lowrank.py
    A, _ = _mat(120, 90, 6, MatType.exponential, cond_num=1e4)
    st = JRNG(7)
    om = [_normal(st.branch(i).spawn()[0], (90, 16)) for i in range(2)]
    cfg = td.RSVDConfig(QBConfig(block_size=16))
    out = td.rsvd_fixed_rank(torch.tensor(A), 32, cfg, rt.RNGState(7), p,
                             omegas=om)
    oj = jd.rsvd_fixed_rank(jnp.asarray(A), 32,
                            jd.RSVDConfig(JQBConfig(block_size=16)), st, p)

    def check(out):
        assert _rel(out[1], oj[1]) <= 1e-12
        assert np.abs(_signed(oj[0], out[0]) - np.asarray(oj[0])).max() \
            <= 1e-10
    return out, check


def _revd2(p):               # test_torch_revd2.py
    jop, top, _, st = prevd2._operators("explicit")
    draw = prevd2._jax_draws(st)
    n = top.dim
    out = td.revd2_fixed_rank(top, 12, td.REVD2Config(), prevd2._tstate(st),
                              p, omega=draw((n, 12), 12),
                              v0=draw((n, 1), 12))
    oj = jd.revd2_fixed_rank(jop, 12, jd.REVD2Config(), st, p)

    def check(out):
        assert _rel(out[1], oj[1]) <= 1e-12
        assert np.abs(_signed(oj[0], out[0]) - np.asarray(oj[0])).max() \
            <= 1e-10
    return out, check


def _abrik(p):               # test_torch_abrik.py
    A = pabrik._matrix(96, 60, cond_num=1e4)
    kw = dict(block_size=6, max_iters=4, qr_explicit="cqrrt")
    st = JRNG(4)
    v0, sk = pabrik._abrik_draws(st, 96, 60, jd.ABRIKConfig(**kw))
    out = td.abrik(torch.tensor(A), 10, td.ABRIKConfig(**kw),
                   pabrik._tstate(st), precision=p, v0=v0, qr_sketches=sk)
    oj = jd.abrik(jnp.asarray(A), 10, jd.ABRIKConfig(**kw), st, precision=p)

    def check(out):
        assert np.abs(out[1].numpy() - np.asarray(oj[1])).max() \
            <= 1e-10 * float(oj[1][0])
    return out, check


def _cholqr_linops(p):       # test_torch_abrik.py
    A = pabrik._matrix(96, 40, cond_num=1e3)
    out = td.cholqr_linops(DenseLinOp(torch.tensor(A)),
                           td.CholQRLinopsConfig(16, 2), p)
    oj = jd.cholqr_linops(pabrik.JDense(jnp.asarray(A)),
                          jd.CholQRLinopsConfig(16, 2), p)

    def check(out):
        assert _rel(out[0], oj[0]) <= 1e-10
    return out, check


def _krill(p):               # test_torch_krill.py
    X, H = pkrill._data(300, 4, 2, 6)
    mus = [1e-2, 1e-3]
    Gj, Gt = pkrill._operators("explicit", X, mus)
    pcg = dict(tol=1e-8, max_iters=400)
    out = td.krill_full_rpchol(
        Gt, torch.tensor(H), torch.tensor(mus),
        td.KrillConfig(k=128, rpchol_block=32, pcg=PCGConfig(**pcg)),
        rt.RNGState(14), p, noise=pkrill._gumbel_noise(JRNG(14), 4, 300))
    oj = jd.krill_full_rpchol(
        Gj, jnp.asarray(H), jnp.asarray(mus),
        jd.KrillConfig(k=128, rpchol_block=32, pcg=JPCGConfig(**pcg)),
        JRNG(14), p)

    def check(out):
        assert abs(out[2] - int(oj[2])) <= 1
        assert _rel(out[0], oj[0]) <= 1e-6
    return out, check


def _spls(p):                # test_torch_spls.py
    A, b = _spls_problem()
    cfg = td.SPLSConfig(solver="pcg")
    S = pspls._sketch(600, 30, cfg.d_factor, cfg.vec_nnz, 1)
    out = td.spls(torch.tensor(A), torch.tensor(b), 0.0, cfg,
                  rt.RNGState(1), p, sketch=S)
    oj = jd.spls(jnp.asarray(A), jnp.asarray(b), 0.0,
                 jd.SPLSConfig(solver="pcg"), JRNG(1), p)

    def check(out):
        assert abs(out[2] - int(oj[2])) <= 1
        assert _rel(out[0], oj[0]) <= 1e-9
    return out, check


def _spls_problem():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((600, 30)) * np.logspace(0, -2, 30)
    return A, rng.standard_normal(600)


CASES = {"bqrrp_factored": _bqrrp_factored, "bqrrp": _bqrrp_explicit,
         "hqrrp": _hqrrp, "cqrrpt": _cqrrpt, "cqrrt": _cqrrt,
         "rsvd": _rsvd, "revd2": _revd2, "abrik": _abrik,
         "cholqr_linops": _cholqr_linops, "krill": _krill, "spls": _spls}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("driver", list(CASES))
def test_driver_precision_is_highest_on_the_cpu_and_matches_jax(driver,
                                                                mode):
    out, check = CASES[driver](mode)
    ref, _ = CASES[driver]("highest")
    a, b = _leaves(out), _leaves(ref)
    assert a and len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    check(out)


def test_resolve_precision_maps_every_jax_name():
    for names, want in ((("highest", "float32", None,
                          jax.lax.Precision.HIGHEST), "highest"),
                        (("high", "tensorfloat32",
                          jax.lax.Precision.HIGH), "high"),
                        (("default", "bfloat16", "fastest",
                          jax.lax.Precision.DEFAULT), "default")):
        for name in names:
            assert config.resolve_precision(name) == want, name
    for bad in ("medium", "fp16", 3):
        with pytest.raises(ValueError):
            config.resolve_precision(bad)
    with pytest.raises(ValueError):
        jax.lax.Precision("medium")
