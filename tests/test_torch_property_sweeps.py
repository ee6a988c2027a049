"""The JAX package's seeded property sweeps (``tests/test_property_sweeps.py``)
on the port, on the CPU: each trial of the random-config, overcomplete,
``update_defer`` and distributed grids is a case of its own, drawn from the
same ``random.Random`` seed in the same order as the JAX test draws it, so
trial i here is trial i there. Every case holds the port to the JAX test's
gates (J a permutation; ``fail`` raised or the residual under the gate)
and runs the JAX function on the same input with its draws injected into
the port (``tests/_torch_pairs.py``): ``fail`` equal, and J and R by the
rank-aware rules of ROADMAP.md §3 (pivots up to the numerical rank, R's
rows on them; where the pivots part, only at a tie of |R_ii|, which
rounding decides).

The scale-equivariance sweeps run in f32 at 2^±60 and 1e±20–30 as the JAX
test does, with the JAX package's f32 draws. One case departs from the JAX
package on purpose: f32 CQRRPT at 2^-60 (``test_cqrrpt_f32_at_two_to_the_
minus_60``), where the JAX package returns ``fail`` with NaN factors and
the port a sound factorization (ROADMAP.md §3, "Constraints").

Held elsewhere on the port, not repeated: ``TestLSSweep`` (``tests/
test_torch_spls.py::test_spls_solver_grid_own_draws``), ``TestTransform
Composition`` (``tests/test_torch_autograd.py::test_vmapped_hqrrp``,
``test_vmapped_bqrrp_factored``, ``test_grad_through_hqrrp_r``) and SPLS's
half of ``test_abrik_spls_small_scale`` (``tests/test_torch_spls.py::
test_spls_scale_equivariant``).
"""
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu import drivers as jd
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen
from randlapack_tpu.linops import CompositeLinOp as JComposite
from randlapack_tpu.linops import DenseLinOp as JDense

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import drivers as td
from randlapack_tpu_torch import linops as tl
from randlapack_tpu_torch.parallel import run_ranks

import _torch_parallel_ranks as ranks
from _torch_pairs import (JaxRNG, abrik_draws, bqrrp_sketch, compare_pivoted,
                          hqrrp_sketch, qr_residual, tall_qr_draws, to_device)

EPS32 = float(np.finfo(np.float32).eps)
MTS = [MatType.polynomial, MatType.exponential, MatType.gaussian]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _parity(oj, ot, tol=1e-8):
    """``fail`` equal, J and R by the rank-aware rules (a tie allowed)."""
    assert bool(oj["fail"]) == bool(ot["fail"])
    if not bool(ot["fail"]):
        assert compare_pivoted(oj["R"], oj["J"], ot["R"], ot["J"],
                               tol=tol) in (None, "tie")


# -- TestQRSweep ---------------------------------------------------------------

def _qr_trials():
    """tests/test_property_sweeps.py::test_random_configs's ten trials."""
    rng = random.Random(0)
    trials = []
    for trial in range(10):
        m = rng.choice([33, 97, 128, 200])
        n = rng.choice([30, 64, 100, 190])
        b = rng.choice([8, 16, 32])
        mt = rng.choice(MTS)
        cond = 10 ** rng.choice([2, 5, 8])
        drv = rng.choice(["bqrrp", "factored", "hqrrp", "cqrrpt"])
        if drv == "cqrrpt" and m < n:
            drv = "hqrrp"
        stages = rng.choice([1, 2]) if drv == "bqrrp" else None
        trials.append(dict(trial=trial, m=m, n=n, b=b, mt=mt, cond=cond,
                           drv=drv, stages=stages))
    return trials


def _qr_pair(c, A, st):
    """The trial's driver in both packages; returns (jax, port) dicts."""
    keys = ("Q", "R", "J", "rank", "fail")
    b, drv, Aj, At = c["b"], c["drv"], jnp.asarray(A), _t(A)
    if drv == "bqrrp":
        kw = dict(block_size=b, stages=c["stages"])
        oj = jd.bqrrp(Aj, jd.BQRRPConfig(**kw), st)
        ot = td.bqrrp(At, td.BQRRPConfig(**kw), rt.RNGState(0),
                      sketch=_t(bqrrp_sketch(JaxRNG(st), A.shape, b)))
    elif drv == "factored":
        fj, _ = jd.bqrrp_factored(Aj, jd.BQRRPConfig(block_size=b), st)
        ft, _ = td.bqrrp_factored(
            At, td.BQRRPConfig(block_size=b), rt.RNGState(0),
            sketch=_t(bqrrp_sketch(JaxRNG(st), A.shape, b)))
        oj = (jd.bqrrp_q(fj), fj.R, fj.J, fj.rank, fj.fail)
        ot = (td.bqrrp_q(ft), ft.R, ft.J, ft.rank, ft.fail)
    elif drv == "hqrrp":
        oj = jd.hqrrp(Aj, jd.HQRRPConfig(block_size=b), st)
        ot = td.hqrrp(At, td.HQRRPConfig(block_size=b), rt.RNGState(0),
                      sketch=_t(hqrrp_sketch(JaxRNG(st), A.shape, b)))
    else:
        jcfg = jd.CQRRPTConfig()
        oj = jd.cqrrpt(Aj, jcfg, st)
        op, qs, noise = tall_qr_draws(
            JaxRNG(st), A.shape, jcfg.sketch, jcfg.d_factor, jcfg.vec_nnz,
            jcfg.qrcp, jcfg.bqrrp_block, jcfg.orthogonalization)
        ot = td.cqrrpt(At, td.CQRRPTConfig(), rt.RNGState(0), sketch=op,
                       qrcp_sketch=None if qs is None else _t(qs),
                       noise=None if noise is None else _t(noise))
    return (dict(zip(keys, (np.asarray(x) for x in oj[:5]))),
            dict(zip(keys, (x.numpy() if isinstance(x, torch.Tensor) else x
                            for x in ot[:5]))))


QR_TRIALS = _qr_trials()


@pytest.mark.parametrize("c", QR_TRIALS,
                         ids=[f"t{c['trial']}-{c['drv']}-{c['m']}x{c['n']}"
                              f"-b{c['b']}" for c in QR_TRIALS])
def test_random_configs(c):
    A, st = mat_gen(MatGenInfo(c["m"], c["n"], c["mt"], cond_num=c["cond"]),
                    JRNG(c["trial"]))
    A = np.asarray(A)
    oj, ot = _qr_pair(c, A, st)
    res, perm = qr_residual(A, ot["Q"], ot["R"], ot["J"])
    assert perm, c
    assert bool(ot["fail"]) or res < 1e-10, (c, res)
    _parity(oj, ot)


@pytest.mark.parametrize("q", [12, 30])
def test_abrik_overcomplete_configs(q):
    """q·b past the numerical rank degrades gracefully (the
    Krylov-exhaustion freeze): the leading σ of A1·A2 within 1e-9."""
    A1, _ = mat_gen(MatGenInfo(150, 60, MatType.gaussian), JRNG(10))
    A2, _ = mat_gen(MatGenInfo(60, 100, MatType.gaussian), JRNG(110))
    A1, A2 = np.asarray(A1), np.asarray(A2)
    s_ref = np.linalg.svd(A1 @ A2, compute_uv=False)[:4]
    cfg = dict(block_size=8, max_iters=q)
    v0, sk = abrik_draws(JaxRNG(JRNG(10)), (150, 100), 8, q)
    _, S, _, _, _ = td.abrik(tl.CompositeLinOp(tl.DenseLinOp(_t(A1)),
                                               tl.DenseLinOp(_t(A2))),
                             4, td.ABRIKConfig(**cfg), rt.RNGState(10),
                             v0=_t(v0), qr_sketches=sk)
    np.testing.assert_allclose(S.numpy(), s_ref, rtol=1e-9)
    _, Sj, _, _, _ = jd.abrik(JComposite(JDense(jnp.asarray(A1)),
                                         JDense(jnp.asarray(A2))),
                              4, jd.ABRIKConfig(**cfg), JRNG(10))
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=1e-12)


# -- TestDeferSweep ------------------------------------------------------------

def _defer_trials():
    """test_defer_pivot_route_grid's ten trials. Its monkeypatched
    Householder pivot route is left out: that route exists because XLA's
    TPU LU is f32-only, and the port has no such route (cuSOLVER and
    LAPACK take f64), so each trial runs the LU route in both packages;
    the draw that picked the route is still made, so the trials match."""
    rng = random.Random(3)
    trials = []
    for trial in range(10):
        m = rng.choice([65, 128, 200, 256])
        n = rng.choice([48, 96, 130, 192])
        b = rng.choice([16, 32, 48])
        defer = rng.choice([1, 2, 3, 4, 5])
        rng.random()                      # the JAX test's route draw
        mt = rng.choice(MTS)
        cond = 10 ** rng.choice([2, 6])
        kw = dict(block_size=b, update_defer=defer,
                  stages=rng.choice([1, 2]),
                  pivot_candidates=rng.choice([None, 2, 4]),
                  sketch_r=rng.choice(["auto", "qr", "gram"]))
        trials.append(dict(trial=trial, m=m, n=n, mt=mt, cond=cond, kw=kw))
    return trials


DEFER_TRIALS = _defer_trials()


@pytest.mark.parametrize("c", DEFER_TRIALS,
                         ids=[f"t{c['trial']}-{c['m']}x{c['n']}-b"
                              f"{c['kw']['block_size']}-defer"
                              f"{c['kw']['update_defer']}"
                              for c in DEFER_TRIALS])
def test_defer_grid(c):
    A, st = mat_gen(MatGenInfo(c["m"], c["n"], c["mt"], cond_num=c["cond"]),
                    JRNG(100 + c["trial"]))
    A = np.asarray(A)
    fj, _ = jd.bqrrp_factored(jnp.asarray(A), jd.BQRRPConfig(**c["kw"]), st)
    ft, _ = td.bqrrp_factored(
        _t(A), td.BQRRPConfig(**c["kw"]), rt.RNGState(0),
        sketch=_t(bqrrp_sketch(JaxRNG(st), A.shape, c["kw"]["block_size"])))
    res, perm = qr_residual(A, td.bqrrp_q(ft), ft.R, ft.J)
    assert perm, c
    assert bool(ft.fail) or res < 1e-10, (c, res)
    _parity(dict(R=np.asarray(fj.R), J=np.asarray(fj.J), fail=fj.fail),
            dict(R=ft.R.numpy(), J=ft.J.numpy(), fail=ft.fail))


# -- TestDistSweep -------------------------------------------------------------

def _dist_trials():
    """test_dist_driver_grid's six trials. The JAX test runs them on 2, 4
    or 8 of its 8 virtual devices; here one spawn of 4 gloo ranks runs
    each on a subgroup of its p ranks, with the JAX test's p = 8 run at
    p = 4 (and m sized for that p) in both packages."""
    rng = random.Random(5)
    trials = []
    for trial in range(6):
        p = min(rng.choice([2, 4, 8]), 4)
        m = rng.choice([16, 24, 32]) * p
        n = rng.choice([32, 48, 64])
        cond = 10 ** rng.choice([2, 5])
        drv = rng.choice(["bqrrp", "factored", "cqrrpt", "abrik"])
        trials.append(dict(trial=trial, p=p, m=m, n=n, cond=cond, drv=drv))
    return trials


DIST_TRIALS = _dist_trials()


@pytest.fixture(scope="module")
def dist_runs():
    """JAX's side first (its device threads meet in every collective),
    then the port's in one spawn of 4 gloo ranks."""
    from jax.sharding import Mesh
    from randlapack_tpu.parallel import (dist_abrik, dist_bqrrp,
                                         dist_bqrrp_factored, dist_cqrrpt)
    jx, cases = [], []
    for c in DIST_TRIALS:
        A, st = mat_gen(MatGenInfo(c["m"], c["n"], MatType.exponential,
                                   cond_num=c["cond"]),
                        JRNG(200 + c["trial"]))
        A = np.asarray(A)
        mesh = Mesh(np.array(jax.devices()[:c["p"]]).reshape(c["p"]),
                    ("rows",))
        case = dict(p=c["p"], A=A, seed=200 + c["trial"], drv=c["drv"])
        if c["drv"] == "abrik":
            U, S, _, _, _ = dist_abrik(jnp.asarray(A), 8, mesh, st,
                                       block_size=8, max_iters=4)
            jx.append(dict(U=np.asarray(U), S=np.asarray(S)))
            case["v0"], case["sk"] = abrik_draws(JaxRNG(st), A.shape, 8, 4,
                                                 "cqrrt")
        else:
            if c["drv"] == "bqrrp":
                res = dist_bqrrp(jnp.asarray(A), mesh, st, block_size=16)
                case["S"] = bqrrp_sketch(JaxRNG(st), A.shape, 16)
            elif c["drv"] == "factored":
                fac, _ = dist_bqrrp_factored(jnp.asarray(A), mesh, st,
                                             block_size=16)
                res = (None, fac.R, fac.J, fac.rank, fac.fail)
                case["S"] = bqrrp_sketch(JaxRNG(st), A.shape, 16)
            else:
                res = dist_cqrrpt(jnp.asarray(A), mesh, st)
                d = int(1.25 * c["n"])
                key, _ = st.spawn()
                case["S"] = np.asarray(jax.random.normal(
                    key, (d, c["m"]), dtype=jnp.float64)) / math.sqrt(d)
            jx.append(dict(zip(("Q", "R", "J", "rank", "fail"),
                               (None if x is None else np.asarray(x)
                                for x in res[:5]))))
        cases.append(case)
    port = run_ranks(ranks.sweep_body, 4, cases, backend="gloo",
                     device="cpu", timeout=600)
    return cases, jx, port


@pytest.mark.parametrize("i", range(len(DIST_TRIALS)),
                         ids=[f"t{c['trial']}-{c['drv']}-p{c['p']}"
                              for c in DIST_TRIALS])
def test_dist_driver_grid(dist_runs, i):
    cases, jx, port = dist_runs
    c, oj = cases[i], jx[i]
    ranks_out = [port[r][i] for r in range(c["p"])]
    assert all(port[r][i] is None for r in range(c["p"], 4))
    A = c["A"]
    if c["drv"] == "abrik":
        U = np.concatenate([r["U"] for r in ranks_out])
        S = ranks_out[0]["S"]
        sv = np.linalg.svd(A, compute_uv=False)
        np.testing.assert_allclose(S[:2], sv[:2], rtol=1e-3)
        assert np.linalg.norm(U.T @ U - np.eye(8)) < 1e-10
        np.testing.assert_allclose(S, oj["S"], rtol=1e-8)
        return
    Q = np.concatenate([r["Q"] for r in ranks_out])
    ot = {k: ranks_out[0][k] for k in ("R", "J", "rank", "fail")}
    for r in ranks_out[1:]:                  # replicated on every rank
        assert np.array_equal(r["R"], ot["R"])
        assert np.array_equal(r["J"], ot["J"])
    res, perm = qr_residual(A, Q, ot["R"], ot["J"])
    assert perm and (bool(ot["fail"]) or res < 1e-9), (c["drv"], res)
    _parity(oj, ot)


# -- TestScaleInvariance -------------------------------------------------------

def _scale_input():
    A64, st = mat_gen(MatGenInfo(96, 64, MatType.exponential, cond_num=1e3),
                      JRNG(900))
    return np.asarray(A64).astype(np.float32), st


@pytest.mark.parametrize("scale", [2.0 ** -60, 2.0 ** 60],
                         ids=["2^-60", "2^60"])
def test_bqrrp_factored_scale_equivariant(scale):
    """Powers of 2 commute with f32 arithmetic given the band guards: J
    exactly, R linear in the scale, Q unchanged."""
    A, st = _scale_input()
    cfg = td.BQRRPConfig(block_size=16)
    S = _t(bqrrp_sketch(JaxRNG(st, "float32"), A.shape, 16))
    fac0, _ = td.bqrrp_factored(_t(A), cfg, rt.RNGState(0), sketch=S)
    fac, _ = td.bqrrp_factored(_t(A) * scale, cfg, rt.RNGState(0),
                               sketch=S)
    np.testing.assert_array_equal(fac.J.numpy(), fac0.J.numpy())
    R0 = fac0.R.double().numpy()
    np.testing.assert_allclose(fac.R.double().numpy() / scale, R0,
                               rtol=2e-5, atol=2e-5 * np.abs(R0).max())
    np.testing.assert_allclose(td.bqrrp_q(fac).numpy(),
                               td.bqrrp_q(fac0).numpy(), atol=5e-5)
    fj, _ = jd.bqrrp_factored(jnp.asarray(A) * jnp.float32(scale),
                              jd.BQRRPConfig(block_size=16), st)
    assert bool(fj.fail) == bool(fac.fail)
    np.testing.assert_array_equal(np.asarray(fj.J), fac.J.numpy())


def _cqrrpt_f32(At, st, scale):
    jcfg = jd.CQRRPTConfig()
    op, qs, noise = tall_qr_draws(
        JaxRNG(st, "float32"), At.shape, jcfg.sketch, jcfg.d_factor,
        jcfg.vec_nnz, jcfg.qrcp, jcfg.bqrrp_block, jcfg.orthogonalization)
    out = td.cqrrpt(_t(At) * scale, td.CQRRPTConfig(), rt.RNGState(0),
                    sketch=to_device(op, "cpu", torch.float32))
    oj = jd.cqrrpt(jnp.asarray(At) * jnp.float32(scale), jcfg, st)
    return out, oj


def test_cqrrpt_scale_equivariant_2_to_the_50():
    A, st = _scale_input()
    At = np.concatenate([A, A], axis=0)   # taller for cqrrpt
    (Q0, R0, J0, r0, f0, _), _ = _cqrrpt_f32(At, st, 1.0)
    (Qs, Rs, Js, rs, fs, _), oj = _cqrrpt_f32(At, st, 2.0 ** 50)
    np.testing.assert_array_equal(Js.numpy(), J0.numpy())
    R0 = R0.double().numpy()
    np.testing.assert_allclose(Rs.double().numpy() / 2.0 ** 50, R0,
                               rtol=2e-5, atol=2e-5 * np.abs(R0).max())
    assert bool(oj[4]) == bool(fs) is False


def test_cqrrpt_f32_at_two_to_the_minus_60():
    """The fuzz's probe: f32 CQRRPT of the same 192×64 matrix at 2^-60.
    The port is sound here (the JAX test's f32 gates: residual ≤
    10·eps32^0.75, orthogonality ≤ 10·eps32^0.75·√k); the JAX package
    returns ``fail`` with NaN R on the same input and draws. That is a
    recorded departure (ROADMAP.md §3): the port is not made to match."""
    A, st = _scale_input()
    At = np.concatenate([A, A], axis=0)
    (Q, R, J, rank, fail, _), oj = _cqrrpt_f32(At, st, 2.0 ** -60)
    k = int(rank)
    res, perm = qr_residual(At.astype(np.float64) * 2.0 ** -60,
                            Q[:, :k].double(), R[:k].double(), J)
    orth = float(np.linalg.norm(Q[:, :k].double().T @ Q[:, :k].double()
                                - np.eye(k)))
    assert not bool(fail) and perm and k == 64
    assert res <= 10 * EPS32 ** 0.75 and orth <= 10 * EPS32 ** 0.75 * 8
    assert bool(oj[4]) and not np.isfinite(np.asarray(oj[1])).all()


@pytest.mark.parametrize("scale", [1e-20, 1e20, 1e30])
def test_cholqr_scale_equivariant_f32(scale):
    A = np.asarray(mat_gen(MatGenInfo(128, 16, MatType.gaussian),
                           JRNG(901))[0]).astype(np.float32)
    from randlapack_tpu_torch.ops.cholqr import cholqr
    Q0, R0, f0 = cholqr(_t(A))
    Q, R, f = cholqr(_t(A) * np.float32(scale))
    assert not bool(f)
    np.testing.assert_allclose(Q.numpy(), Q0.numpy(), atol=1e-5)


def test_abrik_small_scale():
    """ABRIK's relative floors: a 2^-60-scaled input gives the O(1) one's
    σ times the scale (the port, JAX's draws injected into both calls)."""
    s = 2.0 ** -60
    A, _ = mat_gen(MatGenInfo(150, 60, MatType.exponential, cond_num=1e4),
                   JRNG(902))
    A = np.asarray(A)
    cfg = td.ABRIKConfig(block_size=8, max_iters=8)
    v0, _ = abrik_draws(JaxRNG(JRNG(903)), A.shape, 8, 8)
    _, S0, _, _, _ = td.abrik(_t(A), 8, cfg, rt.RNGState(903), v0=_t(v0))
    _, S1, _, _, _ = td.abrik(_t(A) * s, 8, cfg, rt.RNGState(903),
                              v0=_t(v0))
    np.testing.assert_allclose(S1.numpy() / s, S0.numpy(), rtol=1e-12)
    _, Sj, _, _, _ = jd.abrik(jnp.asarray(A), 8,
                              jd.ABRIKConfig(block_size=8, max_iters=8),
                              JRNG(903))
    np.testing.assert_allclose(S0.numpy(), np.asarray(Sj), rtol=1e-10)


def _cqrrt_f32(A, scale, **kw):
    jcfg = jd.CQRRTConfig(**kw)
    op, _, _ = tall_qr_draws(JaxRNG(JRNG(907), "float32"), A.shape,
                             jcfg.sketch, jcfg.d_factor, jcfg.vec_nnz)
    return td.cqrrt(_t(A) * np.float32(scale), td.CQRRTConfig(**kw),
                    rt.RNGState(907),
                    sketch=to_device(op, "cpu", torch.float32))


@pytest.mark.parametrize("scale", [2.0 ** -60, 2.0 ** 55, "qless"],
                         ids=["2^-60", "2^55", "qless_2^-60"])
def test_cqrrt_scale_equivariant(scale):
    A64, _ = mat_gen(MatGenInfo(256, 48, MatType.exponential, cond_num=1e4),
                     JRNG(906))
    A = np.asarray(A64).astype(np.float32)
    Q0, R0, f0, _ = _cqrrt_f32(A, 1.0)
    R0 = R0.double().numpy()
    if scale == "qless":
        _, Rq, fq, _ = _cqrrt_f32(A, 2.0 ** -60, compute_q=False)
        assert not bool(fq)
        np.testing.assert_allclose(Rq.double().numpy() / 2.0 ** -60, R0,
                                   rtol=2e-4, atol=2e-4 * np.abs(R0).max())
        return
    Q1, R1, f1, _ = _cqrrt_f32(A, scale)
    assert not bool(f1)
    np.testing.assert_allclose(Q1.numpy(), Q0.numpy(), atol=1e-5)
    np.testing.assert_allclose(R1.double().numpy() / scale, R0, rtol=2e-5,
                               atol=2e-5 * np.abs(R0).max())
