"""The port's QRCP pieces (randlapack_tpu_torch.ops.qr / .qrcp) against the
JAX package on the CPU: the plain versions of K5 (``qrcp_select_pivots``)
and K6 (``qrcp_panel``) against the JAX jnp loops and against the JAX
Pallas kernels run in interpret mode, plus ``wy_T``, ``_larfg`` and
``geqp3`` (the kernels themselves are held against these plain versions
on the card by tests/test_torch_cuda.py).

Gates: pivot orders (J, sigma) exactly equal; f64 factors within 1e-10
relative (summation order differs between MKL and XLA's CPU dot); f32
panels within the JAX kernel test's own gates (W 1e-4, V and taus 1e-5,
tests/test_pallas_kernels.py:139-141). The sketches scale their columns
by exp(-3·U), as the JAX test does, so no two column norms sit within
rounding of each other."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu.ops import pallas_qrcp as jpq

from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.ops import qrcp as tqrcp

jqr = importlib.import_module("randlapack_tpu.ops.qr")
tqr = importlib.import_module("randlapack_tpu_torch.ops.qr")

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _abs(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _sketch(d, n, seed, npdt):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((d, n)) * np.exp(-3 * rng.random(n))[None, :]
    live = np.ones(n)
    live[:7] = 0.0
    return Y.astype(npdt), live.astype(npdt)


# -- K5's plain version ------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d,n,b", [(74, 512, 64), (26, 256, 16)])
def test_select_pivots_match_jax_and_pallas(dtype, d, n, b):
    npdt, tdt = DTYPES[dtype]
    Y, live = _sketch(d, n, d + n, npdt)
    ref = np.asarray(jqr.qrcp_select_pivots(jnp.asarray(Y), b,
                                            jnp.asarray(live)))
    pal = np.asarray(jpq.qrcp_select_pivots_pallas(
        jnp.asarray(Y), b, jnp.asarray(live), interpret=True))
    out = tqr.qrcp_select_pivots(torch.tensor(Y), b, torch.tensor(live))
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), pal)
    # retired (live = 0) columns are never chosen
    assert not set(out.tolist()) & set(range(7))


def test_select_pivots_routed_on_the_cpu_takes_the_plain_version():
    Y, live = _sketch(40, 256, 1, np.float64)
    Yt, lt = torch.tensor(Y), torch.tensor(live)
    n0 = dict(tqrcp.LAUNCHES)
    ref = tqr.qrcp_select_pivots(Yt, 32, lt)
    for route in ("auto", "never"):
        assert torch.equal(tqrcp.qrcp_select_pivots_routed(
            Yt, 32, lt, use_pallas=route), ref)
    assert tqrcp.LAUNCHES == n0
    with pytest.raises(RandLAPACKError):
        tqrcp.qrcp_select_pivots_routed(Yt, 32, lt, use_pallas="always")
    # "default" runs the plain version on the CPU, as "highest" does
    assert torch.equal(tqrcp.qrcp_select_pivots_routed(
        Yt, 32, lt, precision="default"), ref)
    with pytest.raises(ValueError):
        tqrcp.qrcp_select_pivots_routed(Yt, 32, lt, precision="medium")
    # the kernel wrapper takes only CUDA tensors
    with pytest.raises(RandLAPACKError):
        tqrcp.qrcp_select_pivots_cuda(Yt, 32, lt)


def test_select_pivots_more_steps_than_live_columns():
    """Past the live columns the masked maximum is −1 everywhere, and the
    first index wins (argmax semantics), as in the JAX loop."""
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((12, 10))
    live = np.zeros(10)
    live[[2, 5, 7]] = 1.0
    ref = np.asarray(jqr.qrcp_select_pivots(jnp.asarray(Y), 6,
                                            jnp.asarray(live)))
    out = tqr.qrcp_select_pivots(torch.tensor(Y), 6, torch.tensor(live))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert set(out[:3].tolist()) == {2, 5, 7}


# -- K6's plain version ------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("m,b,r0", [(512, 64, 0), (512, 64, 128)])
def test_panel_matches_jax_and_pallas(dtype, pivot, m, b, r0):
    npdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(m + b + r0)
    P = rng.standard_normal((m, b)).astype(npdt)
    Wt, Vt, tt, st = tqr.qrcp_panel(torch.tensor(P), r0, pivot)
    assert st.dtype == torch.int64
    refs = [jqr.qrcp_panel(jnp.asarray(P), r0, pivot),
            jpq.qrcp_panel_routed(jnp.asarray(P), r0, pivot,
                                  use_pallas="auto", interpret=True)]
    for Wj, Vj, tj, sj in refs:
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        if tdt == torch.float32:
            assert _abs(Wt, Wj) < 1e-4
            assert _abs(Vt, Vj) < 1e-5 and _abs(tt, tj) < 1e-5
        else:
            assert _rel(Wt, Wj) < 1e-10 and _rel(Vt, Vj) < 1e-10
            assert _rel(tt, tj) < 1e-10
    if not pivot:
        assert torch.equal(st, torch.arange(b))


def test_panel_is_a_factorization():
    """The packed panel is an exact QR of the pivoted panel's rows ≥ row0:
    Q from (V, taus) times R reproduces them; rows < row0 only move."""
    rng = np.random.default_rng(9)
    m, b, r0 = 300, 40, 100
    P = torch.tensor(rng.standard_normal((m, b)))
    W, V, taus, sigma = tqr.qrcp_panel(P, r0, True)
    Ps = P[:, sigma]
    assert torch.equal(W[:r0], Ps[:r0])
    Q = torch.linalg.householder_product(V[r0:], taus)
    R = torch.triu(W[r0:r0 + b])
    assert float((Q @ R - Ps[r0:]).abs().max()) < 1e-12
    # greedy pivoting: |R| diagonal non-increasing
    dg = R.diagonal().abs()
    assert bool((dg[1:] <= dg[:-1] * (1 + 1e-12)).all())


def test_panel_routed_on_the_cpu_takes_the_plain_version():
    P = torch.tensor(np.random.default_rng(4).standard_normal((96, 16)))
    n0 = dict(tqrcp.LAUNCHES)
    ref = tqr.qrcp_panel(P, 32, True)
    for route in ("auto", "never"):
        out = tqrcp.qrcp_panel_routed(P, 32, True, use_pallas=route)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    assert tqrcp.LAUNCHES == n0
    with pytest.raises(RandLAPACKError):
        tqrcp.qrcp_panel_cuda(P, 32)


# -- the rest of ops/qr.py ---------------------------------------------------

@pytest.mark.parametrize("case", ["gauss", "zero", "head_only", "neg"])
def test_larfg_edge_cases(case):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(9)
    if case == "zero":
        x[:] = 0.0               # normx = 0: tau = 0, alpha = x_i
    elif case == "head_only":
        x[4:] = 0.0
        x[3] = 2.5               # tail zero: tau = 2, alpha = -x_i
    elif case == "neg":
        x[3] = -1.5
    vj, tj, aj = jqr._larfg(jnp.asarray(x), 3)
    vt, tt, at = tqr._larfg(torch.tensor(x), 3)
    assert _abs(vt, vj) < 1e-14 and abs(float(tt) - float(tj)) < 1e-14
    assert abs(float(at) - float(aj)) < 1e-14
    if case == "zero":
        assert float(tt) == 0.0 and float(at) == 0.0
    if case == "head_only":
        assert float(tt) == 2.0 and float(at) == -2.5
    # H·x = alpha·e_i on rows ≥ i
    xt = torch.tensor(x)
    Hx = xt - tt * vt * (vt @ torch.where(torch.arange(9) >= 3, xt, 0.0))
    assert abs(float(Hx[3] - at)) < 1e-13
    assert float(Hx[4:].abs().max()) < 1e-13


def test_wy_T_matches_jax_and_reproduces_the_product():
    rng = np.random.default_rng(6)
    m, b = 80, 12
    W, V, taus, _ = tqr.qrcp_panel(torch.tensor(rng.standard_normal((m, b))),
                                   10, True)
    taus[5] = 0.0                 # an identity reflector
    Tj, Vzj = jqr.wy_T(jnp.asarray(V.numpy()), jnp.asarray(taus.numpy()))
    Tt, Vzt = tqr.wy_T(V, taus)
    assert _rel(Tt, Tj) < 1e-12 and _rel(Vzt, Vzj) < 1e-14
    assert float(Vzt[:, 5].abs().max()) == 0.0
    H = torch.eye(m, dtype=V.dtype)
    for l in range(b):
        v = Vzt[:, l]
        H = H @ (torch.eye(m, dtype=V.dtype) - taus[l] * torch.outer(v, v))
    assert float((H - (torch.eye(m, dtype=V.dtype)
                       - Vzt @ Tt @ Vzt.T)).abs().max()) < 1e-13


@pytest.mark.parametrize("shape,k,pivot", [((60, 40), None, True),
                                           ((40, 60), None, True),
                                           ((50, 30), 12, True),
                                           ((50, 30), None, False)])
def test_geqp3_matches_jax(shape, k, pivot):
    rng = np.random.default_rng(shape[0] + shape[1])
    A = rng.standard_normal(shape) * np.exp(-3 * rng.random(shape[1]))
    Qj, Rj, Jj = jqr.geqp3(jnp.asarray(A), k=k, pivot=pivot)
    Qt, Rt, Jt = tqr.geqp3(torch.tensor(A), k=k, pivot=pivot)
    np.testing.assert_array_equal(Jt.numpy(), np.asarray(Jj))
    assert _rel(Rt, Rj) < 1e-10 and _rel(Qt, Qj) < 1e-10
    kk = Rt.shape[0]
    if kk == min(shape):
        assert float((Qt @ Rt - torch.tensor(A)[:, Jt]).abs().max()) < 1e-12
    _, R2, _ = tqr.geqp3(torch.tensor(A), k=k, want_q=False, pivot=pivot)
    assert torch.equal(R2, Rt)
