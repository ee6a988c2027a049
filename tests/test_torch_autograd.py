"""Autograd and ``torch.func.vmap`` through the port's drivers on the CPU
in f64, at the JAX package's own tests' shapes
(``tests/test_rsvd_qb.py`` ``TestBatching``/``TestDifferentiability``,
``tests/test_property_sweeps.py`` ``TestTransformComposition``), with
every random draw made by JAX as its function makes it and injected.

Gates: a gradient against a central difference at rtol 1e-4 (the JAX
tests' tolerance) and against ``jax.grad`` of the JAX function on the same
draws to 1e-8 relative; a vmapped batch member against the port's
unbatched run at atol 1e-11 (the JAX tests' tolerance), S[:8] against
numpy's SVD at rtol 1e-4, and the batch against ``jax.vmap`` of the JAX
function at the parity tests' tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.comps import QBConfig as JQBConfig
from randlapack_tpu.comps import qb_blocked as j_qb_blocked
from randlapack_tpu.drivers import BQRRPConfig as JBQRRPConfig
from randlapack_tpu.drivers import HQRRPConfig as JHQRRPConfig
from randlapack_tpu.drivers import RSVDConfig as JRSVDConfig
from randlapack_tpu.drivers import bqrrp_factored as j_bqrrp_factored
from randlapack_tpu.drivers import hqrrp as j_hqrrp
from randlapack_tpu.drivers import hqrrp_lapack_format as j_hqrrp_lapack
from randlapack_tpu.drivers import rsvd_fixed_rank as j_rsvd_fixed_rank
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen

from randlapack_tpu_torch import RNGState
from randlapack_tpu_torch.comps import QBConfig, qb_blocked
from randlapack_tpu_torch.drivers import (BQRRPConfig, HQRRPConfig,
                                          RSVDConfig, bqrrp_factored, hqrrp,
                                          hqrrp_lapack_format,
                                          rsvd_fixed_rank)
from randlapack_tpu_torch.errors import RandLAPACKError

E = 1e-6


def _mat(m, n, cond, seed):
    A, _ = mat_gen(MatGenInfo(m, n, MatType.exponential, cond_num=cond),
                   JRNG(seed))
    return np.asarray(A)


def _qb_omegas(n, k, b, seed):
    """QB's per-block RS starts as the JAX package draws them: block i
    from ``RNGState(seed).branch(i).spawn()``, (n, b) for the default two
    passes over the data."""
    st = JRNG(seed)
    return [torch.tensor(np.asarray(jax.random.normal(
        st.branch(i).spawn()[0], (n, b), dtype=jnp.float64)))
        for i in range(k // b)]


def _hqrrp_sketch(seed, d, m):
    """HQRRP's uniform operator G as ``_hqrrp_core`` draws it."""
    key, _ = JRNG(seed).spawn()
    return torch.tensor(np.asarray(jax.random.uniform(
        key, (d, m), dtype=jnp.float64, minval=-1.0, maxval=1.0)))


def _bqrrp_sketch(seed, d, m):
    """BQRRP's Gaussian sketch as ``bqrrp_factored`` draws it."""
    key, _ = JRNG(seed).spawn()
    return torch.tensor(np.asarray(jax.random.normal(
        key, (d, m), dtype=jnp.float64)) / np.sqrt(d))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _grad(loss, A):
    At = torch.tensor(A, requires_grad=True)
    loss(At).backward()
    return At.grad.numpy()


def _central(loss, A, D):
    """(loss(A + e·D) − loss(A − e·D)) / 2e."""
    with torch.no_grad():
        return float((loss(torch.tensor(A + E * D))
                      - loss(torch.tensor(A - E * D))) / (2 * E))


def _unit(shape, i, j):
    D = np.zeros(shape)
    D[i, j] = 1.0
    return D


# -- autograd -----------------------------------------------------------------

def test_grad_through_qb():
    A = _mat(96, 64, 100, 0)
    om = _qb_omegas(64, 32, 16, 1)

    def loss(a):
        Q, B, _, _ = qb_blocked(a, 32, QBConfig(block_size=16), RNGState(1),
                                omegas=om)
        return torch.sum((a - Q @ B) ** 2)

    def jloss(a):
        Q, B, _, _ = j_qb_blocked(a, 32, JQBConfig(block_size=16), JRNG(1))
        return jnp.sum(jnp.square(a - Q @ B))

    g = _grad(loss, A)
    fd = _central(loss, A, _unit(A.shape, 3, 5))
    np.testing.assert_allclose(g[3, 5], fd, rtol=1e-4)
    assert _rel(g, jax.grad(jloss)(jnp.asarray(A))) <= 1e-8


def test_grad_through_rsvd():
    A = _mat(96, 64, 100, 0)
    om = _qb_omegas(64, 16, 16, 2)
    cfg = RSVDConfig(QBConfig(block_size=16))

    def loss(a):
        return torch.sum(rsvd_fixed_rank(a, 16, cfg, RNGState(2),
                                         omegas=om)[1][:4])

    def jloss(a):
        return jnp.sum(j_rsvd_fixed_rank(
            a, 16, JRSVDConfig(JQBConfig(block_size=16)), JRNG(2))[1][:4])

    g = _grad(loss, A)
    fd = _central(loss, A, _unit(A.shape, 2, 2))
    np.testing.assert_allclose(g[2, 2], fd, rtol=1e-4)
    assert _rel(g, jax.grad(jloss)(jnp.asarray(A))) <= 1e-8


def test_grad_through_hqrrp_r():
    A = _mat(40, 32, 100, 9)
    cfg = HQRRPConfig(block_size=16)
    G = _hqrrp_sketch(2, 16 + cfg.oversample, 40)

    def loss(a):
        R = hqrrp_lapack_format(a, cfg, RNGState(2), sketch=G)[2]
        return torch.sum(torch.diagonal(R[:32, :32]) ** 2)

    def jloss(a):
        R = j_hqrrp_lapack(a, JHQRRPConfig(block_size=16), JRNG(2))[2]
        return jnp.sum(jnp.diag(R[:32, :32]) ** 2)

    D = np.asarray(jax.random.normal(jax.random.key(3), A.shape,
                                     jnp.float64))
    g = _grad(loss, A)
    fd = _central(loss, A, D)
    assert abs(fd - float(np.sum(g * D))) < 1e-4 * max(abs(fd), 1.0)
    assert _rel(g, jax.grad(jloss)(jnp.asarray(A))) <= 1e-8


# -- vmap ---------------------------------------------------------------------

def test_vmapped_rsvd():
    As = np.stack([_mat(128, 96, 1e4, i) for i in range(3)])
    om = _qb_omegas(96, 32, 16, 7)
    cfg = RSVDConfig(QBConfig(block_size=16))

    def f(a):
        return rsvd_fixed_rank(a, 32, cfg, RNGState(7), omegas=om)[:3]

    U, S, Vt = torch.func.vmap(f)(torch.tensor(As))
    assert U.shape == (3, 128, 32) and S.shape == (3, 32)
    jcfg = JRSVDConfig(JQBConfig(block_size=16))
    Uj, Sj, Vtj = jax.vmap(
        lambda a: j_rsvd_fixed_rank(a, 32, jcfg, JRNG(7))[:3])(
            jnp.asarray(As))
    for i in range(3):
        ref = f(torch.tensor(As[i]))
        for x, r in zip((U, S, Vt), ref):
            np.testing.assert_allclose(x[i].numpy(), r.numpy(), atol=1e-11)
        np.testing.assert_allclose(
            S[i][:8].numpy(), np.linalg.svd(As[i], compute_uv=False)[:8],
            rtol=1e-4)
    # the parity tests' gates: S to 1e-12 relative, U and V to 1e-10
    # after LAPACK's per-column signs
    assert _rel(S, Sj) <= 1e-12
    for x, r in ((U, Uj), (Vt.transpose(1, 2), jnp.swapaxes(Vtj, 1, 2))):
        x, r = x.numpy(), np.asarray(r)
        s = np.sign(np.sum(x * r, axis=1, keepdims=True))
        assert np.abs(x * s - r).max() <= 1e-10


def test_vmapped_hqrrp():
    As = np.stack([_mat(60, 48, 1e4, i) for i in range(3)])
    cfg = HQRRPConfig(block_size=16)
    G = _hqrrp_sketch(0, 16 + cfg.oversample, 60)

    def f(a):
        return hqrrp(a, cfg, RNGState(0), sketch=G)[:3]

    Q, R, J = torch.func.vmap(f)(torch.tensor(As))
    Qj, Rj, Jj = jax.vmap(
        lambda a: j_hqrrp(a, JHQRRPConfig(block_size=16), JRNG(0))[:3])(
            jnp.asarray(As))
    for i in range(3):
        ref = f(torch.tensor(As[i]))
        for x, r in zip((Q, R), ref[:2]):
            np.testing.assert_allclose(x[i].numpy(), r.numpy(), atol=1e-11)
        assert torch.equal(J[i], ref[2])
    np.testing.assert_array_equal(J.numpy(), np.asarray(Jj))
    assert _rel(R, Rj) <= 1e-10 and _rel(Q, Qj) <= 1e-10


def test_vmapped_bqrrp_factored():
    As = np.stack([_mat(60, 48, 1e4, i) for i in range(3)])
    cfg = BQRRPConfig(block_size=16)
    S = _bqrrp_sketch(1, int(cfg.d_factor * 16), 60)

    def f(a):
        fac = bqrrp_factored(a, cfg, RNGState(1), sketch=S)[0]
        return fac.R, fac.J

    R, J = torch.func.vmap(f)(torch.tensor(As))
    Rj, Jj = jax.vmap(lambda a: (lambda fac: (fac.R, fac.J))(
        j_bqrrp_factored(a, JBQRRPConfig(block_size=16), JRNG(1))[0]))(
            jnp.asarray(As))
    for i in range(3):
        Ri, Ji = f(torch.tensor(As[i]))
        np.testing.assert_allclose(R[i].numpy(), Ri.numpy(), atol=1e-11)
        assert torch.equal(J[i], Ji)
    np.testing.assert_array_equal(J.numpy(), np.asarray(Jj))
    assert _rel(R, Rj) <= 1e-10


def test_card_guards_name_vmap_and_grad():
    """The guard every ctypes launch passes (``_build.call``) refuses a
    batched tensor and one autograd would differentiate through; no
    kernel runs here, so the guard is called as a launch calls it."""
    from randlapack_tpu_torch.ops.util import require_kernel_operands
    x = torch.ones(4, dtype=torch.float64, requires_grad=True)
    with pytest.raises(RandLAPACKError, match="autograd"):
        require_kernel_operands("K3", x)
    with torch.no_grad():
        require_kernel_operands("K3", x)
    with pytest.raises(RandLAPACKError, match="vmap"):
        torch.func.vmap(lambda t: require_kernel_operands("K3", t) or t)(
            torch.ones(2, 3))
