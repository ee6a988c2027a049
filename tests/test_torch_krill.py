"""KRILL as a whole — the port's ``krill_full_rpchol`` and
``krill_restricted_rpchol`` against the JAX package's on the CPU in f64,
at the shapes of the JAX package's own KRILL tests
(tests/test_psd_track.py): the same data from numpy, RPCholesky's Gumbel
noise drawn with JAX as ``randlapack_tpu/comps/rpchol.py`` draws it and
injected through ``noise=``.

Tolerances: the iteration count within ±1 (the last residual may land on
either side of the stopping test), X within 1e-7 relative (two PCG runs
stopped at tol 1e-8 on systems of condition up to 1e3), true residual
below 1e-6 as the JAX tests ask; the direct restricted solve within
1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JState
from randlapack_tpu import drivers as jd, linops as jl, pdkernels as jpd
from randlapack_tpu.comps import PCGConfig as JPCGConfig

from randlapack_tpu_torch import (RNGState, drivers as td, linops as tl,
                                  pdkernels as tpd)
from randlapack_tpu_torch.comps import PCGConfig, frobenius_seminorm
from randlapack_tpu_torch.ops import kernels as tk


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _gumbel_noise(state, nblocks, n):
    rows = []
    for i in range(nblocks):
        key, _ = state.branch(i).spawn()
        rows.append(np.asarray(jax.random.gumbel(key, (n,),
                                                 dtype=jnp.float64)))
    return torch.tensor(np.stack(rows))


def _data(n, d, s, seed):
    rng = np.random.default_rng(seed)
    X = np.asarray(jpd.standardize_dataset(
        jnp.asarray(rng.standard_normal((d, n)))))
    return X, rng.standard_normal((n, s))


def _true_residuals(X, bw, mus, Xs, H):
    K = tpd.squared_exp_kernel(torch.tensor(X), torch.tensor(X), bw)
    mu_cols = torch.tensor(np.broadcast_to(np.asarray(mus, float),
                                           (H.shape[1],)).copy())
    R = K @ Xs + Xs * mu_cols[None, :] - torch.tensor(H)
    return (torch.linalg.norm(R, dim=0)
            / torch.linalg.norm(torch.tensor(H), dim=0)).numpy()


# (n, d, mus, k, block, max_iters, operator): the first two are the JAX
# tests' cases, the third a kernel operator with per-column μ
CASES = {
    "one_mu_kernel_linop": (400, 6, [1e-3], None, 32, 200, "kernel"),
    "two_mus_explicit": (300, 4, [1e-2, 1e-3], 128, 32, 400, "explicit"),
    "three_mus_kernel_linop": (300, 4, [1e-1, 1e-2, 1e-3], 128, 32, 400,
                               "kernel"),
}


def _operators(kind, X, mus):
    if kind == "kernel":
        return (jpd.SquaredExpKernelLinOp(jnp.asarray(X), 1.0,
                                          jnp.asarray(mus), block=128),
                tpd.SquaredExpKernelLinOp(torch.tensor(X), 1.0, mus,
                                          block=128))
    K = np.asarray(jpd.squared_exp_kernel(jnp.asarray(X), jnp.asarray(X),
                                          1.0))
    return (jl.RegExplicitSymLinOp(jnp.asarray(K), jnp.asarray(mus)),
            tl.RegExplicitSymLinOp(torch.tensor(K), mus))


@pytest.mark.parametrize("case", list(CASES))
def test_krill_full_rpchol_parity(case):
    n, d, mus, k, block, max_iters, kind = CASES[case]
    X, H = _data(n, d, len(mus), 6)
    Gj, Gt = _operators(kind, X, mus)
    mus_arg = mus[0] if len(mus) == 1 else mus
    pcg_kw = dict(tol=1e-8, max_iters=max_iters)
    Xj, hj, ij, _ = jd.krill_full_rpchol(
        Gj, jnp.asarray(H), jnp.asarray(mus_arg),
        jd.KrillConfig(k=k, rpchol_block=block, pcg=JPCGConfig(**pcg_kw)),
        JState(14))
    k_used = k or max(block, block * (int(np.sqrt(n)) // block))
    noise = _gumbel_noise(JState(14), k_used // block, n)
    before = dict(tk.LAUNCHES)
    Xt, ht, it, nxt = td.krill_full_rpchol(
        Gt, torch.tensor(H), mus_arg,
        td.KrillConfig(k=k, rpchol_block=block, pcg=PCGConfig(**pcg_kw)),
        RNGState(14), noise=noise)
    assert isinstance(it, int) and abs(it - int(ij)) <= 1 and it < max_iters
    assert _rel(Xt, Xj) < 1e-7
    assert ht.shape == hj.shape == (max_iters + 1, len(mus))
    # the two residual histories start together; over a hundred CG steps
    # they drift apart along their rounding while X converges to one answer
    assert _rel(ht[:10], np.asarray(hj)[:10]) < 1e-9
    assert (_true_residuals(X, 1.0, mus, Xt, H) < 1e-6).all()
    assert nxt.counter == 1
    assert tk.LAUNCHES == before          # CPU tensors: no kernel launch


def test_krill_draws_its_own_noise_and_takes_a_seminorm():
    X, H = _data(200, 4, 2, 1)
    G = tpd.SquaredExpKernelLinOp(torch.tensor(X), 1.5, 1e-2, block=64)
    cfg = td.KrillConfig(k=64, rpchol_block=32,
                         pcg=PCGConfig(tol=1e-8, max_iters=200))
    X1, _, i1, _ = td.krill_full_rpchol(G, torch.tensor(H), 1e-2, cfg,
                                        RNGState(0))
    X2, _, i2, _ = td.krill_full_rpchol(G, torch.tensor(H), 1e-2, cfg,
                                        RNGState(0))
    assert i1 == i2 and torch.equal(X1, X2)
    assert (_true_residuals(X, 1.5, [1e-2], X1, H) < 1e-7).all()
    import dataclasses
    Xs, hist, _, _ = td.krill_full_rpchol(
        G, torch.tensor(H), 1e-2,
        dataclasses.replace(cfg, seminorm=frobenius_seminorm), RNGState(0))
    assert hist.shape == (201, 2)
    assert (_true_residuals(X, 1.5, [1e-2], Xs, H) < 1e-5).all()


@pytest.mark.parametrize("s,mus", [(2, [1e-2, 1e-3]), (0, 1e-2)])
def test_krill_restricted_rpchol_parity(s, mus):
    """s = 0: a vector right-hand side, as the JAX function takes it."""
    n, k, block = 300, 64, 32
    X, H = _data(n, 4, max(s, 1), 6)
    H = H if s else H[:, 0]
    Gj = jpd.SquaredExpKernelLinOp(jnp.asarray(X), 1.0, jnp.asarray(1e-2))
    Gt = tpd.SquaredExpKernelLinOp(torch.tensor(X), 1.0, 1e-2)
    Xj, indj, yj, _ = jd.krill_restricted_rpchol(
        Gj, jnp.asarray(H), jnp.asarray(mus),
        jd.KrillConfig(k=k, rpchol_block=block), JState(9))
    noise = _gumbel_noise(JState(9), k // block, n)
    Xt, indt, yt, _ = td.krill_restricted_rpchol(
        Gt, torch.tensor(H), mus, td.KrillConfig(k=k, rpchol_block=block),
        RNGState(9), noise=noise)
    np.testing.assert_array_equal(indt.numpy(), np.asarray(indj))
    assert Xt.shape == Xj.shape and yt.shape == yj.shape
    assert _rel(Xt, Xj) < 1e-8
    off = np.setdiff1d(np.arange(n), indt.numpy())
    assert float(Xt[off].abs().max()) == 0
