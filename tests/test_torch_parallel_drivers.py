"""The port's distributed drivers (dist_cqrrpt, dist_cqrrt, dist_rsvd,
dist_revd2, dist_spls, DistSquaredExpKernelLinOp, dist_krill) against the
JAX package's on its 8-device CPU mesh, in f64, at p = 1, 2 and 4 gloo
ranks on the CPU, on the inputs of tests/test_parallel.py with JAX's
draws injected (``sketch=`` as each rank's column block, ``omega=``,
``v0=``, ``noise=``).

Gates: Q, R, V, λ, the error estimate, ν and x within 1e-10 of the
largest entry of JAX's (U, Vt and V after aligning each column's sign:
LAPACK fixes an SVD's or eigh's signs by its own order of operations); J
and rank equal; the failure flags equal; the kernel product within 1e-12
absolute (JAX's test's gate); KRILL's iterations within 1 of JAX's and x
within 1e-8; SPLS's iterations within 1 and its normal-equations
residual under JAX's test's 1e-9 (unregularized, x within κ²·eps =
2.2e-4 of the exact least-squares solution, the floor of PCG on the
normal equations, which both packages reach at different points: JAX
4.1e-6, the port 1.0e-5 to 3.7e-5 on the CPU); replicated outputs
bit-equal on
every rank; with an undrawn sketch, J equal and R within 1e-10 at every
world size (each rank generates its own columns of one operator).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.gen import (MatGenInfo, MatType, gen_exp_singvals,
                                gen_singvec, mat_gen)
from randlapack_tpu.parallel import make_mesh, row_sharded

import _torch_parallel_ranks as ranks
from randlapack_tpu_torch.parallel import run_ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

WORLDS = (1, 2, 4)
TOL = 1e-10
REVD2_F32_BANDWIDTHS = (1.0, 2.0)


def _normal(seed, shape, scale=1.0, spawns=1, dtype=jnp.float64):
    """The ``spawns``-th draw of JAX's ``state.spawn()`` from ``seed``."""
    st = JRNG(seed)
    for _ in range(spawns):
        key, st = st.spawn()
    return np.asarray(jax.random.normal(key, shape, dtype=dtype) * scale)


def _gumbel_noise(seed, nblocks, n):
    """RPCholesky's draws as randlapack_tpu/comps/rpchol.py makes them."""
    rows = []
    for i in range(nblocks):
        key, _ = JRNG(seed).branch(i).spawn()
        rows.append(np.asarray(jax.random.gumbel(key, (n,),
                                                 dtype=jnp.float64)))
    return np.stack(rows)


def _inputs():
    from randlapack_tpu.pdkernels import standardize_dataset
    inp = {}
    A, _ = mat_gen(MatGenInfo(1024, 64, MatType.exponential, cond_num=1e5),
                   JRNG(20))
    inp["cqrrpt"] = dict(A=np.asarray(A),
                         S=_normal(21, (80, 1024), 1 / math.sqrt(80)))
    A, _ = mat_gen(MatGenInfo(960, 64, MatType.exponential, cond_num=1e6),
                   JRNG(31))
    inp["cqrrt"] = dict(A=np.asarray(A),
                        S=_normal(32, (80, 960), 1 / math.sqrt(80)))
    A, _ = gen_singvec(640, 48, gen_exp_singvals(48, 1e6, jnp.float64),
                       JRNG(22))
    inp["rsvd"] = dict(A=np.asarray(A), Om=_normal(23, (48, 16)))
    B, _ = mat_gen(MatGenInfo(512, 512, MatType.exponential, cond_num=1e8),
                   JRNG(41))
    B = np.asarray(B)
    inp["revd2"] = dict(A=B @ B.T / np.linalg.norm(B) ** 2, k=24,
                        Om=_normal(42, (512, 24)),
                        v0=_normal(42, (512, 1), spawns=2))
    A, _ = mat_gen(MatGenInfo(960, 48, MatType.exponential, cond_num=1e6),
                   JRNG(21))
    A = np.asarray(A)
    xt = np.asarray(jax.random.normal(jax.random.key(22), (48,),
                                      jnp.float64))
    b = A @ xt + 1e-8 * np.asarray(jax.random.normal(
        jax.random.key(23), (960,), jnp.float64))
    S = _normal(24, (192, 960), 1 / math.sqrt(192))
    spls = {f"mu{mu}": dict(A=A, b=b, mu=mu, seed=24, S=S)
            for mu in (0.0, 1e-4)}
    A, _ = mat_gen(MatGenInfo(640, 32, MatType.exponential, cond_num=1e4),
                   JRNG(61))
    B3 = np.asarray(jax.random.normal(jax.random.key(62), (640, 3),
                                      jnp.float64))
    spls["rhs3"] = dict(A=np.asarray(A), b=B3, mu=1e-6, seed=63,
                        S=_normal(63, (128, 640), 1 / math.sqrt(128)))
    inp["spls"] = spls
    X = standardize_dataset(jax.random.normal(jax.random.key(1), (6, 128),
                                              dtype=jnp.float64))
    V = jax.random.normal(jax.random.key(2), (128, 3), dtype=jnp.float64)
    inp["kernel"] = dict(X=np.asarray(X), V=np.asarray(V))
    X = np.asarray(standardize_dataset(jax.random.normal(
        jax.random.key(5), (6, 256), dtype=jnp.float64)))
    sub = X[:, :64]
    d2 = ((sub[:, :, None] - sub[:, None, :]) ** 2).sum(0)
    H = jax.random.normal(jax.random.key(6), (256, 1), dtype=jnp.float64)
    inp["krill"] = dict(X=X, bw=float(np.sqrt(np.median(d2[d2 > 0]))),
                        H=np.asarray(H), noise=_gumbel_noise(9, 2, 256))
    # f32 squared-exp kernel matrices of 256 points in 3-D: at bandwidth 2
    # λ₆₄/λ₁ is 5.4e-6, past √eps32 (3.5e-4); at bandwidth 1 it is 2.9e-3
    X = np.asarray(standardize_dataset(jax.random.normal(
        jax.random.key(7), (3, 256), dtype=jnp.float64)))
    d2 = ((X[:, :, None] - X[:, None, :]) ** 2).sum(0)
    inp["revd2_f32"] = {
        bw: dict(A=np.exp(-d2 / (2 * bw ** 2)).astype(np.float32), k=64,
                 Om=_normal(42, (256, 64), dtype=jnp.float32),
                 v0=_normal(42, (256, 1), spawns=2, dtype=jnp.float32))
        for bw in REVD2_F32_BANDWIDTHS}
    return inp


def _jax_runs(inp):
    from randlapack_tpu.parallel import (DistSquaredExpKernelLinOp,
                                         dist_cqrrpt, dist_cqrrt, dist_krill,
                                         dist_revd2, dist_rsvd, dist_spls)
    mesh = make_mesh(8)

    def rows(X):
        return jax.device_put(jnp.asarray(X), row_sharded(mesh))

    jx = {"cqrrpt": dist_cqrrpt(rows(inp["cqrrpt"]["A"]), mesh,
                                JRNG(21))[:5],
          "cqrrt": dist_cqrrt(rows(inp["cqrrt"]["A"]), mesh, JRNG(32))[:3],
          "rsvd": dist_rsvd(rows(inp["rsvd"]["A"]), 16, mesh,
                            JRNG(23))[:4],
          "revd2": dist_revd2(rows(inp["revd2"]["A"]), 24, mesh,
                              JRNG(42))[:5]}
    for bw, c in inp["revd2_f32"].items():
        jx[f"revd2_f32_{bw}"] = dist_revd2(rows(c["A"]), c["k"], mesh,
                                           JRNG(42))[4]
    for tag, c in inp["spls"].items():
        x, hist, it, _ = dist_spls(rows(c["A"]), jnp.asarray(c["b"]),
                                   c["mu"], mesh, JRNG(c["seed"]), tol=1e-12,
                                   max_iters=100)
        jx[f"spls_{tag}"] = (x, it)
    c = inp["kernel"]
    jx["kernel"] = DistSquaredExpKernelLinOp(
        jnp.asarray(c["X"]), 2.0, 1e-2, mesh).matmat(jnp.asarray(c["V"]))
    c = inp["krill"]
    X, hist, it, _ = dist_krill(jnp.asarray(c["X"]), c["bw"], 1e-2,
                                jnp.asarray(c["H"]), mesh, JRNG(9), k=64,
                                rpchol_block=32, tol=1e-8, max_iters=100)
    jx["krill"] = (X, it)
    return jax.tree_util.tree_map(np.asarray, jx)


@pytest.fixture(scope="module")
def runs():
    inp = _inputs()
    jx = _jax_runs(inp)
    port = {p: run_ranks(ranks.drivers_body, p, inp, backend="gloo",
                         device="cpu", timeout=300) for p in WORLDS}
    return inp, jx, port


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def _rows(res, key, i):
    return np.concatenate([r[key][i] for r in res])


def _aligned(ref, x, axis=0):
    """x with each column (axis 0) or row (axis 1) signed as ref's."""
    s = np.sign(np.sum(ref * x, axis=axis))
    return x * (s[None, :] if axis == 0 else s[:, None])


def _replicated(res, key, idx):
    for r in res[1:]:
        for i in idx:
            assert np.array_equal(r[key][i], res[0][key][i]), (key, i)


@pytest.mark.parametrize("p", WORLDS)
def test_cqrrpt(runs, p):
    _, jx, port = runs
    Qj, Rj, Jj, rankj, fj = jx["cqrrpt"]
    res = port[p]
    _, R, J, rank, f = res[0]["cqrrpt"]
    np.testing.assert_array_equal(J, Jj)
    assert int(rank) == int(rankj) == 64 and bool(f) == bool(fj) is False
    assert _rel(_rows(res, "cqrrpt", 0), Qj) <= TOL
    assert _rel(R, Rj) <= TOL
    _replicated(res, "cqrrpt", (1, 2, 3, 4))


@pytest.mark.parametrize("p", WORLDS)
def test_cqrrt(runs, p):
    _, jx, port = runs
    Qj, Rj, fj = jx["cqrrt"]
    res = port[p]
    assert _rel(_rows(res, "cqrrt", 0), Qj) <= TOL
    assert _rel(res[0]["cqrrt"][1], Rj) <= TOL
    assert bool(res[0]["cqrrt"][2]) == bool(fj) is False
    _replicated(res, "cqrrt", (1, 2))


@pytest.mark.parametrize("p", WORLDS)
def test_rsvd(runs, p):
    _, jx, port = runs
    Uj, Sj, Vtj, fj = jx["rsvd"]
    res = port[p]
    U = _rows(res, "rsvd", 0)
    _, S, Vt, f = res[0]["rsvd"]
    assert _rel(S, Sj) <= TOL and bool(f) == bool(fj) is False
    assert _rel(_aligned(Uj, U), Uj) <= TOL
    assert _rel(_aligned(Vtj, Vt, axis=1), Vtj) <= TOL
    _replicated(res, "rsvd", (1, 2, 3))


@pytest.mark.parametrize("p", WORLDS)
def test_revd2(runs, p):
    _, jx, port = runs
    Vj, lamj, errj, nuj, fj = jx["revd2"]
    res = port[p]
    V = _rows(res, "revd2", 0)
    _, lam, err, nu, f = res[0]["revd2"]
    assert _rel(lam, lamj) <= TOL and _rel(_aligned(Vj, V), Vj) <= TOL
    assert _rel(err, errj) <= TOL and _rel(nu, nuj) <= TOL
    assert bool(f) == bool(fj) is False
    _replicated(res, "revd2", (1, 2, 3, 4))


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("tag", ("mu0.0", "mu0.0001", "rhs3"))
def test_spls(runs, tag, p):
    inp, jx, port = runs
    xj, itj = jx[f"spls_{tag}"]
    res = port[p]
    x, it, counter = res[0][f"spls_{tag}"]
    assert x.shape == xj.shape and counter == 1
    assert abs(int(it) - int(itj)) <= 1 and int(it) < 60
    c = inp["spls"][tag]
    A, b, mu = c["A"], c["b"], c["mu"]

    def ne(x):   # the JAX test's normal-equations residual
        return (np.linalg.norm(A.T @ (A @ x - b) + mu * x)
                / np.linalg.norm(A.T @ b))

    assert ne(x) < 1e-9 and ne(xj) < 1e-9
    if mu > 0:
        assert _rel(x, xj) <= TOL
    else:
        # unregularized, PCG on the normal equations attains x only to
        # κ(A)²·eps (κ 1e6: 2.2e-4) whatever its stop; both packages are
        # held to that against the exact least-squares solution
        xs = np.linalg.lstsq(A, b, rcond=None)[0]
        floor = 1e6 ** 2 * np.finfo(np.float64).eps
        assert _rel(x, xs) <= floor and _rel(xj, xs) <= floor
    _replicated(res, f"spls_{tag}", (0, 1))


@pytest.mark.parametrize("p", WORLDS)
def test_kernel_matmat(runs, p):
    _, jx, port = runs
    for r in port[p]:
        np.testing.assert_allclose(r["kernel"], jx["kernel"], rtol=0,
                                   atol=1e-12)
        assert np.array_equal(r["kernel"], port[p][0]["kernel"])


@pytest.mark.parametrize("p", WORLDS)
def test_krill(runs, p):
    _, jx, port = runs
    Xj, itj = jx["krill"]
    res = port[p]
    X, it = res[0]["krill"]
    assert abs(int(it) - int(itj)) <= 1 and int(it) < 100
    assert np.abs(X - Xj).max() <= 1e-8 * np.abs(Xj).max()
    _replicated(res, "krill", (0, 1))


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("bw", REVD2_F32_BANDWIDTHS)
def test_revd2_f32_breaks_where_the_spectrum_falls_past_root_eps(runs, bw,
                                                                 p):
    """dist_revd2 orthogonalizes its power iterations by CholQR2 with no
    rescue, in f32 as in f64: where λ_k/λ₁ falls below √eps32 the Gram's
    Cholesky breaks and ``fail`` is raised, in JAX's function on its
    8-device mesh and in the port's at every world size alike. The
    single-device revd2_fixed_rank of either package (SYRF: power passes
    stabilized by LU, and a CholQR that falls back to Householder QR)
    holds on the same matrix and draws."""
    from randlapack_tpu.drivers import REVD2Config as JREVD2Config
    from randlapack_tpu.drivers import revd2_fixed_rank as jrevd2
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import REVD2Config, revd2_fixed_rank
    inp, jx, port = runs
    c = inp["revd2_f32"][bw]
    breaks = bw == 2.0
    assert bool(jx[f"revd2_f32_{bw}"]) is breaks
    for r in port[p]:
        assert bool(r[f"revd2_f32_{bw}"]) is breaks
    one = revd2_fixed_rank(torch.as_tensor(c["A"]), c["k"], REVD2Config(),
                           RNGState(42), omega=torch.as_tensor(c["Om"]),
                           v0=torch.as_tensor(c["v0"]))
    assert not bool(one[4]) and bool(torch.isfinite(one[1]).all())
    assert not bool(jrevd2(jnp.asarray(c["A"]), c["k"], JREVD2Config(),
                           JRNG(42))[4])


def test_undrawn_sketch_does_not_depend_on_the_world_size(runs):
    port = runs[2]
    Q1, R1, J1 = (port[1][0]["cqrrpt_drawn"][i] for i in range(3))
    for p in (2, 4):
        _, R, J = port[p][0]["cqrrpt_drawn"]
        np.testing.assert_array_equal(J, J1)
        assert _rel(R, R1) <= TOL
        assert _rel(_rows(port[p], "cqrrpt_drawn", 0), Q1) <= TOL
