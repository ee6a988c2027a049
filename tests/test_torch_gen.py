"""The port's generators (randlapack_tpu_torch.gen) and Matrix Market IO
(randlapack_tpu_torch.extras.io) against the JAX package's on the CPU in
f64. Every random draw is made by JAX as its generator makes it
(``state.spawn()`` once a draw, in the generator's order) and injected
through ``draws=``; the port's state then advances as the JAX one does.

Tolerances: the spectrum functions and ``kahan_matrix`` within 2 ulps of
each entry. They are deterministic, but exp, log and pow on XLA's CPU
backend and PyTorch's are different approximations:
the two differ by up to 1.2 ulps on these inputs, and the functions built
only from + − × ÷ (quadratic, spiked) are bit-equal. The random
generators on injected draws within 1e-12 of the largest entry (the
Householder QR of the Gaussian, LAPACK's in both, and the products in
another order); the integer draws and the sparse masks exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu import gen as jgen
from randlapack_tpu.extras import io as jio

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import gen as tgen
from randlapack_tpu_torch.extras import io as tio

EPS = np.finfo(np.float64).eps
REL = 1e-12


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _ulps(a, b):
    """Largest entrywise |a − b| / |b| in units of eps (b's zeros must be
    a's)."""
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape
    nz = b != 0
    assert np.array_equal(a[~nz], b[~nz])
    return (np.abs(a - b)[nz] / np.abs(b)[nz]).max(initial=0.0) / EPS


def _tstate(st, seed=0):
    return rt.RNGState(seed, _counter=int(st.counter))


def _jdraws(st, specs):
    """The draws a JAX generator makes from ``st``, one spawn each:
    ``specs`` is a list of ("normal", shape), ("uniform", shape) or
    ("randint", shape, high)."""
    out = []
    for spec in specs:
        key, st = st.spawn()
        if spec[0] == "normal":
            out.append(np.asarray(jax.random.normal(key, spec[1],
                                                    dtype=jnp.float64)))
        elif spec[0] == "uniform":
            out.append(np.asarray(jax.random.uniform(key, spec[1])))
        else:
            out.append(np.asarray(jax.random.randint(
                key, spec[1], 0, spec[2], dtype=jnp.int32)))
    return [torch.tensor(x) for x in out]


def _check_state(t_state, j_state):
    assert t_state.counter == int(j_state.counter)


# -- the deterministic spectra ------------------------------------------------

SPECTRA = {
    "poly": (lambda mod, k, c, **kw: mod.gen_poly_singvals(k, c, 2.0,
                                                          **kw), 2.0),
    "exp": (lambda mod, k, c, **kw: mod.gen_exp_singvals(k, c, **kw), 2.0),
    "quadratic": (lambda mod, k, c, **kw: mod.gen_quadratic_singvals(
        k, c, **kw), 0.0),
    "step": (lambda mod, k, c, **kw: mod.gen_step_singvals(k, c, **kw),
             2.0),
    "spiked": (lambda mod, k, c, **kw: mod.gen_spiked_singvals(k, c, **kw),
               0.0),
}


@pytest.mark.parametrize("k,cond", [(1, 10.0), (37, 1e3), (1024, 1e4),
                                    (4096, 1e6)])
@pytest.mark.parametrize("name", list(SPECTRA))
def test_spectrum_functions(name, k, cond):
    build, ulps = SPECTRA[name]
    got = build(tgen, k, cond, dtype=torch.float64, device="cpu")
    ref = build(jgen, k, cond, dtype=jnp.float64)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert _ulps(got, ref) <= ulps


@pytest.mark.parametrize("n", [5, 64, 300])
def test_kahan_matrix(n):
    got = tgen.kahan_matrix(n, torch.float64, device="cpu")
    assert _ulps(got, jgen.kahan_matrix(n, jnp.float64)) <= 2.0


# -- the random generators on injected draws ----------------------------------

def test_haar_basis_and_gen_singvec():
    st = JRNG(3)
    (G,) = _jdraws(st, [("normal", (50, 12))])
    Qj, st_j = jgen.haar_basis(50, 12, st, jnp.float64)
    Qt, st_t = tgen.haar_basis(50, 12, _tstate(st), torch.float64,
                               device="cpu", draws=(G,))
    assert _rel(Qt, Qj) <= REL
    _check_state(st_t, st_j)
    s = jgen.gen_exp_singvals(12, 1e3, jnp.float64)
    draws = _jdraws(st, [("normal", (50, 12)), ("normal", (30, 12))])
    Aj, st_j = jgen.gen_singvec(50, 30, s, st)
    At, st_t = tgen.gen_singvec(50, 30, torch.tensor(np.asarray(s)),
                                _tstate(st), draws=draws)
    assert _rel(At, Aj) <= REL
    _check_state(st_t, st_j)


def _mat_gen_draws(info, st):
    m, n = info.n_rows, info.n_cols
    k = info.rank or min(m, n)
    t = info.mat_type
    if t == jgen.MatType.gaussian:
        return _jdraws(st, [("normal", (m, n))])
    if t == jgen.MatType.adversarial:
        return _jdraws(st, [("normal", (m, max(n // 4, 1))),
                            ("normal", (m, n))])
    if t in (jgen.MatType.kahan, jgen.MatType.custom_input):
        return None
    if t == jgen.MatType.bad_cholqr:
        k = min(m, n)
    return _jdraws(st, [("normal", (m, k)), ("normal", (n, k))])


@pytest.mark.parametrize("mat_type,m,n,kw", [
    ("gaussian", 30, 20, dict(scaling=2.5)),
    ("polynomial", 40, 24, dict(cond_num=1e4, exponent=1.5)),
    ("exponential", 24, 40, dict(cond_num=1e6, rank=10)),
    ("step", 36, 20, dict(cond_num=1e3)),
    ("spiked", 40, 30, dict(cond_num=1e2, scaling=0.5)),
    ("kahan", 25, 25, {}),
    ("bad_cholqr", 60, 16, {}),
    ("adversarial", 32, 18, {}),
])
def test_mat_gen(mat_type, m, n, kw):
    info_j = jgen.MatGenInfo(m, n, jgen.MatType(mat_type), **kw)
    info_t = tgen.MatGenInfo(m, n, tgen.MatType(mat_type), **kw)
    st = JRNG(11)
    Aj, st_j = jgen.mat_gen(info_j, st)
    At, st_t = tgen.mat_gen(info_t, _tstate(st), device="cpu",
                            draws=_mat_gen_draws(info_j, st))
    assert At.dtype == torch.float64 and At.device.type == "cpu"
    if mat_type == "kahan":
        assert _ulps(At, Aj) <= 2.0
    else:
        assert _rel(At, Aj) <= REL
    _check_state(st_t, st_j)


def test_mat_gen_custom_input_reads_matrix_market(tmp_path):
    rng = np.random.default_rng(4)
    rows, cols = rng.integers(0, 12, 40), rng.integers(0, 9, 40)
    vals = rng.standard_normal(40)
    path = str(tmp_path / "a.mtx")
    tio.mm_write(path, rows, cols, vals, (12, 9))
    info_j = jgen.MatGenInfo(12, 9, jgen.MatType.custom_input,
                             scaling=3.0, filename=path)
    info_t = tgen.MatGenInfo(12, 9, tgen.MatType.custom_input,
                             scaling=3.0, filename=path)
    Aj, _ = jgen.mat_gen(info_j, JRNG(0))
    At, _ = tgen.mat_gen(info_t, rt.RNGState(0), device="cpu")
    assert np.array_equal(At.numpy(), np.asarray(Aj))


def test_mm_read_and_write_against_the_jax_package(tmp_path):
    rng = np.random.default_rng(5)
    rows, cols = rng.integers(0, 15, 60), rng.integers(0, 11, 60)
    vals = rng.standard_normal(60)
    p_t, p_j = str(tmp_path / "t.mtx"), str(tmp_path / "j.mtx")
    tio.mm_write(p_t, rows, cols, vals, (15, 11))
    jio.mm_write(p_j, rows, cols, vals, (15, 11))
    for path in (p_t, p_j):
        got, ref = tio.mm_read(path), jio.mm_read(path)
        for g, r in zip(got[:3], ref[:3]):
            assert np.array_equal(g, np.asarray(r))
        assert tuple(got[3]) == tuple(ref[3]) == (15, 11)
        assert np.array_equal(tio.mm_read(path, dense=True),
                              jio.mm_read(path, dense=True))
    D = rng.standard_normal((8, 8)) * (rng.random((8, 8)) < 0.4)
    D = D + D.T
    r, c = np.nonzero(D)
    sym = str(tmp_path / "s.mtx")
    tio.mm_write(sym, r, c, D[r, c], (8, 8), symmetric=True)
    assert np.array_equal(tio.mm_read(sym, dense=True), D)
    assert np.array_equal(tio.mm_read(sym, dense=True),
                          jio.mm_read(sym, dense=True))


def test_gen_sparse_coo():
    st = JRNG(12)
    (rj, cj, vj), st_j = jgen.gen_sparse_coo(20, 15, 50, st)
    draws = _jdraws(st, [("randint", (50,), 20), ("randint", (50,), 15),
                         ("normal", (50,))])
    (rt_, ct, vt), st_t = tgen.gen_sparse_coo(20, 15, 50, _tstate(st),
                                              device="cpu", draws=draws)
    for g, r in ((rt_, rj), (ct, cj), (vt, vj)):
        assert np.array_equal(g.numpy(), np.asarray(r))
    _check_state(st_t, st_j)


@pytest.mark.parametrize("density", [0.05, 0.3])
def test_gen_sparse_from_singvals(density):
    m, n = 64, 20
    s = jgen.gen_exp_singvals(n, 1e4, jnp.float64)
    st = JRNG(21)
    Aj, st_j = jgen.gen_sparse_from_singvals(m, n, s, density, st)
    draws = _jdraws(st, [("normal", (m, n)), ("normal", (n, n)),
                         ("uniform", (m, n))])
    At, st_t = tgen.gen_sparse_from_singvals(
        m, n, torch.tensor(np.asarray(s)), density, _tstate(st),
        draws=draws)
    assert np.array_equal(At.numpy() != 0, np.asarray(Aj) != 0)
    assert _rel(At, Aj) <= REL
    _check_state(st_t, st_j)


def test_psd_from_eigvals():
    ev = jnp.linspace(1.0, 1e-3, 16)
    st = JRNG(31)
    Aj, st_j = jgen.psd_from_eigvals(16, ev, st)
    At, st_t = tgen.psd_from_eigvals(16, torch.tensor(np.asarray(ev)),
                                     _tstate(st),
                                     draws=_jdraws(st, [("normal",
                                                         (16, 16))]))
    assert _rel(At, Aj) <= REL
    assert torch.equal(At, At.T)
    _check_state(st_t, st_j)


# -- the port's own draws -----------------------------------------------------

def test_generators_draw_on_the_device_and_advance_the_state():
    st = rt.RNGState(7)
    A, nxt = tgen.mat_gen(tgen.MatGenInfo(30, 20, tgen.MatType.exponential,
                                          cond_num=1e3), st, device="cpu")
    assert A.device.type == "cpu" and nxt.counter == st.counter + 2
    sv = torch.linalg.svdvals(A)
    assert float(sv[0] / sv[-1]) == pytest.approx(1e3, rel=1e-10)
    A2, _ = tgen.mat_gen(tgen.MatGenInfo(30, 20, tgen.MatType.exponential,
                                         cond_num=1e3), st, device="cpu")
    assert torch.equal(A, A2)
    (r, c, v), nxt = tgen.gen_sparse_coo(9, 7, 40, st, device="cpu")
    assert int(r.max()) < 9 and int(c.max()) < 7 and v.shape == (40,)
    assert nxt.counter == st.counter + 3
    As, nxt = tgen.gen_sparse_from_singvals(
        200, 10, tgen.gen_exp_singvals(10, 10.0, torch.float64,
                                       device="cpu"), 0.25, st)
    assert nxt.counter == st.counter + 3
    assert 0.15 < float((As != 0).double().mean()) < 0.35
    Aa, nxt = tgen.adversarial_matrix(20, 12, st, torch.float64,
                                      device="cpu")
    assert nxt.counter == st.counter + 2
    assert float((Aa[:, :3] - Aa[:, 3:6]).abs().max()) < 1e-6
