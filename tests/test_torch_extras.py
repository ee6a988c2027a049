"""The port's extras (randlapack_tpu_torch.extras: the solver operators
and Matrix Market IO, native and scipy) against the JAX package's on the
CPU in f64, on the same sparse matrices (numpy-seeded, as
tests/test_extras_utils.py builds them).

Both packages factor with the same scipy SuperLU calls, so their factors
are identical and the solves differ only in the order of the triangular
solves' sums: solves are held within 1e-12 of the largest entry of the
JAX result, and to K·X = B within 1e-9 (the JAX tests' gate). ABRIK over
a solver operator gets the JAX-drawn start (``v0=``); its singular values
are held within 1e-10 of the JAX package's (the operator changes only
rounding), and to the JAX tests' own gates against the exact spectrum.
The interop round trip builds the port's operator on the JAX operator's
own SuperLU factors.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.drivers import ABRIKConfig as JABRIKConfig
from randlapack_tpu.drivers import abrik as j_abrik
from randlapack_tpu.extras import CholSolverLinOp as JChol
from randlapack_tpu.extras import LUSolverLinOp as JLU
from randlapack_tpu.linops import CompositeLinOp as JComposite
from randlapack_tpu.linops import DenseLinOp as JDense

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import interop
from randlapack_tpu_torch.drivers import ABRIKConfig, abrik
from randlapack_tpu_torch.extras import (CholSolverLinOp, LUSolverLinOp,
                                         mm_read, mm_write)
from randlapack_tpu_torch.extras import io as tio
from randlapack_tpu_torch.linops import CompositeLinOp, DenseLinOp

SOLVE_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spd_coo(n=60, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    K = A @ A.T + n * np.eye(n)
    rows, cols = np.nonzero(K)
    return rows, cols, K[rows, cols], K


def _spd_sparse(n, seed=0):
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=0.05, random_state=rng)
    return (M @ M.T + sp.eye(n) * n).tocoo(), rng


def _general(n=50, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    A += np.diag(5.0 + rng.random(n))
    rows, cols = np.nonzero(A)
    return rows, cols, A[rows, cols], A, rng


def _close(x, ref, tol=SOLVE_TOL):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    ref = np.asarray(ref)
    assert x.shape == ref.shape
    np.testing.assert_allclose(x, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _abrik_v0(n, b, seed):
    key, _ = JRNG(seed).spawn()
    return torch.tensor(np.asarray(jax.random.normal(key, (n, b),
                                                     dtype=jnp.float64)))


# -- solver operators ----------------------------------------------------------

@pytest.mark.parametrize("device_solves", [True, False])
def test_chol_solver(device_solves):
    rows, cols, vals, K = _spd_coo()
    op = CholSolverLinOp(rows, cols, vals, 60, torch.float64,
                         device_solves=device_solves, device="cpu")
    jop = JChol(rows, cols, vals, 60, jnp.float64,
                device_solves=device_solves)
    B = np.random.default_rng(1).standard_normal((60, 3))
    X = op.matmat(torch.tensor(B))
    assert X.dtype == torch.float64 and X.device.type == "cpu"
    np.testing.assert_allclose(K @ X.numpy(), B, atol=1e-9)
    _close(X, jop.matmat(jnp.asarray(B)))
    _close(op.tmatmat(torch.tensor(B)), jop.tmatmat(jnp.asarray(B)))
    assert (op.n_rows, op.n_cols, op.dim, op.dtype) == (60, 60, 60,
                                                        torch.float64)
    with pytest.raises(NotImplementedError):
        op.fro_nrm()


@pytest.mark.parametrize("device_solves", [True, False])
def test_half_solve(device_solves):
    """tests/test_extras_utils.py:36: the exposed factor L̃ = Pᵀ·L_c has
    L̃·L̃ᵀ = K, the solve inverts it and whitens K; and the same X as the
    JAX operator (one factorization)."""
    rows, cols, vals, K = _spd_coo(40, 2)
    op = CholSolverLinOp(rows, cols, vals, 40, torch.float64, half=True,
                         device_solves=device_solves, device="cpu")
    jop = JChol(rows, cols, vals, 40, jnp.float64, half=True,
                device_solves=device_solves)
    Lt = op.factors.L.toarray()[op.factors.perm_r]
    np.testing.assert_allclose(Lt @ Lt.T, K, atol=1e-9)
    B = np.random.default_rng(2).standard_normal((40, 2))
    X = op.matmat(torch.tensor(B)).numpy()
    np.testing.assert_allclose(Lt @ X, B, atol=1e-9)
    _close(X, jop.matmat(jnp.asarray(B)))
    W = op.matmat(torch.tensor(K)).numpy() @ np.linalg.inv(Lt).T
    np.testing.assert_allclose(W, np.eye(40), atol=1e-8)


def test_half_solve_tmatmat_is_the_half_solve():
    """Like the JAX package's, the half operator's ``tmatmat`` is its
    ``matmat`` (L̃⁻¹, not L̃⁻ᵀ): ROADMAP.md §3 lists it."""
    rows, cols, vals, _ = _spd_coo(40, 2)
    op = CholSolverLinOp(rows, cols, vals, 40, torch.float64, half=True,
                         device="cpu")
    jop = JChol(rows, cols, vals, 40, jnp.float64, half=True)
    B = np.random.default_rng(3).standard_normal((40, 2))
    _close(op.tmatmat(torch.tensor(B)), op.matmat(torch.tensor(B)), 0.0)
    _close(op.tmatmat(torch.tensor(B)), jop.tmatmat(jnp.asarray(B)))


def test_half_solve_large_n_host():
    """tests/test_extras_utils.py:55: any n (5000, host solves)."""
    n = 5000
    rng = np.random.default_rng(5)
    diag = 4.0 + rng.random(n)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([diag, -np.ones(n - 1), -np.ones(n - 1)])
    op = CholSolverLinOp(rows, cols, vals, n, torch.float64, half=True,
                         device_solves=False, device="cpu")
    B = rng.standard_normal((n, 2))
    X = op.matmat(torch.tensor(B)).numpy()
    Lt_X = (op.factors.L @ X)[op.factors.perm_r]
    np.testing.assert_allclose(Lt_X, B, atol=1e-9)


def test_half_solve_rejects_indefinite():
    rows, cols, vals, K = _spd_coo(30, 4)
    K2 = K - 2 * np.abs(K).max() * np.eye(30)
    r, c = np.nonzero(K2)
    with pytest.raises(ValueError):
        CholSolverLinOp(r, c, K2[r, c], 30, torch.float64, half=True,
                        device="cpu")


@pytest.mark.parametrize("device_solves", [True, False])
def test_lu_solver_and_transpose(device_solves):
    rows, cols, vals, A, rng = _general()
    op = LUSolverLinOp(rows, cols, vals, 50, torch.float64,
                       device_solves=device_solves, device="cpu")
    jop = JLU(rows, cols, vals, 50, jnp.float64, device_solves=device_solves)
    B = rng.standard_normal((50, 2))
    X, Xt = op.matmat(torch.tensor(B)), op.tmatmat(torch.tensor(B))
    np.testing.assert_allclose(A @ X.numpy(), B, atol=1e-9)
    np.testing.assert_allclose(A.T @ Xt.numpy(), B, atol=1e-9)
    _close(X, jop.matmat(jnp.asarray(B)))
    _close(Xt, jop.tmatmat(jnp.asarray(B)))
    # a vector right-hand side, f32 tensors in and out
    x = op.matmat(torch.tensor(B[:, 0], dtype=torch.float32))
    assert x.dtype == torch.float32 and x.shape == (50,)
    np.testing.assert_allclose(x.numpy(), X[:, 0].numpy(), rtol=0,
                               atol=1e-5 * np.abs(X.numpy()).max())


@pytest.mark.parametrize("kind", ["chol", "lu"])
def test_device_solves_match_host(kind):
    """tests/test_extras_utils.py:166-203 (n 250)."""
    if kind == "chol":
        K, rng = _spd_sparse(250, 0)
        B = rng.standard_normal((250, 5))
        ops = [CholSolverLinOp(K.row, K.col, K.data, 250, torch.float64,
                               device_solves=d, device="cpu")
               for d in (True, False)]
        ref = spla.spsolve(K.tocsc(), B)
    else:
        rng = np.random.default_rng(1)
        K = (sp.random(250, 250, density=0.05, random_state=rng)
             + sp.eye(250) * 5).tocoo()
        B = rng.standard_normal((250, 4))
        ops = [LUSolverLinOp(K.row, K.col, K.data, 250, torch.float64,
                             device_solves=d, device="cpu")
               for d in (True, False)]
        ref = spla.spsolve(K.tocsc(), B)
        _close(ops[0].tmatmat(torch.tensor(B)),
               spla.spsolve(K.tocsc().T, B), 1e-10)
    for op in ops:
        _close(op.matmat(torch.tensor(B)), ref, 1e-10)


def test_composes_with_abrik():
    """tests/test_extras_utils.py:86: ABRIK over K⁻¹, against the JAX
    run on the same start and against 1/λ(K) at the JAX test's gate."""
    rows, cols, vals, K = _spd_coo(64, 4)
    op = CholSolverLinOp(rows, cols, vals, 64, torch.float64, device="cpu")
    jop = JChol(rows, cols, vals, 64, jnp.float64)
    cfg = dict(block_size=4, max_iters=8)
    _, jS, _, _, _ = j_abrik(jop, 4, JABRIKConfig(**cfg), JRNG(0))
    _, S, _, _, _ = abrik(op, 4, ABRIKConfig(**cfg), rt.RNGState(0),
                          v0=_abrik_v0(64, 4, 0))
    _close(S, jS, 1e-10)
    w = np.sort(np.linalg.eigvalsh(K))
    np.testing.assert_allclose(S.numpy(), 1.0 / w[:4], rtol=5e-3)


@pytest.mark.parametrize("order", ["solver-dense", "dense-solver"])
def test_composite_with_solver(order):
    """tests/test_extras_utils.py:226-266: CholSolver×Dense (matmat and
    the transpose apply) and Dense×CholSolver against dense oracles."""
    n, k = (120, 30) if order == "solver-dense" else (100, 40)
    K, rng = _spd_sparse(n, seed=0 if order == "solver-dense" else 1)
    inv_op = CholSolverLinOp(K.row, K.col, K.data, n, torch.float64,
                             device="cpu")
    Kinv = spla.spsolve(K.tocsc(), np.eye(n))
    if order == "solver-dense":
        D = rng.standard_normal((n, k))
        comp, ref = CompositeLinOp(inv_op, DenseLinOp(torch.tensor(D))), \
            Kinv @ D
        Y = rng.standard_normal((n, 3))
        _close(comp.tmatmat(torch.tensor(Y)), ref.T @ Y, 1e-10)
        X = rng.standard_normal((k, 4))
    else:
        D = rng.standard_normal((k, n))
        comp, ref = CompositeLinOp(DenseLinOp(torch.tensor(D)), inv_op), \
            D @ Kinv
        X = rng.standard_normal((n, 5))
    _close(comp.matmat(torch.tensor(X)), ref @ X, 1e-10)


def test_abrik_over_inverse_composite():
    """tests/test_extras_utils.py:268: top σ of K⁻¹·D through ABRIK over
    the composite, against the JAX run on the same start and the SVD."""
    n, k = 150, 60
    K, rng = _spd_sparse(n, seed=2)
    D = rng.standard_normal((n, k))
    comp = CompositeLinOp(CholSolverLinOp(K.row, K.col, K.data, n,
                                          torch.float64, device="cpu"),
                          DenseLinOp(torch.tensor(D)))
    jcomp = JComposite(JChol(K.row, K.col, K.data, n, jnp.float64),
                       JDense(jnp.asarray(D)))
    cfg = dict(block_size=6, max_iters=8)
    _, jS, _, _, _ = j_abrik(jcomp, 6, JABRIKConfig(**cfg), JRNG(3))
    _, S, _, _, _ = abrik(comp, 6, ABRIKConfig(**cfg), rt.RNGState(3),
                          v0=_abrik_v0(k, 6, 3))
    _close(S, jS, 1e-10)
    s_ref = np.linalg.svd(spla.spsolve(K.tocsc(), D), compute_uv=False)[:6]
    np.testing.assert_allclose(S.numpy(), s_ref, rtol=1e-3)


@pytest.mark.parametrize("kind", ["chol", "half", "lu"])
def test_interop_factor_round_trip(kind):
    """The JAX operator's own SuperLU factors cross through numpy into a
    port operator (no factorization), and the port's factors back out."""
    if kind == "lu":
        rows, cols, vals, _, rng = _general()
        n = 50
        jop = JLU(rows, cols, vals, n, jnp.float64)
        arrays = interop.splu_factors_to_numpy(jop._lu)
    else:
        rows, cols, vals, _ = _spd_coo(60, 6)
        n, rng = 60, np.random.default_rng(6)
        jop = JChol(rows, cols, vals, n, jnp.float64, half=kind == "half")
        if kind == "half":
            Lc = jop._Lc.tocoo()
            arrays = {"L": (Lc.row, Lc.col, Lc.data),
                      "perm_r": jop._perm_r}
        else:
            arrays = interop.splu_factors_to_numpy(jop._lu)
    B = rng.standard_normal((n, 3))
    for device_solves in (True, False):
        op = interop.solver_linop_from_numpy(arrays, n, torch.float64,
                                             device_solves, lu=kind == "lu",
                                             device="cpu")
        _close(op.matmat(torch.tensor(B)), jop.matmat(jnp.asarray(B)))
        if kind == "lu":
            _close(op.tmatmat(torch.tensor(B)), jop.tmatmat(jnp.asarray(B)))
        back = interop.solver_factors_to_numpy(op)
        assert set(back) == set(arrays)
        for key, val in arrays.items():
            if key.startswith("perm"):
                np.testing.assert_array_equal(back[key], val)
            else:
                dense = [sp.coo_matrix((v, (r, c)), shape=(n, n)).toarray()
                         for r, c, v in (val, back[key])]
                np.testing.assert_array_equal(dense[1], dense[0])


def test_packed_factor_sizes():
    """Each device factor is packed once: padded-CSR width L (the widest
    row) and its bytes, as chip_smoke.py reports them."""
    rows, cols, vals, A, _ = _general()
    op = LUSolverLinOp(rows, cols, vals, 50, torch.float64, device="cpu")
    for name in ("L", "U"):
        P = op.packed(name)
        M = getattr(op.factors, name)
        assert P.width == np.diff(M.tocsr().indptr).max()
        assert P.nbytes == sum(t.numel() * t.element_size()
                               for t in (P.cols, P.vals, P.diag))


# -- Matrix Market IO ----------------------------------------------------------

def _native_or_skip():
    if tio.native_module() is None:
        pytest.skip("no C++ compiler here: the native reader cannot build")


@pytest.mark.parametrize("route", ["native", "scipy"])
def test_mm_round_trip(route, tmp_path, monkeypatch):
    """tests/test_extras_utils.py:100 on each route: write, read back as
    COO and dense, ``ROUTES`` counting the route each call took; the
    other route reads the file the same (f64 values exact)."""
    if route == "native":
        _native_or_skip()
        monkeypatch.setattr(tio, "PREFER_NATIVE", True)
    else:
        monkeypatch.setattr(tio, "native_module", lambda: None)
    rows, cols, vals, K = _spd_coo(30, 5)
    p = str(tmp_path / "k.mtx")
    before = dict(tio.ROUTES)
    mm_write(p, rows, cols, vals, K.shape)
    r2, c2, v2, shape = mm_read(p)
    D = np.zeros(shape)
    np.add.at(D, (r2, c2), v2)
    np.testing.assert_allclose(D, K, atol=1e-12)
    np.testing.assert_allclose(mm_read(p, dense=True), K, atol=1e-12)
    assert tio.ROUTES[f"write_{route}"] == before[f"write_{route}"] + 1
    assert tio.ROUTES[f"read_{route}"] == before[f"read_{route}"] + 2
    r3, c3, v3, shape3 = tio._read_scipy(p, False)
    assert shape3 == shape
    order, order3 = np.lexsort((c2, r2)), np.lexsort((c3, r3))
    np.testing.assert_array_equal(r2[order], r3[order3])
    np.testing.assert_array_equal(c2[order], c3[order3])
    np.testing.assert_array_equal(v2[order], v3[order3])


def test_mm_native_matches_jax_scipy_route(tmp_path, monkeypatch):
    """The native reader on the JAX package's scipy-written file (general
    and symmetric) gives the JAX reader's arrays; symmetric writes stay on
    scipy."""
    _native_or_skip()
    monkeypatch.setattr(tio, "PREFER_NATIVE", True)
    from randlapack_tpu.extras import io as jio
    rows, cols, vals, K = _spd_coo(25, 7)
    for symmetric in (False, True):
        p = str(tmp_path / f"s{int(symmetric)}.mtx")
        if symmetric:
            lo = rows >= cols
            before = tio.ROUTES["write_scipy"]
            mm_write(p, rows[lo], cols[lo], vals[lo], K.shape, symmetric=True)
            assert tio.ROUTES["write_scipy"] == before + 1
        else:
            jio.mm_write(p, rows, cols, vals, K.shape)
        np.testing.assert_allclose(mm_read(p, dense=True),
                                   jio.mm_read(p, dense=True), rtol=0,
                                   atol=1e-15)


@pytest.mark.parametrize("version,native_first", [("1.11.4", True),
                                                   ("1.12.0", False),
                                                   ("1.17.0", False)])
def test_mm_default_route_follows_scipy(version, native_first, tmp_path,
                                        monkeypatch):
    """With no override, the native route goes first only where scipy
    predates its C++ reader (1.12); a missing native module falls back to
    scipy either way."""
    import scipy
    monkeypatch.setattr(scipy, "__version__", version)
    assert tio.prefer_native() is native_first
    fake = type("Native", (), {"fast_mm_read": staticmethod(
        lambda path: (_ for _ in ()).throw(ValueError(path)))})
    monkeypatch.setattr(tio, "native_module", lambda: fake)
    rows, cols, vals, K = _spd_coo(12, 3)
    p = str(tmp_path / "d.mtx")
    before = dict(tio.ROUTES)
    if native_first:   # the stand-in refuses every file: scipy reads it
        monkeypatch.setattr(tio, "native_module", lambda: None)
    mm_write(p, rows, cols, vals, K.shape)
    monkeypatch.setattr(tio, "native_module", lambda: fake)
    np.testing.assert_allclose(mm_read(p, dense=True), K, atol=1e-12)
    assert tio.ROUTES["write_scipy"] == before["write_scipy"] + 1
    assert tio.ROUTES["read_scipy"] == before["read_scipy"] + 1
    assert tio.ROUTES["read_native"] == before["read_native"]


def test_mm_array_file_falls_back_to_scipy(tmp_path, monkeypatch):
    monkeypatch.setattr(tio, "PREFER_NATIVE", True)
    import scipy.io as sio
    A = np.random.default_rng(8).standard_normal((5, 4))
    p = str(tmp_path / "dense.mtx")
    sio.mmwrite(p, A)
    before = tio.ROUTES["read_scipy"]
    np.testing.assert_allclose(mm_read(p, dense=True), A, rtol=1e-15)
    r, c, v, shape = mm_read(p)
    assert shape == (5, 4) and tio.ROUTES["read_scipy"] == before + 2


def test_native_library_lives_in_build_native():
    _native_or_skip()
    from randlapack_tpu_torch import _build
    lib = _build.build_native()
    assert lib.parent == _build.NATIVE_DIR and lib.exists()
    assert _build.NATIVE_DIR.parts[-2:] == ("build", "native")


def test_lu_from_mm(tmp_path):
    rows, cols, vals, A, rng = _general(40, 9)
    p = str(tmp_path / "a.mtx")
    mm_write(p, rows, cols, vals, A.shape)
    op = LUSolverLinOp.from_mm(p, torch.float64, device="cpu")
    B = rng.standard_normal((40, 2))
    np.testing.assert_allclose(A @ op.matmat(torch.tensor(B)).numpy(), B,
                               atol=1e-9)
    assert os.path.getsize(p) > 0


def test_native_names_round_trip_against_scipy(tmp_path):
    """``randlapack_tpu_torch.native`` exports the JAX package's three
    names, builds nothing on import (the build runs on first use, into
    ``build/native/``), and a small COO matrix written by
    ``fast_mm_write`` reads back through ``scipy.io.mmread``, and a file
    ``scipy.io.mmwrite`` wrote reads back through ``fast_mm_read``,
    value for value."""
    import subprocess
    import sys

    import scipy.io as sio
    code = ("import randlapack_tpu_torch._build as b; "
            "b.load_native = None; "
            "import randlapack_tpu_torch.native as nat; "
            "from randlapack_tpu_torch.extras import io; "
            "print(sorted(nat.__all__), io._native == [])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__)))).stdout.strip()
    assert out == "['HAVE_NATIVE', 'fast_mm_read', 'fast_mm_write'] True"
    import randlapack_tpu_torch.native as nat
    assert nat.HAVE_NATIVE is True
    rows = np.array([0, 2, 4, 1], np.int32)
    cols = np.array([1, 0, 3, 3], np.int32)
    vals = np.array([1.5, -2.25, 1e-300, np.pi])
    path = tmp_path / "a.mtx"
    nat.fast_mm_write(str(path), rows, cols, vals, 5, 4)
    M = sio.mmread(str(path)).tocoo()
    assert M.shape == (5, 4)
    assert sorted(zip(M.row, M.col, M.data)) == sorted(zip(rows, cols, vals))
    path2 = tmp_path / "b.mtx"
    sio.mmwrite(str(path2), sp.coo_matrix((vals, (rows, cols)),
                                          shape=(5, 4)))
    r, c, v, m, n = nat.fast_mm_read(str(path2))
    assert (m, n) == (5, 4)
    assert sorted(zip(r, c, v)) == sorted(zip(rows, cols, vals))
