"""The port's sketching layer, its tall-QR building blocks (``gram_syrk``,
the blocked-inverse trsm) and the pivot utilities against the JAX
package on the CPU in f64. The operators are drawn by JAX (the two
packages' random streams differ by design) and carried across through
``interop``, so both packages apply the same draw; operators the port
draws itself are held to their structure (distinct rows per column,
values ±1).

Tolerances: sketches 1e-12 of the largest entry (the same ±1 sums in
another order: MKL's or PyTorch's against XLA's CPU loops); the Gram
from its upper blocks within 1e-13 of the full product; the trsm 1e-12
against JAX's."""
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.sketching import SparseDist as JSparseDist
from randlapack_tpu.sketching import SparseSkOp as JSparseSkOp
from randlapack_tpu.sketching import fill_sparse as j_fill_sparse
from randlapack_tpu.sketching import srht_skop as j_srht_skop

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import interop
from randlapack_tpu_torch import sketching as tsk

jsp = importlib.import_module("randlapack_tpu.sketching.sparse_ops")
jsrht = importlib.import_module("randlapack_tpu.sketching.srht")
jchol = importlib.import_module("randlapack_tpu.ops.cholqr")
jtrsm = importlib.import_module("randlapack_tpu.ops.trsm")
jutil = importlib.import_module("randlapack_tpu.ops.util")
tsp = importlib.import_module("randlapack_tpu_torch.sketching.sparse_ops")
tchol = importlib.import_module("randlapack_tpu_torch.ops.cholqr")
ttrsm = importlib.import_module("randlapack_tpu_torch.ops.trsm")
tutil = importlib.import_module("randlapack_tpu_torch.ops.util")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HI = jax.lax.Precision.HIGHEST


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _mat(m, n, seed):
    return np.random.default_rng(seed).standard_normal((m, n))


def _saso(d, m, nnz, seed):
    """A SASO drawn by JAX, and the same operator in the port."""
    op, _ = j_fill_sparse(JSparseDist(d, m, nnz), JRNG(seed),
                          dtype=jnp.float64)
    dist = dict(n_rows=d, n_cols=m, vec_nnz=nnz)
    return op, interop.saso_from_numpy(dist, op.rows, op.vals, device="cpu")


# -- fwht and the SRHT --------------------------------------------------------

def _fwht_butterfly(x):
    """The Walsh-Hadamard transform by log2(m) butterfly passes (numpy):
    an algorithm of its own, against the radix-128 products."""
    x = np.array(x, dtype=np.float64)
    m, h = x.shape[0], 1
    while h < m:
        x = x.reshape(m // (2 * h), 2, h, *x.shape[1:])
        x = np.concatenate([x[:, :1] + x[:, 1:], x[:, :1] - x[:, 1:]], 1)
        x = x.reshape(m, *x.shape[3:])
        h *= 2
    return x


# 256 is two stages (128, then a tail of 2), 2^14 two full ones, 2^15
# three (128, 128, 2), as 131072 is (128, 128, 8)
@pytest.mark.parametrize("m", [1, 8, 256, 2 ** 14, 2 ** 15])
@pytest.mark.parametrize("vector", [True, False])
def test_fwht_matches_jax(m, vector):
    x = _mat(m, 3, m)
    if vector:
        x = x[:, 0]
    out = tsk.fwht(torch.tensor(x))
    assert tuple(out.shape) == x.shape
    assert _rel(out, jsrht.fwht(jnp.asarray(x))) <= 1e-12
    assert _rel(out, _fwht_butterfly(x)) <= 1e-12


def test_fwht_is_the_sylvester_hadamard_matrix():
    for m in (2, 512, 2048):
        x = torch.tensor(_mat(m, 2, 1))
        H = tsk.srht._hadamard_matrix(m, torch.float64, "cpu")
        assert torch.equal(H @ H.T, m * torch.eye(m, dtype=torch.float64))
        assert _rel(tsk.fwht(x), H @ x) <= 1e-12
    with pytest.raises(AssertionError):
        tsk.fwht(torch.zeros(12, 2, dtype=torch.float64))


@pytest.mark.parametrize("m,n,d", [(1024, 20, 50), (1000, 17, 64),
                                   (129, 5, 9)])
def test_srht_left_apply_matches_jax(m, n, d):
    A = _mat(m, n, m + d)
    op, _ = j_srht_skop(d, m, JRNG(d), dtype=jnp.float64)
    top = interop.srht_from_numpy(d, m, op.signs, op.rows, device="cpu")
    assert top.m_pad == op.m_pad == 1 << (m - 1).bit_length()
    out = tsk.srht_left_apply(top, torch.tensor(A))
    assert tuple(out.shape) == (d, n)
    assert _rel(out, jsrht.srht_left_apply(op, jnp.asarray(A))) <= 1e-12
    back = interop.srht_to_numpy(top)
    assert back[:2] == (d, m)
    np.testing.assert_array_equal(back[2], np.asarray(op.signs))
    np.testing.assert_array_equal(back[3], np.asarray(op.rows))


def test_srht_skop_drawn_by_the_port():
    op, st = tsk.srht_skop(40, 1000, rt.RNGState(3), dtype=torch.float64,
                           device="cpu")
    assert st.counter == 2
    assert set(op.signs.tolist()) == {-1.0, 1.0}
    assert op.signs.shape == (1000,) and op.rows.shape == (40,)
    assert 0 <= int(op.rows.min()) and int(op.rows.max()) < 1024
    again, _ = tsk.srht_skop(40, 1000, rt.RNGState(3), dtype=torch.float64,
                             device="cpu")
    assert torch.equal(op.signs, again.signs)
    assert torch.equal(op.rows, again.rows)
    # E[SᵀS] = I: a sketch of 512 rows keeps a vector's norm to ~10 %
    x = torch.tensor(_mat(1000, 1, 4))
    big, _ = tsk.srht_skop(512, 1000, rt.RNGState(5), dtype=torch.float64,
                           device="cpu")
    ratio = float(torch.linalg.norm(tsk.srht_left_apply(big, x))
                  / torch.linalg.norm(x))
    assert 0.8 < ratio < 1.2


# -- SASO -----------------------------------------------------------------------

@pytest.mark.parametrize("method", ["scatter", "gather", "auto"])
@pytest.mark.parametrize("d,m,n,nnz", [(60, 800, 7, 2), (25, 400, 3, 4),
                                       (40, 300, 5, 1)])
def test_saso_left_apply_matches_jax(method, d, m, n, nnz):
    A = _mat(m, n, d + nnz)
    jop, top = _saso(d, m, nnz, d * nnz)
    ref = jsp.saso_left_apply(jop, jnp.asarray(A), method=method)
    out = tsk.saso_left_apply(top, torch.tensor(A), method=method)
    assert _rel(out, ref) <= 1e-12
    unscaled = tsk.saso_left_apply(top, torch.tensor(A), scale=False,
                                   method=method)
    assert _rel(unscaled * top.dist.isometry_scale, out) <= 1e-15
    assert _rel(out, tsk.saso_to_dense(top) @ torch.tensor(A)) <= 1e-12


@pytest.mark.parametrize("l_over", [4096, 105, 104])
def test_saso_gather_overflow_matches_jax(l_over):
    # rows 0 and 1 hold ~100 entries each against a pad bound L of 48:
    # 105 entries overflow. The overflow buffer takes them (l_over 4096,
    # and 105 exactly); one buffer slot short (104), the scatter form
    # computes the result, in both packages
    d, m, n, nnz = 30, 200, 4, 2
    rng = np.random.default_rng(7)
    rows = np.stack([np.where(rng.random(m) < 0.5, 0, rng.integers(0, d, m)),
                     np.where(rng.random(m) < 0.5, 1, rng.integers(0, d, m))])
    vals = rng.choice([-1.0, 1.0], size=(nnz, m))
    jop = JSparseSkOp(JSparseDist(d, m, nnz), jnp.asarray(rows, jnp.int32),
                      jnp.asarray(vals))
    top = interop.saso_from_numpy(dict(n_rows=d, n_cols=m, vec_nnz=nnz),
                                  rows, vals, device="cpu")
    A = _mat(m, n, 8)
    ref = jsp._saso_left_gather(jop, jnp.asarray(A), d, m, n, l_over=l_over)
    out = tsp._saso_left_gather(top, torch.tensor(A), d, m, n,
                                l_over=l_over)
    assert _rel(out, ref) <= 1e-12
    exact = tsp._saso_left_scatter(top, torch.tensor(A), d, n)
    assert _rel(out, exact) <= 1e-12


def test_saso_right_apply_and_to_dense_match_jax():
    m, d, n, nnz = 500, 40, 6, 3
    op, _ = j_fill_sparse(JSparseDist(m, d, nnz), JRNG(11),
                          dtype=jnp.float64)   # tall m×d
    top = interop.saso_from_numpy(dict(n_rows=m, n_cols=d, vec_nnz=nnz),
                                  op.rows, op.vals, device="cpu")
    A = _mat(n, m, 12)
    out = tsk.saso_right_apply(torch.tensor(A), top)
    assert tuple(out.shape) == (n, d)
    assert _rel(out, jsp.saso_right_apply(jnp.asarray(A), op)) <= 1e-12
    dense = tsk.saso_to_dense(top)
    assert tuple(dense.shape) == (m, d)
    np.testing.assert_array_equal(dense.numpy(),
                                  np.asarray(jsp.saso_to_dense(op)))
    assert _rel(out, torch.tensor(A) @ dense) <= 1e-12
    wide_j, wide_t = _saso(30, 300, 2, 13)
    np.testing.assert_array_equal(
        tsk.saso_to_dense(wide_t, scale=False).numpy(),
        np.asarray(jsp.saso_to_dense(wide_j, scale=False)))
    dist, rows, vals = interop.saso_to_numpy(wide_t)
    assert dist == dict(n_rows=30, n_cols=300, vec_nnz=2)
    np.testing.assert_array_equal(rows, np.asarray(wide_j.rows))
    np.testing.assert_array_equal(vals, np.asarray(wide_j.vals))


@pytest.mark.parametrize("nnz,distinct", [(3, True), (1, True), (2, False)])
def test_fill_sparse_drawn_by_the_port(nnz, distinct):
    d, m = 12, 700
    op, st = tsk.fill_sparse(tsk.SparseDist(d, m, nnz), rt.RNGState(4),
                             dtype=torch.float64, distinct=distinct,
                             device="cpu")
    assert st.counter == 2   # as the JAX package: one draw each
    assert op.rows.shape == op.vals.shape == (nnz, m)
    assert set(op.vals.unique().tolist()) == {-1.0, 1.0}
    assert 0 <= int(op.rows.min()) and int(op.rows.max()) < d
    if distinct:
        assert all(len(set(c)) == nnz for c in op.rows.T.tolist())
    dense = tsk.saso_to_dense(op, scale=False)
    assert float(dense.abs().sum()) <= nnz * m


def test_sample_distinct_uniform_in_chunks():
    idx, st = tsk.sample_distinct_uniform(9, 4, 50, rt.RNGState(2), chunk=8,
                                          device="cpu")
    assert st.counter == 1 and idx.shape == (50, 4)
    assert all(len(set(r)) == 4 for r in idx.tolist())
    assert 0 <= int(idx.min()) and int(idx.max()) < 9
    # every position is drawn: the chunks are independent draws
    assert len(set(idx.flatten().tolist())) == 9
    one, _ = tsk.sample_distinct_uniform(9, 4, 50, rt.RNGState(2), chunk=8,
                                         device="cpu")
    assert torch.equal(idx, one)
    u, st = tsk.sample_indices_iid_uniform(5, 300, rt.RNGState(1),
                                           device="cpu")
    assert st.counter == 1 and u.shape == (300,)
    assert set(u.tolist()) == set(range(5))


# -- gram_syrk, the blocked-inverse trsm, pivot utilities ------------------------

@pytest.mark.parametrize("n,block", [(96, 32), (128, 64), (100, 32),
                                     (64, 64)])
def test_gram_syrk_matches_the_full_gram(n, block):
    A = torch.tensor(_mat(300, n, n))
    G = tchol.gram_syrk(A, block=block)
    if n % block == 0 and n // block >= 2:
        # the blocked path mirrors its upper blocks: EXACTLY symmetric
        assert torch.equal(G, G.T)
    else:
        # the fallback is one full GEMM, symmetric only to rounding (as
        # in the JAX package's own test, tests/test_ops.py)
        assert float(torch.linalg.norm(G - G.T)
                     / torch.linalg.norm(G)) <= 1e-15
    assert _rel(G, A.T @ A) <= 1e-13
    assert _rel(G, jchol.gram_syrk(jnp.asarray(A.numpy()), HI, block)) \
        <= 1e-13


@pytest.mark.parametrize("n,block", [(96, 32), (128, 64), (100, 32),
                                     (64, 64)])
@pytest.mark.parametrize("gather", [False, True])
def test_trsm_blockinv_matches_jax(n, block, gather):
    rng = np.random.default_rng(n + block)
    A = rng.standard_normal((250, n))
    R = np.triu(rng.standard_normal((n, n))) + np.diag(3.0 + rng.random(n))
    cols = rng.permutation(n) if gather else None
    ref = jtrsm.trsm_right_upper_blockinv(
        jnp.asarray(A), jnp.asarray(R), block, HI,
        cols=None if cols is None else jnp.asarray(cols))
    X = ttrsm.trsm_right_upper_blockinv(
        torch.tensor(A), torch.tensor(R), block,
        cols=None if cols is None else torch.tensor(cols))
    assert _rel(X, ref) <= 1e-12
    AJ = A if cols is None else A[:, cols]
    assert _rel(X.numpy() @ R, AJ) <= 1e-12


def test_precision_other_than_highest_raises():
    # "default" and "high" were refused until the driver-level precision
    # was ported: on the CPU they are the "highest" products, bit for bit,
    # and a name JAX does not take raises
    A = torch.tensor(np.random.default_rng(0).standard_normal((4, 4)))
    R = torch.triu(A) + 4 * torch.eye(4, dtype=torch.float64)
    for call in (lambda p: tchol.gram_syrk(A, p, 2),
                 lambda p: ttrsm.trsm_right_upper_blockinv(A, R, 2, p),
                 lambda p: tsk.fwht(A, p)):
        for p in ("default", "high"):
            assert torch.equal(call(p), call("highest"))
        with pytest.raises(ValueError):
            call("medium")


def test_pivot_utilities_match_jax():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((20, 9))
    J1, J2 = rng.permutation(9), rng.permutation(9)
    tJ1, tJ2 = torch.tensor(J1), torch.tensor(J2)
    np.testing.assert_array_equal(tutil.col_swap(torch.tensor(A), tJ1),
                                  np.asarray(jutil.col_swap(A, J1)))
    np.testing.assert_array_equal(tutil.compose_pivots(tJ1, tJ2),
                                  np.asarray(jutil.compose_pivots(J1, J2)))
    inv = tutil.invert_pivots(tJ1)
    np.testing.assert_array_equal(inv, np.asarray(jutil.invert_pivots(
        jnp.asarray(J1))))
    np.testing.assert_array_equal(tJ1[inv], np.arange(9))
    Q = np.linalg.qr(A)[0] * np.linspace(1.0, 1.001, 9)
    assert abs(float(tutil.orthogonality_check(torch.tensor(Q)))
               - float(jutil.orthogonality_check(jnp.asarray(Q)))) <= 1e-15


def test_sketching_modules_import_with_jax_blocked():
    """The whole package is scanned for JAX imports by
    test_torch_ops.py; this holds each module of the tall-QR slice to it
    with ``jax`` made unimportable."""
    mods = ["randlapack_tpu_torch.sketching.sparse_ops",
            "randlapack_tpu_torch.sketching.srht",
            "randlapack_tpu_torch.sketching.sampling",
            "randlapack_tpu_torch.ops.trsm", "randlapack_tpu_torch.ops.util",
            "randlapack_tpu_torch.ops.cholqr",
            "randlapack_tpu_torch.drivers.bqrrp",
            "randlapack_tpu_torch.drivers.cqrrpt",
            "randlapack_tpu_torch.drivers.cqrrt",
            "randlapack_tpu_torch.interop"]
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['randlapack_tpu'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_saso_rejects_a_mismatched_operand():
    _, top = _saso(10, 100, 2, 1)
    with pytest.raises(AssertionError):
        tsk.saso_left_apply(top, torch.zeros(99, 3, dtype=torch.float64))
    with pytest.raises(AttributeError):
        tsk.SparseDist(10, 100, 2).n_rows = 3   # frozen
