"""The port's operator layer (randlapack_tpu_torch: linops' dense, sparse
and composite operators and their views, the CSR/CSC views, sketching's
sparse formats, the dense sketches and sided application) against the
JAX package's on the CPU in f64. Both packages build their operators
from the same numpy arrays; the sketching operators are drawn by JAX and
carried across through ``interop``.

Tolerances: the operator battery within 1e-13 of the largest entry of
the JAX result (the same products in another summation order); the
sparse format conversions and the views' materialization exactly; the
sparse products (spmm, spgemm) and the sparse triangular solve within
1e-12; the sketches within 1e-13; ``fro_nrm`` of a sparse operator with
duplicate COO entries within 2 ulps of the JAX value (the norm of the
same stored values, summed in another order), and not ‖A‖_F.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen
from randlapack_tpu.linops import CompositeLinOp as JComposite
from randlapack_tpu.linops import DenseLinOp as JDense
from randlapack_tpu.linops import SparseLinOp as JSparse
from randlapack_tpu.linops import materialize as j_materialize
from randlapack_tpu.linops import sparse_views as jviews
from randlapack_tpu.sketching import DenseDist as JDenseDist
from randlapack_tpu.sketching import ScalarDist as JScalarDist
from randlapack_tpu.sketching import SparseDist as JSparseDist
from randlapack_tpu.sketching import dense_skop as j_dense_skop
from randlapack_tpu.sketching import fill_sparse as j_fill_sparse
from randlapack_tpu.sketching import sketch_left as j_sketch_left
from randlapack_tpu.sketching import sketch_right as j_sketch_right
from randlapack_tpu.sketching import sparse_data as jsd
from randlapack_tpu.sketching import srht_skop as j_srht_skop

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import interop
from randlapack_tpu_torch import linops as tl
from randlapack_tpu_torch import sketching as tsk
from randlapack_tpu_torch.linops import sparse_views as tviews
from randlapack_tpu_torch.sketching import sparse_data as tsd

M, N, K, S = 40, 28, 16, 5
OP_REL = 1e-13
SP_REL = 1e-12


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to_dense().numpy() if x.is_sparse or x.layout in (
            torch.sparse_csr, torch.sparse_csc) else x.numpy()
    return np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(x):
    return torch.tensor(np.asarray(x))


# -- the operator battery (tests/test_linops.py's tags) -----------------------

def _dense(seed, shape):
    return np.asarray(mat_gen(MatGenInfo(*shape, MatType.gaussian),
                              JRNG(seed))[0])


def _sparse(seed, shape, density=0.2):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < density
    vals = rng.standard_normal(shape) * mask
    rows, cols = np.nonzero(mask)
    return (JSparse.from_coo(rows, cols, vals[mask], shape),
            tl.SparseLinOp.from_coo(rows, cols, vals[mask], shape,
                                    device="cpu"))


def _dense_pair(seed, shape):
    A = _dense(seed, shape)
    return JDense(jnp.asarray(A)), tl.DenseLinOp(_t(A))


def make_pair(tag, seed=0):
    """The same operator in both packages."""
    if tag == "dense":
        return _dense_pair(seed, (M, N))
    if tag == "sparse":
        return _sparse(seed, (M, N))
    if tag == "composite_dd":
        (ja, ta), (jb, tb) = _dense_pair(seed, (M, K)), \
            _dense_pair(seed + 1, (K, N))
    elif tag == "composite_ds":
        (ja, ta), (jb, tb) = _dense_pair(seed, (M, K)), \
            _sparse(seed + 2, (K, N))
    elif tag == "composite_sd":
        (ja, ta), (jb, tb) = _sparse(seed + 3, (M, K)), \
            _dense_pair(seed + 4, (K, N))
    elif tag == "composite_nested":
        (ja, ta) = _dense_pair(seed, (M, K))
        (jb1, tb1), (jb2, tb2) = _dense_pair(seed + 1, (K, K)), \
            _dense_pair(seed + 2, (K, N))
        jb, tb = JComposite(jb1, jb2), tl.CompositeLinOp(tb1, tb2)
    else:
        raise ValueError(tag)
    return JComposite(ja, jb), tl.CompositeLinOp(ta, tb)


TAGS = ["dense", "sparse", "composite_dd", "composite_ds", "composite_sd",
        "composite_nested"]

X_MAT = _dense(90, (N, S))
X_T = _dense(91, (M, S))
X_R = _dense(92, (S, M))
X_BLK = _dense(93, (N, S))
X_COL = _dense(94, (16, S))
X_SUB = _dense(95, (12, S))

METHODS = {
    "matmat": lambda op, X: op.matmat(X(X_MAT)),
    "tmatmat": lambda op, X: op.tmatmat(X(X_T)),
    "rmatmat": lambda op, X: op.rmatmat(X(X_R)),
    "fro_nrm": lambda op, X: op.fro_nrm(),
    "cols": lambda op, X: op.cols(6, 8),
    "row_block": lambda op, X: op.row_block(8, 24).matmat(X(X_BLK)),
    "col_block": lambda op, X: op.col_block(4, 20).matmat(X(X_COL)),
    "submatrix": None,            # per package: base.submatrix
    "materialize": None,          # per package: base.materialize
}


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("tag", TAGS)
def test_operator_battery(tag, method):
    jop, top = make_pair(tag)
    if method == "submatrix":
        from randlapack_tpu.linops import submatrix as j_submatrix
        got = tl.submatrix(top, 8, 24, 4, 16).matmat(_t(X_SUB))
        ref = j_submatrix(jop, 8, 24, 4, 16).matmat(jnp.asarray(X_SUB))
    elif method == "materialize":
        got, ref = tl.materialize(top), j_materialize(jop)
    else:
        got = METHODS[method](top, _t)
        ref = METHODS[method](jop, jnp.asarray)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert _rel(got, ref) <= OP_REL


@pytest.mark.parametrize("tag", TAGS)
def test_operator_shapes_and_transpose(tag):
    jop, top = make_pair(tag)
    assert (top.n_rows, top.n_cols) == (jop.n_rows, jop.n_cols)
    assert top.dtype == torch.float64 and top.device.type == "cpu"
    if tag == "dense":
        assert _rel(top.T().matmat(_t(X_T)),
                    jop.T().matmat(jnp.asarray(X_T))) <= OP_REL


# -- the sparse operator's own properties -------------------------------------

def test_sparse_fro_nrm_keeps_duplicate_entries_apart():
    """The norm of the stored values, as the JAX package takes it: with
    duplicate (row, col) entries that is not ‖A‖_F (ROADMAP.md §3)."""
    rows = np.array([0, 2, 2, 5, 0, 3])
    cols = np.array([1, 3, 3, 0, 1, 4])
    vals = np.array([1.5, -2.0, 0.75, 3.0, 0.5, -1.25])
    shape = (6, 5)
    jop = JSparse.from_coo(rows, cols, vals, shape)
    top = tl.SparseLinOp.from_coo(rows, cols, vals, shape, device="cpu")
    j, t = float(jop.fro_nrm()), float(top.fro_nrm())
    assert abs(t - j) <= 2 * np.finfo(np.float64).eps * j
    dense = np.zeros(shape)
    np.add.at(dense, (rows, cols), vals)
    assert abs(t - np.linalg.norm(dense)) > 0.1
    assert np.array_equal(top.to_dense().numpy(), dense)
    assert top.nnz == 4
    assert _rel(top.matmat(torch.eye(5, dtype=torch.float64)),
                jop.matmat(jnp.eye(5))) == 0.0


def test_sparse_from_dense_and_views_hold_the_stored_entries():
    A = _dense(7, (M, N)) * (np.random.default_rng(7).random((M, N)) < 0.3)
    jop = JSparse.from_dense(jnp.asarray(A))
    top = tl.SparseLinOp.from_dense(_t(A))
    assert top.nnz == int(np.count_nonzero(A))
    assert float(top.fro_nrm()) == pytest.approx(float(jop.fro_nrm()),
                                                 rel=1e-15)
    for jv, tv in ((jop.row_block(5, 30), top.row_block(5, 30)),
                   (jop.col_block(3, 17), top.col_block(3, 17))):
        assert float(tv.fro_nrm()) == pytest.approx(float(jv.fro_nrm()),
                                                    rel=1e-15)
        assert np.array_equal(tv.to_dense().numpy(),
                              np.asarray(jv.to_dense()))
    assert top.A.crow_indices().dtype == torch.int32
    assert top.At.col_indices().dtype == torch.int32


# -- sparse formats -----------------------------------------------------------

def _coo_with_duplicates(seed, shape=(30, 22), nnz=90):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, shape[0], nnz).astype(np.int32),
            rng.integers(0, shape[1], nnz).astype(np.int32),
            rng.standard_normal(nnz), shape)


CONVERSIONS = ["coo_sort", "coo_to_csr", "coo_to_csc", "csr_to_coo",
               "coo_to_dense", "dense_to_coo"]


@pytest.mark.parametrize("name", CONVERSIONS)
def test_sparse_data_conversions_are_exact(name):
    rows, cols, vals, shape = _coo_with_duplicates(3)
    if name == "csr_to_coo":
        args = jsd.coo_to_csr(rows, cols, vals, shape)
        got, ref = tsd.csr_to_coo(*args), jsd.csr_to_coo(*args)
    elif name == "coo_to_dense":
        got = tsd.coo_to_dense(rows, cols, vals, shape, device="cpu")
        ref = jsd.coo_to_dense(rows, cols, vals, shape)
        got, ref = (got,), (ref,)
    elif name == "dense_to_coo":
        D = np.asarray(jsd.coo_to_dense(rows, cols, vals, shape))
        got, ref = tsd.dense_to_coo(_t(D), 0.5), jsd.dense_to_coo(D, 0.5)
    else:
        got = getattr(tsd, name)(rows, cols, vals, shape)
        ref = getattr(jsd, name)(rows, cols, vals, shape)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.array_equal(_np(g), np.asarray(r))
        assert _np(g).dtype == np.asarray(r).dtype


def test_to_bcoo_and_to_bcsr_hold_the_same_matrix():
    rows, cols, vals, shape = _coo_with_duplicates(4)
    coo = tsd.to_bcoo(rows, cols, vals, shape, device="cpu")
    assert coo.layout == torch.sparse_coo and not coo.is_coalesced()
    assert np.array_equal(coo.to_dense().numpy(),
                          np.asarray(jsd.to_bcoo(rows, cols, vals,
                                                 shape).todense()))
    indptr, idx, data = jsd.coo_to_csr(rows, cols, vals, shape)
    csr = tsd.to_bcsr(indptr, idx, data, shape, device="cpu")
    assert csr.layout == torch.sparse_csr
    assert csr.crow_indices().dtype == torch.int32
    assert np.array_equal(csr.to_dense().numpy(), np.asarray(
        jsd.to_bcsr(indptr, idx, data, shape).todense()))


@pytest.mark.parametrize("fmt", ["coo", "csr"])
@pytest.mark.parametrize("product", ["left_spmm", "right_spmm", "spgemm"])
def test_sparse_products(product, fmt):
    rows, cols, vals, shape = _coo_with_duplicates(5)
    jsp = jsd.to_bcoo(rows, cols, vals, shape)
    if fmt == "coo":
        tsp = tsd.to_bcoo(rows, cols, vals, shape, device="cpu")
    else:
        tsp = tsd.to_bcsr(*jsd.coo_to_csr(rows, cols, vals, shape), shape,
                          device="cpu")
    if product == "left_spmm":
        B = _dense(11, (shape[1], 6))
        got, ref = tsd.left_spmm(tsp, _t(B)), jsd.left_spmm(jsp, B)
    elif product == "right_spmm":
        B = _dense(12, (6, shape[0]))
        got = tsd.right_spmm(_t(B), tsp)
        ref = jsd.right_spmm(jnp.asarray(B), jsp)
    else:
        got = tsd.spgemm(tsp, tsp.t() if fmt == "coo"
                         else tsp.t().to_sparse_csr())
        ref = jsd.spgemm(jsp, jsp.T).todense()
    assert _rel(got, ref) <= SP_REL


def _triangular_coo(n, lower, seed, density=0.05):
    rng = np.random.default_rng(seed)
    T = np.where(rng.random((n, n)) < density, rng.standard_normal((n, n)),
                 0.0)
    T = np.tril(T, -1) if lower else np.triu(T, 1)
    T += np.diag(2.0 + rng.random(n))
    rows, cols = np.nonzero(T)
    return rows, cols, T[rows, cols]


@pytest.mark.parametrize("n,block,lower,unit,k", [
    (500, 256, True, False, 3),      # a remainder block
    (333, 64, False, False, 4),      # upper, several blocks
    (200, 256, True, True, None),    # one block, unit diagonal, a vector
    (256, 32, False, True, 2),
])
def test_sparse_trsm(n, block, lower, unit, k):
    rows, cols, vals = _triangular_coo(n, lower, n)
    B = _dense(n + 1, (n, k or 1))
    B = B if k else B[:, 0]
    got = tsd.sparse_trsm(rows, cols, vals, n, _t(B), lower, unit, block)
    ref = jsd.sparse_trsm(rows, cols, vals, n, jnp.asarray(B), lower, unit,
                          block)
    assert got.shape == tuple(ref.shape)
    assert _rel(got, ref) <= SP_REL
    assert tsk.sparse_trsm is tsd.sparse_trsm


# -- the CSR/CSC views --------------------------------------------------------

def _csr_pair(seed, shape=(24, 18)):
    rows, cols, vals, _ = _coo_with_duplicates(seed, shape, 70)
    indptr, idx, data = jsd.coo_to_csr(rows, cols, vals, shape)
    j = jviews.CSRMatrixView(jnp.asarray(indptr), jnp.asarray(idx),
                             jnp.asarray(data), shape)
    t = interop.csr_view_from_numpy(indptr, idx, data, shape, device="cpu")
    return j, t


VIEWS = {
    "matrix": lambda mod, A: A,
    "row_block": lambda mod, A: mod.csr_row_block(A, 5, 17),
    "col_block": lambda mod, A: mod.csr_col_block(A, 3, 11),
    "row_then_col": lambda mod, A: mod.csr_row_block(A, 4, 20).col_block(
        2, 15),
    "csc_col_block": lambda mod, A: mod.csc_col_block(A, 6, 19),
    "csc_row_block": lambda mod, A: mod.csc_row_block(A, 1, 9),
}


@pytest.mark.parametrize("view", list(VIEWS))
def test_csr_views(view):
    jA, tA = _csr_pair(8)
    jv, tv = VIEWS[view](jviews, jA), VIEWS[view](tviews, tA)
    assert type(tv).__name__ == type(jv).__name__
    assert (tv.n_rows, tv.n_cols) == (jv.n_rows, jv.n_cols)
    assert np.array_equal(tv.materialize().numpy(),
                          np.asarray(jv.materialize()))
    X = _dense(9, (tv.n_cols, 3))
    assert _rel(tv.matmat(_t(X)), jv.matmat(jnp.asarray(X))) <= OP_REL
    if view == "row_block":     # zero-copy: the parent's tensors
        assert tv.indices is tA.indices and tv.data is tA.data


# -- dense sketches and sided application -------------------------------------

def _skop(kind, d, m, seed):
    """A sketching operator drawn by JAX, and the same in the port."""
    if kind in ("gaussian", "uniform"):
        dist = JDenseDist(d, m, JScalarDist(kind))
        op, _ = j_dense_skop(dist, JRNG(seed), dtype=jnp.float64)
        return op, interop.dense_skop_from_numpy(
            {"n_rows": d, "n_cols": m, "family": kind}, op.mat,
            device="cpu")
    if kind == "saso":
        op, _ = j_fill_sparse(JSparseDist(d, m, 3), JRNG(seed),
                              dtype=jnp.float64)
        return op, interop.saso_from_numpy(
            {"n_rows": d, "n_cols": m, "vec_nnz": 3}, op.rows, op.vals,
            device="cpu")
    if kind == "srht":
        op, _ = j_srht_skop(d, m, JRNG(seed), dtype=jnp.float64)
        return op, interop.srht_from_numpy(d, m, op.signs, op.rows,
                                           device="cpu")
    S = _dense(seed, (d, m))
    return jnp.asarray(S), _t(S)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", ["gaussian", "uniform", "saso", "srht",
                                  "array"])
def test_sketch_apply(kind, side):
    d, m, n = 12, 50, 7
    if side == "left":
        jS, tS = _skop(kind, d, m, 21)
        A = _dense(22, (m, n))
        got, ref = tsk.sketch_left(tS, _t(A)), j_sketch_left(jS, A)
    else:
        if kind == "srht":            # the SRHT applied from the right
            jS, tS = _skop(kind, d, m, 23)
            A = _dense(24, (n, m))
        elif kind == "saso":          # a tall operator: m x d
            op, _ = j_fill_sparse(JSparseDist(m, d, 3), JRNG(23),
                                  dtype=jnp.float64)
            jS, tS = op, interop.saso_from_numpy(
                {"n_rows": m, "n_cols": d, "vec_nnz": 3}, op.rows, op.vals,
                device="cpu")
            A = _dense(24, (n, m))
        else:
            jS, tS = _skop(kind, m, d, 23)
            A = _dense(24, (n, m))
        got, ref = tsk.sketch_right(_t(A), tS), j_sketch_right(A, jS)
    assert _rel(got, ref) <= OP_REL


@pytest.mark.parametrize("family", ["gaussian", "uniform"])
def test_fill_dense_draws_on_the_device_and_advances(family):
    dist = tsk.DenseDist(30, 40, tsk.ScalarDist(family))
    st = rt.RNGState(5)
    S, nxt = tsk.fill_dense(dist, st, dtype=torch.float64, device="cpu")
    assert S.shape == (30, 40) and S.dtype == torch.float64
    assert S.device.type == "cpu" and nxt.counter == st.counter + 1
    op, nxt2 = tsk.dense_skop(dist, st, dtype=torch.float64, device="cpu")
    assert torch.equal(op.mat, S) and nxt2.counter == nxt.counter
    if family == "uniform":
        assert float(S.abs().max()) <= 3 ** 0.5
    assert abs(float(S.var()) - 1.0) < 0.2
    assert dist.isometry_scale == pytest.approx(30 ** -0.5)


# -- interop round trips ------------------------------------------------------

def test_interop_round_trips():
    rows, cols, vals, shape = _coo_with_duplicates(30)
    op = interop.sparse_linop_from_numpy(rows, cols, vals, shape,
                                         device="cpu")
    r2, c2, v2, s2 = interop.sparse_linop_to_numpy(op)
    assert np.array_equal(r2, rows) and np.array_equal(c2, cols)
    assert np.array_equal(v2, vals) and s2 == shape
    indptr, idx, data = jsd.coo_to_csr(rows, cols, vals, shape)
    view = interop.csr_view_from_numpy(indptr, idx, data, shape, 2,
                                       device="cpu")
    back = interop.csr_view_to_numpy(view)
    for a, b in zip(back, (indptr, idx, data, shape, 2)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    S = np.random.default_rng(1).standard_normal((4, 9))
    fields = {"n_rows": 4, "n_cols": 9, "family": "uniform"}
    sk = interop.dense_skop_from_numpy(fields, S, device="cpu")
    f2, S2 = interop.dense_skop_to_numpy(sk)
    assert f2 == fields and np.array_equal(S2, S)
