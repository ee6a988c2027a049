"""The port's fused-kernel module (randlapack_tpu_torch.ops.kernels) and
the kernel operator built on it (randlapack_tpu_torch.pdkernels) against
the JAX package on the CPU (the CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_cuda.py).

On the CPU the routed functions take the plain versions. The JAX side
runs as its own CPU tests run it: ``kernel_matmat`` in Pallas interpret
mode, the operator through its blocked evaluation. f64 tolerances are
1e-12 relative (summation order differs, MKL against XLA).

The Gaussian sketch cannot be held to the JAX kernel entry by entry: the
TPU kernel draws from the TPU's own PRNG, which interpret mode does not
have on the CPU (the JAX test of it skips here). It is held to the
definition instead — the Philox4x32-10 words against an implementation in
Python integers and Random123's known answers — and to the statistics the
JAX test asks for."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import pdkernels as jpd
from randlapack_tpu.ops import pallas_kernels as jk

from randlapack_tpu_torch import interop, pdkernels as tpd
from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.ops import kernels as tk


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# -- kernel_matmat (plain version behind K4) ---------------------------------

def _xv(d, n, s, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, n)).astype(dtype),
            rng.standard_normal((n, s)).astype(dtype))


@pytest.mark.parametrize("d,n,s,bw", [(8, 512, 128, 1.3), (3, 300, 1, 0.7),
                                      (20, 257, 5, 4.0)])
def test_kernel_matmat_reference_parity_f64(d, n, s, bw):
    X, V = _xv(d, n, s, d + n)
    ref = jk.kernel_matmat_reference(jnp.asarray(X), jnp.asarray(V), bw)
    out = tk.kernel_matmat_reference(torch.tensor(X), torch.tensor(V), bw)
    assert _rel(out, ref) < 1e-12


def test_kernel_matmat_reference_against_the_pallas_kernel_f32():
    """The JAX kernel test's own shape and tolerance
    (tests/test_pallas_kernels.py), the Pallas kernel in interpret mode."""
    X, V = _xv(8, 512, 128, 0, np.float32)
    pal = jk.kernel_matmat(jnp.asarray(X), jnp.asarray(V), 1.3,
                           interpret=True)
    out = tk.kernel_matmat_reference(torch.tensor(X), torch.tensor(V), 1.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), rtol=2e-5,
                               atol=1e-5)


def test_kernel_matmat_routes_by_device():
    X, V = (torch.tensor(a) for a in _xv(4, 50, 3, 1))
    before = dict(tk.LAUNCHES)
    with pytest.raises(RandLAPACKError, match="CUDA"):
        tk.kernel_matmat(X, V, 1.0)
    ref = tk.kernel_matmat_reference(X, V, 1.0)
    assert torch.equal(tk.kernel_matmat_routed(X, V, 1.0), ref)
    assert torch.equal(tk.kernel_matmat_auto(X, V, 1.0), ref)
    with pytest.raises(NotImplementedError):
        tk.kernel_matmat_routed(X.to("meta"), V.to("meta"), 1.0)
    assert tk.LAUNCHES == before


@pytest.mark.parametrize("n,s,splits", [(65536, 1, 1), (8192, 1, 8),
                                        (8192, 4, 8), (1000, 1, 8),
                                        (1000, 130, 7), (1, 1, 1),
                                        (100000, 16, 1)])
def test_kernel_matmat_splits(n, s, splits):
    """The split of the sum over j depends on the shapes alone, never
    exceeds the number of j tiles and stops once the grid is full."""
    assert tk.kernel_matmat_splits(n, s) == splits


# -- the kernel operator -----------------------------------------------------

def _ops(n, d, mus, block, reg=True, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, n))
    Xj = jpd.standardize_dataset(jnp.asarray(X))
    Xt = tpd.standardize_dataset(torch.tensor(X))
    return (jpd.SquaredExpKernelLinOp(Xj, 1.7, jnp.asarray(mus), reg, block),
            tpd.SquaredExpKernelLinOp(Xt, 1.7, mus, reg, block), rng)


@pytest.mark.parametrize("mus,s", [([1e-2], 1), ([1e-2], 3),
                                   ([1e-1, 1e-2, 1e-3], 3)])
@pytest.mark.parametrize("reg", [True, False])
def test_kernel_linop_matmat_parity(mus, s, reg):
    """n not a multiple of block: clipped indices and a masked tail."""
    Gj, Gt, rng = _ops(300, 5, mus, 64, reg)
    V = rng.standard_normal((300, s))
    assert _rel(Gt.X, Gj.X) < 1e-13
    assert _rel(Gt.matmat(torch.tensor(V)), Gj.matmat(jnp.asarray(V))) < 1e-12
    assert _rel(Gt.with_reg(not reg).tmatmat(torch.tensor(V)),
                Gj.with_reg(not reg).tmatmat(jnp.asarray(V))) < 1e-12
    assert (Gt.dim, Gt.num_ops, Gt.n_rows) == (300, len(mus), 300)


@pytest.mark.parametrize("reg", [True, False])
def test_kernel_linop_columns_and_diagonal_parity(reg):
    Gj, Gt, rng = _ops(300, 5, [1e-2], 64, reg)
    idx = rng.integers(0, 300, 17)
    assert _rel(Gt.columns(torch.tensor(idx)),
                Gj.columns(jnp.asarray(idx))) < 1e-12
    assert _rel(Gt.diagonal(), Gj.diagonal()) < 1e-15
    cols = Gt.columns(torch.tensor(idx))
    assert float(cols[idx[3], 3]) == pytest.approx(1.0 + (1e-2 if reg else 0))


def test_kernel_linop_refuses_ambiguous_regularization():
    _, Gt, _ = _ops(40, 3, [1e-1, 1e-2], 16)
    with pytest.raises(RandLAPACKError):
        Gt.diagonal()
    with pytest.raises(RandLAPACKError):
        Gt.columns(torch.tensor([1, 2]))
    with pytest.raises(RandLAPACKError):
        Gt.matmat(torch.zeros(40, 3, dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        Gt.fro_nrm()
    assert Gt.with_reg(False).diagonal().sum() == 40


def test_pdkernel_helpers_parity():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((4, 60))
    rows, cols = rng.integers(0, 60, 7), rng.integers(0, 60, 9)
    assert _rel(tpd.squared_exp_kernel_submatrix(
        torch.tensor(X), torch.tensor(rows), torch.tensor(cols), 0.8),
        jpd.squared_exp_kernel_submatrix(
            jnp.asarray(X), jnp.asarray(rows), jnp.asarray(cols), 0.8)) < 1e-13
    assert _rel(tpd.squared_distances(torch.tensor(X[:, :9]),
                                      torch.tensor(X[:, 5:])),
                jpd.squared_distances(jnp.asarray(X[:, :9]),
                                      jnp.asarray(X[:, 5:]))) < 1e-13
    D, B, C, V = (rng.standard_normal(s) for s in
                  ((6,), (6, 4), (4, 4), (10, 3)))
    assert _rel(tpd.block_arrowhead_multiply(*map(torch.tensor, (D, B, C, V))),
                jpd.block_arrowhead_multiply(*map(jnp.asarray, (D, B, C, V)))
                ) < 1e-13


def test_kernel_linop_crosses_packages():
    Gj, _, rng = _ops(120, 3, [1e-1, 1e-3], 32)
    Gt = interop.kernel_linop_from_numpy(
        {"X": np.asarray(Gj.X), "bandwidth": np.asarray(Gj.bandwidth),
         "mus": np.asarray(Gj.mus)}, block=32, device="cpu")
    V = rng.standard_normal((120, 2))
    assert _rel(Gt.matmat(torch.tensor(V)), Gj.matmat(jnp.asarray(V))) < 1e-12
    back = interop.kernel_linop_to_numpy(Gt)
    Gj2 = jpd.SquaredExpKernelLinOp(jnp.asarray(back["X"]),
                                    back["bandwidth"],
                                    jnp.asarray(back["mus"]), True, 32)
    assert _rel(Gj2.matmat(jnp.asarray(V)), Gj.matmat(jnp.asarray(V))) < 1e-15


# -- gaussian_sketch (plain version behind K7) --------------------------------

def _philox_ints(counter, key):
    """Philox4x32-10 from the definition, in Python integers."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
        k = [(k[0] + 0x9E3779B9) & 0xFFFFFFFF, (k[1] + 0xBB67AE85) & 0xFFFFFFFF]
    return c


@pytest.mark.parametrize("counter,key,words", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_philox_known_answers(counter, key, words):
    """Random123's known-answer vectors for philox4x32-10."""
    out = tk.philox4x32_10([torch.tensor(c, dtype=torch.int64)
                            for c in counter], key)
    assert tuple(int(w) for w in out) == words
    assert tuple(_philox_ints(counter, key)) == words


def test_philox_words_against_python_integers():
    rng = np.random.default_rng(5)
    counters = rng.integers(0, 2**32, (300, 4), dtype=np.uint64).astype(
        np.int64)
    counters[:4] = [[0, 1, 0, 0], [2**32 - 1, 7, 0, 0], [5, 2**32 - 1, 0, 0],
                    [2**31, 2**31, 2**31, 2**31]]
    key = (0x9E3779B9, 0xFFFFFFFF)
    out = tk.philox4x32_10([torch.tensor(counters[:, j]) for j in range(4)],
                           key)
    got = np.stack([w.numpy() for w in out], axis=1)
    want = np.array([_philox_ints(c, key) for c in counters.tolist()])
    np.testing.assert_array_equal(got, want)


def test_gaussian_sketch_matrix_follows_its_definition():
    """S[i, r] from (seed, i, r) alone: the words of counter (r//4, i, 0,
    0), key (seed low, seed high); Box–Muller, both branches."""
    d, m, seed = 6, 11, 2**35 + 17
    S = tk.gaussian_sketch_matrix(d, m, seed, torch.float64)
    for i, r in [(0, 0), (5, 10), (3, 5), (2, 7)]:
        w = _philox_ints((r // 4, i, 0, 0), (seed & 0xFFFFFFFF, seed >> 32))
        wa, wb = w[2 * ((r % 4) // 2)], w[2 * ((r % 4) // 2) + 1]
        u1 = max((wa & 0x7FFFFF) / 8388608.0, 1e-7)
        u2 = (wb & 0x7FFFFF) / 8388608.0
        trig = math.cos if r % 2 == 0 else math.sin
        want = math.sqrt(-2 * math.log(u1)) * trig(2 * math.pi * u2) \
            / math.sqrt(d)
        assert float(S[i, r]) == pytest.approx(want, rel=1e-13, abs=1e-15)
    # no dependence on how much of S is asked for
    big = tk.gaussian_sketch_matrix(9, 16, seed, torch.float64)
    assert torch.allclose(big[:d, :m] * 3.0, S * math.sqrt(d), rtol=1e-15,
                          atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gaussian_sketch_statistics(dtype):
    """What the JAX kernel test asks (tests/test_pallas_kernels.py), at
    its shapes: E‖SA‖_F = ‖A‖_F, determinism, another seed differs."""
    m, n, d = 2048, 256, 64
    A = torch.tensor(np.random.default_rng(4).standard_normal((m, n)),
                     dtype=dtype)
    before = dict(tk.LAUNCHES)
    out = tk.gaussian_sketch(A, d, 11)
    assert out.shape == (d, n) and out.dtype == dtype
    ratio = float(torch.linalg.norm(out) / torch.linalg.norm(A))
    assert abs(ratio - 1.0) < 0.1
    assert torch.equal(out, tk.gaussian_sketch(A, d, 11))
    assert torch.equal(out, tk.gaussian_sketch_reference(A, d, 11))
    assert not torch.allclose(out, tk.gaussian_sketch(A, d, 12))
    with pytest.raises(RandLAPACKError, match="CUDA"):
        tk.gaussian_sketch_cuda(A, d, 11)
    assert tk.LAUNCHES == before


def test_gaussian_sketch_matrix_moments():
    """d·m = 131072 entries: mean, variance·d and 4th moment within five
    standard errors of N(0, 1/d)'s (0, 1, 3)."""
    d, m = 64, 2048
    Z = tk.gaussian_sketch_matrix(d, m, 7, torch.float64) * math.sqrt(d)
    N = d * m
    assert abs(float(Z.mean())) < 5 / math.sqrt(N)
    assert abs(float(Z.var()) - 1.0) < 5 * math.sqrt(2 / N)
    assert abs(float((Z ** 4).mean()) - 3.0) < 5 * math.sqrt(96 / N)
    # rows and neighbouring entries are uncorrelated
    assert abs(float((Z[:, :-1] * Z[:, 1:]).mean())) < 5 / math.sqrt(N)
    assert abs(float((Z[:-1] * Z[1:]).mean())) < 5 / math.sqrt(N)
    # a negative seed is its 64-bit two's complement
    assert torch.equal(tk.gaussian_sketch_matrix(3, 5, -1),
                       tk.gaussian_sketch_matrix(3, 5, 2**64 - 1))
