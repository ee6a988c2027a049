"""One input through the JAX package and through the port, with every random
draw of the JAX driver made once and injected into the port (the two
packages' random streams differ by design). Shared by
``tests/test_torch_edge_cases.py``, ``tests/test_torch_property_sweeps.py``
and ``tools/fuzz_torch.py``.

A draw function takes a random source in the JAX driver's order:
``JaxRNG`` wraps the JAX package's ``RNGState`` and makes exactly the
driver's draws; ``PortRNG`` makes draws of the same shapes and laws with
numpy and the port's own SASO/SRHT samplers, for runs without JAX (the
card mode of ``tools/fuzz_torch.py``). This module imports JAX only inside
``JaxRNG``. Draws come back as numpy arrays (operators as port operators
on the CPU); ``to_device`` moves them.

The rank-aware comparison of two pivoted QRs is ROADMAP.md §3's
("Constraints"): pivots up to the numerical rank, R's rows on them in the
original column order, and, where the pivots part, whether they part at a
tie (the two factorizations' |R_ii| equal there), which rounding decides.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from randlapack_tpu_torch import RNGState
from randlapack_tpu_torch.interop import (saso_from_numpy, saso_to_numpy,
                                          srht_from_numpy, srht_to_numpy)
from randlapack_tpu_torch.sketching import SparseDist, fill_sparse, srht_skop


class JaxRNG:
    """The JAX package's stream: ``spawn`` and ``branch`` as its
    ``RNGState``; the values as ``jax.random`` draws them in ``dtype``
    (the input's: the JAX drivers draw in A's dtype)."""

    def __init__(self, state, dtype="float64"):
        self.state, self.dtype = state, dtype

    def spawn(self):
        key, st = self.state.spawn()
        return key, JaxRNG(st, self.dtype)

    def branch(self, i):
        return JaxRNG(self.state.branch(i), self.dtype)

    @staticmethod
    def split(key, n):
        import jax
        return list(jax.random.split(key, n))

    def normal(self, key, shape):
        import jax
        return np.asarray(jax.random.normal(key, shape, dtype=self.dtype))

    def uniform(self, key, shape, lo, hi):
        import jax
        return np.asarray(jax.random.uniform(key, shape, dtype=self.dtype,
                                             minval=lo, maxval=hi))

    def gumbel(self, key, shape):
        import jax
        return np.asarray(jax.random.gumbel(key, shape, dtype=self.dtype))

    def saso(self, d, m, vec_nnz):
        from randlapack_tpu.sketching import SparseDist as JSparseDist
        from randlapack_tpu.sketching import fill_sparse as j_fill_sparse
        op, st = j_fill_sparse(JSparseDist(d, m, vec_nnz), self.state,
                               dtype=self.dtype)
        return saso_from_numpy(dict(n_rows=d, n_cols=m, vec_nnz=vec_nnz),
                               op.rows, op.vals,
                               device="cpu"), JaxRNG(st, self.dtype)

    def srht(self, d, m):
        from randlapack_tpu.sketching import srht_skop as j_srht_skop
        op, st = j_srht_skop(d, m, self.state, dtype=self.dtype)
        return srht_from_numpy(d, m, op.signs, op.rows,
                               device="cpu"), JaxRNG(st, self.dtype)


class PortRNG:
    """Draws of the same shapes and laws without JAX: keys are seeds of
    numpy generators; the SASO and SRHT come from the port's samplers on
    the CPU."""

    def __init__(self, seed: int, counter: int = 0):
        self.seed, self.counter = int(seed), counter

    def _derive(self, *words):
        seq = np.random.SeedSequence([self.seed, self.counter, *words])
        return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(2))

    def spawn(self):
        return self._derive(0), PortRNG(self.seed, self.counter + 1)

    def branch(self, i):
        return PortRNG(self._derive(1, i))

    @staticmethod
    def split(key, n):
        return [int(s) for s in np.random.SeedSequence(key).generate_state(
            n, np.uint32)]

    @staticmethod
    def normal(key, shape):
        return np.random.default_rng(key).standard_normal(shape)

    @staticmethod
    def uniform(key, shape, lo, hi):
        return np.random.default_rng(key).uniform(lo, hi, shape)

    @staticmethod
    def gumbel(key, shape):
        return np.random.default_rng(key).gumbel(size=shape)

    def saso(self, d, m, vec_nnz):
        key, nxt = self.spawn()
        op, _ = fill_sparse(SparseDist(d, m, vec_nnz), RNGState(key),
                            dtype=torch.float64, device="cpu")
        return op, nxt

    def srht(self, d, m):
        key, nxt = self.spawn()
        op, _ = srht_skop(d, m, RNGState(key), dtype=torch.float64,
                          device="cpu")
        return op, nxt


def to_device(x, device, dtype):
    """A draw (array, port operator, list or dict of them, or None) as
    tensors of ``dtype`` on ``device``."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device, dtype) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, device, dtype) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return torch.tensor(x, dtype=dtype, device=device)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    if hasattr(x, "vals"):                       # a SASO
        fields, rows, vals = saso_to_numpy(x)
        return saso_from_numpy(fields, rows, vals.astype(
            torch.empty((), dtype=dtype).numpy().dtype), device=device)
    d, m, signs, rows = srht_to_numpy(x)         # an SRHT
    return srht_from_numpy(d, m, signs.astype(
        torch.empty((), dtype=dtype).numpy().dtype), rows, device=device)


# -- the drivers' draws, in the JAX drivers' order ------------------------------

def bqrrp_sketch(rng, shape, block_size, d_factor=1.25):
    """BQRRP's Gaussian sketch, both forms (drivers/bqrrp.py:498,901)."""
    m, n = shape
    d = int(d_factor * min(block_size, m, n))
    key, _ = rng.spawn()
    return rng.normal(key, (d, m)) / math.sqrt(d)


def hqrrp_sketch(rng, shape, block_size, oversample=10):
    """HQRRP's uniform operator G (drivers/hqrrp.py:403)."""
    m, n = shape
    key, _ = rng.spawn()
    return rng.uniform(key, (min(block_size, m, n) + oversample, m), -1.0,
                       1.0)


def tall_qr_draws(rng, shape, sketch, d_factor, vec_nnz=8, qrcp=None,
                  qrcp_block=128, orth=False):
    """CQRRPT's (and, with ``qrcp=None``, CQRRT's) draws in their order:
    the sketch operator (none where d ≥ m: A is its own sketch), the
    sketch QRCP's sketch (BQRRP's Gaussian or HQRRP's G), then the basis
    completion's Gaussians. Returns ``(sketch, qrcp_sketch, noise)``."""
    m, n = shape
    d = int(d_factor * n)
    kind = getattr(sketch, "value", sketch)
    if d >= m:
        op, d = None, m
    elif kind == "saso":
        op, rng = rng.saso(d, m, vec_nnz)
    elif kind == "srht":
        op, rng = rng.srht(d, m)
    else:
        key, rng = rng.spawn()
        op = rng.normal(key, (d, m)) / math.sqrt(d)
    qs, b = None, min(qrcp_block, d, n)
    kind = getattr(qrcp, "value", qrcp)
    if kind == "bqrrp":
        key, rng = rng.spawn()
        db = int(1.25 * b)
        qs = rng.normal(key, (db, d)) / math.sqrt(db)
    elif kind == "hqrrp":
        key, rng = rng.spawn()
        qs = rng.uniform(key, (b + 10, d), -1.0, 1.0)
    noise = None
    if orth:
        key, rng = rng.spawn()
        noise = rng.normal(key, (m, n))
    return op, qs, noise


def spls_sketch(rng, shape, d_factor=4.0, vec_nnz=8, precond="qr"):
    """SPLS's SASO (drivers/spls.py:53); none for "svd" with d = m."""
    m, n = shape
    d = min(int(d_factor * n), m)
    if precond == "svd" and d >= m:
        return None
    return rng.saso(d, m, vec_nnz)[0]


def abrik_draws(rng, shape, block_size, max_iters, qr_explicit="geqrf",
                d_factor=1.25):
    """ABRIK's start and, for ``"cqrrt"``, its 2q sketches (entry 1
    unused; drivers/abrik.py:117-128)."""
    m, n = shape
    b, q = block_size, max_iters
    key, rng = rng.spawn()
    v0 = rng.normal(key, (n, b))
    if qr_explicit == "geqrf":
        return v0, None
    kq, _ = rng.spawn()
    keys = rng.split(kq, 2 * q)
    sketches = []
    for i in range(2 * q):
        rows = n if (i % 2 == 0 and i > 0) else m
        d = min(rows, int(math.ceil(d_factor * b)))
        sketches.append(None if i == 1 else rng.normal(keys[i], (d, rows)))
    return v0, sketches


def qb_omegas(rng, shape, k, block_size, passes=2):
    """QB's per-block RS starts, block i from ``branch(i)`` (comps/qb.py:
    64, comps/rs.py:46), over the k padded up to whole blocks."""
    m, n = shape
    rows = n if passes % 2 == 0 else m
    return [rng.normal(rng.branch(i).spawn()[0], (rows, block_size))
            for i in range(-(-k // block_size))]


def sequential_draw(rng):
    """``draw(shape, k)`` for REVD2: one spawn a call, in call order."""
    box = [rng]

    def draw(shape, k):
        key, box[0] = box[0].spawn()
        return box[0].normal(key, shape)
    return draw


def rpchol_noise(rng, n, nblocks):
    """RPCholesky's Gumbel rows, block i from ``branch(i)``
    (comps/rpchol.py:64-69)."""
    return np.stack([rng.gumbel(rng.branch(i).spawn()[0], (n,))
                     for i in range(nblocks)])


# -- comparisons ----------------------------------------------------------------

def qr_residual(A, Q, R, J):
    """‖Q·R[:k] − A[:, J]‖_F/‖A‖_F in f64, and whether J is a permutation."""
    A, Q, R, J = (np.asarray(x) for x in (A, Q, R, J))
    A = A.astype(np.float64)
    k = Q.shape[1]
    with np.errstate(all="ignore"):
        res = float(np.linalg.norm(Q.astype(np.float64) @ R[:k].astype(
            np.float64) - A[:, J]) / max(np.linalg.norm(A), 1e-300))
    perm = sorted(J.tolist()) == list(range(A.shape[1]))
    return (res if np.isfinite(res) else math.inf), perm


def numerical_rank(R, rtol=1e-10):
    d = np.abs(np.diag(np.asarray(R, dtype=np.float64)))
    if not d.size or not np.isfinite(d).all() or d[0] == 0:
        return 0
    return int(np.sum(d > rtol * d[0]))


def compare_pivoted(Rj, Jj, Rt, Jt, rtol=1e-10, tol=1e-6):
    """The rank-aware comparison: ``None`` where the pivots agree up to
    the numerical rank r and R's leading r rows agree in the original
    column order within ``tol``·max|R|; ``"tie"`` where the pivots part
    at a position whose |R_ii| the two factorizations share within
    ``tol`` of itself, or within √eps·|R_00|: the QRCPs downdate partial
    column norms (Drmač, LAPACK's tol3z = √eps) that are fixed only to
    about √eps of a column's last recomputed norm, so below that the
    choice among columns is rounding; else a message."""
    Rj, Rt = (np.asarray(x, dtype=np.float64) for x in (Rj, Rt))
    Jj, Jt = np.asarray(Jj), np.asarray(Jt)
    r = min(numerical_rank(Rj, rtol), numerical_rank(Rt, rtol))
    differ = np.nonzero(Jj[:r] != Jt[:r])[0]
    if differ.size:
        i = int(differ[0])
        dj, dt = abs(Rj[i, i]), abs(Rt[i, i])
        if abs(dj - dt) <= (tol * max(dj, dt)
                            + np.sqrt(np.finfo(np.float64).eps)
                            * abs(Rj[0, 0])):
            return "tie"
        return (f"pivots part at {i} of rank {r}: |R_ii| {dj:.6e} against "
                f"{dt:.6e}")
    if r == 0:
        return None
    scale = max(np.abs(Rj[:r]).max(), 1e-300)
    d = np.abs(Rj[:r][:, np.argsort(Jj)] - Rt[:r][:, np.argsort(Jt)]).max()
    if not d <= tol * scale:
        return f"R's leading {r} rows differ by {d / scale:.3e} of max|R|"
    return None
