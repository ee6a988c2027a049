"""The port's dist_bqrrp_factored (the row-sharded mode of
bqrrp_factored) against the JAX package's on its 8-device CPU mesh, in
f64, at p = 1, 2 and 4 gloo ranks on the CPU, the JAX-drawn sketch's
column blocks injected.

Gates: J equal; R, T, V, Q (bqrrp_q, sequential and tree) and Qᵀ·A[:, J]
(bqrrp_apply_qt) on the sharded factors within 1e-10 of the largest
entry of JAX's; replicated outputs (R, T, J, rank, fail) bit-equal on
every rank; one rank bit-equal to the unsharded port driver; J equal and
R within 1e-10 across the world sizes, also with the options
dist_bqrrp_factored leaves at their defaults (update defer 2, candidate
preselection), where one rank is the unsharded driver, and in
"bf16_3x_emul" J equal and R within that mode's 2⁻¹⁶ (each shard drops
its own lo·lo terms; V's late columns move by that times the panels'
conditioning, 2.4e-3 here, so V is not compared there).
The 192×96, b 32 case puts the
rows [32, 64) of the second block across ranks 0 and 1 at p = 4. The
rescue ladder: a 128×96 matrix with 40 zero columns (f64: shifted
CholQR3 and the Householder rung) and ``gen.bad_cholqr_matrix`` in f32
(shifted CholQR3) at p = 2, ``fail`` as JAX's, J equal up to the rank.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.gen import MatGenInfo, MatType, bad_cholqr_matrix, mat_gen

import _torch_parallel_ranks as ranks
from randlapack_tpu_torch.parallel import run_ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

WORLDS = (1, 2, 4)
TOL = 1e-10


def _jax_sketch(seed, d, m, dtype=jnp.float64):
    """The sketch exactly as the JAX bqrrp_factored draws it."""
    key, _ = JRNG(seed).spawn()
    return np.asarray(jax.random.normal(key, (d, m), dtype=dtype)
                      / math.sqrt(d))


def _case(A, seed, **kw):
    m, n = A.shape
    b = min(kw["block_size"], m, n)
    return dict(A=np.asarray(A), seed=seed, kw=kw,
                S=_jax_sketch(seed, int(1.25 * b), m,
                              jnp.asarray(A).dtype))


def _cases():
    A1, _ = mat_gen(MatGenInfo(192, 96, MatType.polynomial, cond_num=1e5),
                    JRNG(31))
    A2, _ = mat_gen(MatGenInfo(200, 100, MatType.exponential,
                               cond_num=1e5), JRNG(33))
    A3, _ = mat_gen(MatGenInfo(128, 160, MatType.polynomial, cond_num=1e4),
                    JRNG(35))
    return {"straddle": _case(A1, 32, block_size=32),
            "remainder": _case(A2, 34, block_size=32),
            "wide_stages2": _case(A3, 36, block_size=32, stages=2)}


def _jax_run(c):
    from randlapack_tpu.drivers import bqrrp_apply_qt, bqrrp_q
    from randlapack_tpu.parallel import (dist_bqrrp_factored, make_mesh,
                                         row_sharded)
    mesh = make_mesh(8)
    A = jax.device_put(jnp.asarray(c["A"]), row_sharded(mesh))
    fac, _ = dist_bqrrp_factored(A, mesh, JRNG(c["seed"]), **c["kw"])
    with jax.sharding.set_mesh(mesh):
        Q = bqrrp_q(fac)
        QtA = bqrrp_apply_qt(fac, jnp.take(A, fac.J, axis=1))
    return dict(V=np.asarray(fac.V), T=np.asarray(fac.T),
                R=np.asarray(fac.R), J=np.asarray(fac.J),
                rank=int(fac.rank), fail=bool(fac.fail), Q=np.asarray(Q),
                QtA=np.asarray(QtA))


@pytest.fixture(scope="module")
def runs():
    cases = _cases()
    port = {p: run_ranks(ranks.bqrrp_body, p, cases, backend="gloo",
                         device="cpu", timeout=300) for p in WORLDS}
    return cases, {t: _jax_run(c) for t, c in cases.items()}, port


def _stack(res, tag, key):
    return np.concatenate([r[tag][key] for r in res])


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


CASES = ("straddle", "remainder", "wide_stages2")


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("tag", CASES)
def test_matches_jax(runs, tag, p):
    _, jx, port = runs
    res, j = port[p], jx[tag]
    r = res[0][tag]
    np.testing.assert_array_equal(r["J"], j["J"])
    assert bool(r["fail"]) == j["fail"] and int(r["rank"]) == j["rank"]
    assert _rel(r["R"], j["R"]) <= TOL
    assert _rel(r["T"], j["T"]) <= TOL
    assert _rel(_stack(res, tag, "V"), j["V"]) <= TOL
    assert _rel(_stack(res, tag, "Q"), j["Q"]) <= TOL
    assert _rel(_stack(res, tag, "Qt"), j["Q"]) <= TOL
    assert _rel(_stack(res, tag, "QtA"), j["QtA"]) <= TOL
    assert r["counter"] == 1


@pytest.mark.parametrize("p", (2, 4))
def test_replicated_outputs_bit_equal_across_ranks(runs, p):
    res = runs[2][p]
    for tag in (*CASES, "drawn"):
        for key in ("R", "J") + (("T", "rank", "fail") if tag != "drawn"
                                 else ()):
            for r in res[1:]:
                assert np.array_equal(r[tag][key], res[0][tag][key]), \
                    (tag, key)


@pytest.mark.parametrize("tag", CASES)
def test_one_rank_is_the_unsharded_driver_bit_for_bit(runs, tag):
    r = runs[2][1][0][tag]
    for key in ("V", "T", "R", "J"):
        assert np.array_equal(r[key], r["single"][key]), key


@pytest.mark.parametrize("tag", (*CASES, "drawn", "defer2",
                                 "defer2_bf16x3"))
def test_world_size_does_not_change_the_result(runs, tag):
    port = runs[2]
    r1 = port[1][0][tag]
    # "bf16_3x_emul" drops each shard's lo·lo terms: the mode's 2⁻¹⁶
    tol = 2.0 ** -16 if tag.endswith("bf16x3") else TOL
    for p in (2, 4):
        r = port[p][0][tag]
        np.testing.assert_array_equal(r["J"], r1["J"])
        assert _rel(r["R"], r1["R"]) <= tol
        if tag == "defer2":
            assert _rel(_stack(port[p], tag, "V"), r1["V"]) <= TOL


def _zero_columns(m, n, nzero, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * np.logspace(0, -4, n)
    A[:, rng.permutation(n)[:nzero]] = 0.0
    return A


RESCUE = {
    # numerical rank 56: past it the pivots are chosen among zero columns
    "zero_columns_f64": (lambda: _zero_columns(128, 96, 40, 3), 56),
    "bad_cholqr_f32": (lambda: np.asarray(bad_cholqr_matrix(
        128, 64, JRNG(3), jnp.float32)[0]), 0),
}


@pytest.mark.parametrize("tag", RESCUE)
def test_rescue_ladder_sharded(tag):
    from randlapack_tpu.parallel import dist_bqrrp_factored, make_mesh
    make, r = RESCUE[tag]
    A = make()
    c = _case(A, 3, block_size=32)
    fj, _ = dist_bqrrp_factored(jnp.asarray(A), make_mesh(8), JRNG(3),
                                block_size=32)
    res = run_ranks(ranks.rescue_body, 2, c["A"], c["S"], c["kw"],
                    backend="gloo", device="cpu", timeout=120)
    for out in res:
        assert bool(out["fail"]) == bool(fj.fail)
        np.testing.assert_array_equal(out["J"][:r], np.asarray(fj.J)[:r])
        assert sorted(out["J"].tolist()) == list(range(A.shape[1]))
        assert np.array_equal(out["R"], res[0]["R"])
