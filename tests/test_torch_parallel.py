"""The port's distributed layer (randlapack_tpu_torch.parallel): the mesh,
the launcher, tsqr.py and distributed.py against the JAX package's on its
8-device CPU mesh, in f64, at p = 1, 2 and 4 gloo ranks on the CPU, on
the inputs of tests/test_parallel.py.

Gates: G, Q, R, S·A, B and Ω' within 1e-10 of the largest entry of
JAX's, where rounding allows: one CholQR pass moves Q by up to κ(A)²·eps
under another order of sums, so dist_cholqr(passes=1) at κ 1e4 is held
to κ²·eps = 2.2e-8, and the shifted CholQR3 of a κ 1e11 input moves Q and
R by up to κ·eps = 2.2e-5 (its orthogonality is held to JAX's gate,
1e-11); the failure flags equal; replicated outputs bit-equal on every
rank; one rank's dist_cholqr bit-equal to the port's cholqr2. Both band
guards (``tsqr._band_guard_local``, sized by the local rows, and
``ops.cholqr._finite_scaled`` with a mesh, sized by the global rows, as
XLA's partitioner sees ``dist_cqrrpt``'s) on inputs scaled by 2¹⁸⁰ and
2⁻¹⁸⁰ (f64), 2⁻⁶⁰ (f32) and with one NaN on rank 0: JAX's scale and
non-finite flag on every rank, and dist_cholqr of the scaled input as
JAX's (f64) or, in f32, where two packages' CholQR2 of a κ 1e4 input
differ by rounding at 1e-4, as the port's own of the unscaled input
(1e-5 on Q, 2e-5 on R/scale, the JAX test's gates). Refusals: rows that do not split evenly,
``shard_axis`` with no mesh (or another axis) set (``bqrrp_factored``, the
explicit ``bqrrp``, ``hqrrp``, ``hqrrp_lapack_format``, ``abrik``), ``make_mesh`` for a
card on a host with none, a rank that raises, and a collective one rank
never reaches (the launcher's timeout).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.gen import MatGenInfo, MatType, mat_gen
from randlapack_tpu.parallel import (dist_cholqr, dist_gram,
                                     dist_rangefinder_step,
                                     dist_shifted_cholqr3, dist_sketch_left,
                                     make_mesh, row_sharded)

import _torch_parallel_ranks as ranks
from randlapack_tpu_torch import parallel as tp
from randlapack_tpu_torch.parallel import run_ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

WORLDS = (1, 2, 4)
TOL = 1e-10
EPS = float(np.finfo(np.float64).eps)
# the worst rounding each function's Q and R can move by (module doc)
TOLS = {"cholqr1": 1e4 ** 2 * EPS, "cholqr2": TOL, "scholqr3": 1e11 * EPS}
SCALES = {"one": 1.0, "big": 2.0 ** 180, "tiny": 2.0 ** -180,
          "nan": 1.0}


def _inputs():
    A, _ = mat_gen(MatGenInfo(640, 48, MatType.exponential, cond_num=1e4),
                   JRNG(0))
    A_ill, _ = mat_gen(MatGenInfo(640, 48, MatType.exponential,
                                  cond_num=1e11), JRNG(1))
    S = jax.random.normal(jax.random.key(2), (32, 640), jnp.float64)
    Om = jax.random.normal(jax.random.key(3), (48, 16), jnp.float64)
    A32, _ = mat_gen(MatGenInfo(640, 32, MatType.exponential,
                                cond_num=1e4), JRNG(71))
    return dict(A=np.asarray(A), A_ill=np.asarray(A_ill), S=np.asarray(S),
                Om=np.asarray(Om), A32=np.asarray(A32).astype(np.float32))


def _scaled(inp, tag):
    """The guard inputs: A (f64) scaled for the wide scales, A32 scaled by
    2⁻⁶⁰ for "tiny32", a NaN at (1, 2) for "nan"."""
    if tag.endswith("32"):
        X = np.float32(2.0 ** -60 if tag == "tiny32" else 1.0) * inp["A32"]
    else:
        X = SCALES[tag] * inp["A"]
    if tag == "nan":
        X = X.copy()
        X[1, 2] = np.nan
    return X


GUARDS = (*SCALES, "one32", "tiny32")


def _jax_guards(X, mesh):
    from jax.experimental.shard_map import shard_map
    from randlapack_tpu.ops.cholqr import _finite_scaled
    from randlapack_tpu.parallel.tsqr import _band_guard_local
    local = shard_map(lambda a: _band_guard_local(a, "rows")[1:], mesh=mesh,
                      in_specs=P("rows", None), out_specs=(P(), P()))
    s, nf = local(jax.device_put(jnp.asarray(X), row_sharded(mesh)))
    _, sg, nfg = _finite_scaled(jnp.asarray(X))
    return float(s), bool(nf), float(sg), bool(nfg)


@pytest.fixture(scope="module")
def runs():
    inp = _inputs()
    mesh = make_mesh(8)
    As = jax.device_put(jnp.asarray(inp["A"]), row_sharded(mesh))
    jx = {"gram": dist_gram(As, mesh)}
    for passes in (1, 2):
        jx[f"cholqr{passes}"] = dist_cholqr(As, mesh, passes=passes)
    jx["scholqr3"] = dist_shifted_cholqr3(
        jax.device_put(jnp.asarray(inp["A_ill"]), row_sharded(mesh)), mesh)
    Ss = jax.device_put(jnp.asarray(inp["S"]),
                        NamedSharding(mesh, P(None, "rows")))
    jx["sketch_left"] = dist_sketch_left(Ss, As, mesh)
    jx["rangefinder"] = dist_rangefinder_step(
        As, jax.device_put(jnp.asarray(inp["Om"]), NamedSharding(mesh, P())),
        mesh)
    for tag in GUARDS:
        X = _scaled(inp, tag)
        jx[f"guard_{tag}"] = _jax_guards(X, mesh)
        jx[f"cholqr_{tag}"] = dist_cholqr(
            jax.device_put(jnp.asarray(X), row_sharded(mesh)), mesh)
    jx = jax.tree_util.tree_map(np.asarray, jx)
    guards = {tag: _scaled(inp, tag) for tag in GUARDS}
    port = {p: run_ranks(ranks.ops_body, p, inp["A"], inp["A_ill"],
                         inp["S"], inp["Om"], guards, backend="gloo",
                         device="cpu", timeout=300) for p in WORLDS}
    return inp, jx, port


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def _rows(res, key, i):
    return np.concatenate([r[key][i] for r in res])


@pytest.mark.parametrize("p", WORLDS)
def test_gram_and_sketch_left(runs, p):
    _, jx, port = runs
    for key in ("gram", "sketch_left"):
        for r in port[p]:
            assert _rel(r[key], jx[key]) <= TOL
            assert np.array_equal(r[key], port[p][0][key])


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("key", ("cholqr1", "cholqr2", "scholqr3"))
def test_cholqr_family(runs, key, p):
    _, jx, port = runs
    Qj, Rj, fj = jx[key]
    res = port[p]
    assert _rel(_rows(res, key, 0), Qj) <= TOLS[key]
    for r in res:
        assert _rel(r[key][1], Rj) <= TOLS[key]
        assert bool(r[key][2]) == bool(fj)
        assert np.array_equal(r[key][1], res[0][key][1])
    # orthogonality: JAX's own to within a factor 2, and the JAX tests'
    # gates where they have one (CholQR2 1e-12, shifted CholQR3 1e-11)
    orth = np.linalg.norm(_rows(res, key, 0).T @ _rows(res, key, 0)
                          - np.eye(48))
    assert orth <= 2 * np.linalg.norm(Qj.T @ Qj - np.eye(48)) + 1e-13
    assert orth < {"cholqr1": 1.0, "cholqr2": 1e-12, "scholqr3": 1e-11}[key]


@pytest.mark.parametrize("p", WORLDS)
def test_rangefinder_step(runs, p):
    _, jx, port = runs
    Qj, Bj, Omj, fj = jx["rangefinder"]
    res = port[p]
    assert _rel(_rows(res, "rangefinder", 0), Qj) <= TOL
    for r in res:
        Q, B, Om, f = r["rangefinder"]
        assert _rel(B, Bj) <= TOL and _rel(Om, Omj) <= TOL
        assert bool(f) == bool(fj)
        assert np.array_equal(B, res[0]["rangefinder"][1])


def test_one_rank_cholqr_is_cholqr2_bit_for_bit(runs):
    r = runs[2][1][0]
    Q, R, _ = r["cholqr2"]
    Qs, Rs, _ = r["cholqr2_single"]
    assert np.array_equal(Q, Qs) and np.array_equal(R, Rs)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("tag", GUARDS)
def test_band_guards(runs, tag, p):
    _, jx, port = runs
    s, nf, sg, nfg = jx[f"guard_{tag}"]
    for r in port[p]:
        got = tuple(float(x) if i % 2 == 0 else bool(x)
                    for i, x in enumerate(r[f"guard_{tag}"]))
        assert got == (s, nf, sg, nfg), (tag, got, (s, nf, sg, nfg))
    assert (s != 1.0) == (tag in ("tiny", "tiny32"))
    assert (sg != 1.0) == (tag in ("tiny", "tiny32"))
    assert nf == (tag == "nan")
    if tag == "nan":
        return
    Qj, Rj, fj = jx[f"cholqr_{tag}"]
    res = port[p]
    Q, R = _rows(res, f"cholqr_{tag}", 0), res[0][f"cholqr_{tag}"][1]
    assert not bool(fj) and not bool(res[0][f"cholqr_{tag}"][2])
    if not tag.endswith("32"):
        assert _rel(Q, Qj) <= TOL and _rel(R, Rj) <= TOL
        return
    Q1, R1 = _rows(res, "cholqr_one32", 0), res[0]["cholqr_one32"][1]
    scale = 2.0 ** -60 if tag == "tiny32" else 1.0
    assert np.abs(Q - Q1).max() <= 1e-5
    assert np.abs(R / scale - R1).max() <= 2e-5 * np.abs(R1).max()


def test_refusals_on_ranks():
    out = run_ranks(ranks.refusals_body, 2, backend="gloo", device="cpu",
                    timeout=120)
    for r in out:
        assert "multiple of the mesh size" in r["uneven"]
        assert "do not split" in r["uneven_put"]
        for tag in ("", "_bqrrp", "_hqrrp", "_hqrrp_lapack_format",
                    "_abrik"):
            assert "no mesh with that axis" in r["no_mesh" + tag], tag
            assert "no mesh with that axis" in r["other_axis" + tag], tag


def test_make_mesh_refuses_a_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(ValueError, match="no CUDA device"):
        tp.make_mesh(device="cuda")
    mesh = tp.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    x = torch.ones(3)
    assert mesh.psum(x) is x and mesh.pmax(x) is x


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        run_ranks(ranks.failing_body, 2, backend="gloo", device="cpu",
                  timeout=60)


def test_run_ranks_stops_a_hung_collective():
    with pytest.raises(RuntimeError, match="gave no result"):
        run_ranks(ranks.hanging_body, 2, backend="gloo", device="cpu",
                  timeout=12)


def test_run_ranks_takes_an_explicit_backend():
    with pytest.raises(TypeError):
        run_ranks(ranks.failing_body, 2, device="cpu")
    with pytest.raises(ValueError, match="'gloo' or 'nccl'"):
        run_ranks(ranks.failing_body, 2, backend="mpi", device="cpu")
