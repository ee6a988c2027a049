"""The port's row-sharded explicit BQRRP (dist_bqrrp), HQRRP (dist_hqrrp,
with Householder and CholQR panels, and hqrrp_lapack_format) and ABRIK
(dist_abrik, "geqrf" and an early stop on tol) against the JAX package's
on its 8-device CPU mesh, in f64, at p = 1, 2 and 4 gloo ranks on the
CPU, JAX's draws injected (the sketches' and G's column blocks, ABRIK's
start and its m-side sketches' column blocks).

Gates: J (and ABRIK's iteration count) equal; Q's and U's rows, R,
packed, taus and S within 1e-10 of JAX's largest entry, Vt with each
row's sign aligned to JAX's (U's columns take the same signs); replicated
outputs bit-equal on every rank; one rank bit-equal to the unsharded port
driver; J equal and R (S) within 1e-10 across the world sizes, with the
draws injected and with the draws left to the port. The explicit BQRRP
in "bf16_3x_emul" splits Q_panel and T into bf16 halves and drops lo·lo,
so a last-bit change in either moves the update by up to 2⁻¹⁶ of an
entry, and Q's late columns by that times the panels' conditioning
(7.7e-4 here): there J is equal, R within 2⁻¹⁶ of JAX's largest entry
(and across world sizes), Q·R − A[:, J] at most twice JAX's residual
and ‖QᵀQ − I‖_F ≤ 1e-13.
The 192×96, b 32 cases put the rows [32, 64) of the second block across
ranks 0 and 1 at p = 4.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.gen import MatGenInfo, MatType, fast_decay_matrix, mat_gen

import _torch_parallel_ranks as ranks
from randlapack_tpu_torch.parallel import run_ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

WORLDS = (1, 2, 4)
TOL = 1e-10
BF16X3_TOL = 2.0 ** -16


def _gaussian(seed, d, m):
    """BQRRP's sketch as the JAX bqrrp draws it."""
    key, _ = JRNG(seed).spawn()
    return np.asarray(jax.random.normal(key, (d, m), dtype=jnp.float64)
                      / math.sqrt(d))


def _uniform(seed, d, m):
    """HQRRP's operator G as the JAX hqrrp draws it."""
    key, _ = JRNG(seed).spawn()
    return np.asarray(jax.random.uniform(key, (d, m), dtype=jnp.float64,
                                         minval=-1.0, maxval=1.0))


def _abrik_draws(seed, m, n, b, q, qr):
    """ABRIK's start and its 2q unscaled sketches as the JAX abrik draws
    them (entry 1 unused)."""
    key, st = JRNG(seed).spawn()
    v0 = np.asarray(jax.random.normal(key, (n, b), dtype=jnp.float64))
    if qr == "geqrf":
        return v0, None
    kq, _ = st.spawn()
    keys = jax.random.split(kq, 2 * q)
    sk = []
    for i in range(2 * q):
        rows = n if (i % 2 == 0 and i > 0) else m
        d = min(rows, int(math.ceil(1.25 * b)))
        sk.append(None if i == 1 else np.asarray(jax.random.normal(
            keys[i], (d, rows), dtype=jnp.float64)))
    return v0, sk


def _cases():
    A1, _ = mat_gen(MatGenInfo(192, 96, MatType.polynomial, cond_num=1e5),
                    JRNG(31))
    A2, _ = mat_gen(MatGenInfo(200, 100, MatType.exponential,
                               cond_num=1e5), JRNG(33))
    A3, _ = mat_gen(MatGenInfo(128, 160, MatType.polynomial, cond_num=1e4),
                    JRNG(35))
    A4, _ = mat_gen(MatGenInfo(128, 96, MatType.polynomial, cond_num=1e5),
                    JRNG(33))
    bq = {}
    for tag, A, seed, kw in (
            ("straddle", A1, 32, dict(block_size=32)),
            ("remainder", A2, 34, dict(block_size=32)),
            ("wide_stages2", A3, 36, dict(block_size=32, stages=2)),
            ("straddle_bf16x3", A1, 32, dict(
                block_size=32, trailing_precision="bf16_3x_emul"))):
        b = min(kw["block_size"], *A.shape)
        bq[tag] = dict(A=np.asarray(A), seed=seed, kw=kw,
                       S=_gaussian(seed, int(1.25 * b), A.shape[0]))
    hq = {}
    for tag, A, seed in (("tall", A4, 34), ("straddle", A1, 38)):
        for panel in ("qrcp", "cholqr"):
            hq[f"{tag}_{panel}"] = dict(
                A=np.asarray(A), seed=seed, b=32, panel=panel,
                G=_uniform(seed, 32 + 10, A.shape[0]))
    B, _ = fast_decay_matrix(256, 128, JRNG(7), dtype=jnp.float64,
                             decay=6.0)
    ab = {}
    for tag, qr, q, tol in (("cqrrt", "cqrrt", 4, 0.0),
                            ("geqrf", "geqrf", 4, 0.0),
                            ("tol", "cqrrt", 6, 0.1)):
        v0, sk = _abrik_draws(8, 256, 128, 16, q, qr)
        ab[tag] = dict(A=np.asarray(B), seed=8, k=32, tol=tol, v0=v0, sk=sk,
                       kw=dict(block_size=16, max_iters=q, qr_explicit=qr))
    return {"bqrrp": bq, "hqrrp": hq, "abrik": ab}


def _jax_runs(cases):
    """JAX's results: its dist_bqrrp, dist_hqrrp and dist_abrik where the
    case is their configuration, else the driver with ``shard_axis`` under
    ``jax.sharding.set_mesh``, on the 8-device mesh."""
    from randlapack_tpu.drivers import (ABRIKConfig, BQRRPConfig,
                                        HQRRPConfig, PanelQR, abrik, bqrrp,
                                        hqrrp, hqrrp_lapack_format)
    from randlapack_tpu.parallel import (dist_abrik, dist_bqrrp, dist_hqrrp,
                                         make_mesh, row_sharded)
    mesh = make_mesh(8)

    def put(A):
        return jax.device_put(jnp.asarray(A), row_sharded(mesh))

    def done(out):
        jax.block_until_ready(out)
        return {k: np.asarray(v) for k, v in out.items()}
    out = {}
    for tag, c in cases["bqrrp"].items():
        A, st, kw = put(c["A"]), JRNG(c["seed"]), c["kw"]
        if set(kw) <= {"block_size", "stages"}:
            res = dist_bqrrp(A, mesh, st, **kw)
        else:
            with jax.sharding.set_mesh(mesh):
                res = bqrrp(A, BQRRPConfig(shard_axis="rows", **kw), st)
        out[tag] = done(dict(zip(("Q", "R", "J", "rank", "fail"), res)))
    for tag, c in cases["hqrrp"].items():
        A, st = put(c["A"]), JRNG(c["seed"])
        cfg = HQRRPConfig(block_size=c["b"], panel_qr=PanelQR(c["panel"]),
                          shard_axis="rows")
        if c["panel"] == "qrcp":
            res = dist_hqrrp(A, mesh, st, block_size=c["b"])
        else:
            with jax.sharding.set_mesh(mesh):
                res = hqrrp(A, cfg, st)
        with jax.sharding.set_mesh(mesh):
            packed, taus = hqrrp_lapack_format(A, cfg, st)[:2]
        out[tag] = done(dict(zip(("Q", "R", "J", "rank", "fail"), res),
                             packed=packed, taus=taus))
    for tag, c in cases["abrik"].items():
        A, st, kw = put(c["A"]), JRNG(c["seed"]), c["kw"]
        if kw["qr_explicit"] == "cqrrt" and not c["tol"]:
            res = dist_abrik(A, c["k"], mesh, st, block_size=kw["block_size"],
                             max_iters=kw["max_iters"])
        else:
            with jax.sharding.set_mesh(mesh):
                res = abrik(A, c["k"], ABRIKConfig(shard_axis="rows", **kw),
                            st, tol=c["tol"])
        U, S, Vt, info, _ = res
        out[tag] = done(dict(U=U, S=S, Vt=Vt, iters=info["num_krylov_iters"],
                             capture=info["capture"]))
    return out


@pytest.fixture(scope="module")
def runs():
    # JAX's side first, each call waited for: its 8 device threads meet in
    # every collective, and this process's ranks would compete with them
    cases = _cases()
    jx = _jax_runs(cases)
    port = {p: run_ranks(ranks.qr_body, p, cases, backend="gloo",
                         device="cpu", timeout=300) for p in WORLDS}
    return cases, jx, port


def _stack(res, tag, key):
    return np.concatenate([r[tag][key] for r in res])


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


BQ = ("straddle", "remainder", "wide_stages2", "straddle_bf16x3")
HQ = ("tall_qrcp", "tall_cholqr", "straddle_qrcp", "straddle_cholqr")
AB = ("cqrrt", "geqrf", "tol")


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("tag", BQ)
def test_bqrrp_matches_jax(runs, tag, p):
    _, jx, port = runs
    res, j = port[p], jx[tag]
    r = res[0][tag]
    np.testing.assert_array_equal(r["J"], j["J"])
    assert bool(r["fail"]) == bool(j["fail"]) and int(r["rank"]) == j["rank"]
    Q = _stack(res, tag, "Q")
    assert r["counter"] == 1
    if not tag.endswith("bf16x3"):
        assert _rel(r["R"], j["R"]) <= TOL
        assert _rel(Q, j["Q"]) <= TOL
        return
    # Q's late columns move by 2⁻¹⁶ times the panels' conditioning (7.7e-4
    # of JAX's largest entry here): the factorization is held instead
    A = runs[0]["bqrrp"][tag]["A"]
    assert _rel(r["R"], j["R"]) <= BF16X3_TOL
    assert _residual(Q, r["R"], r["J"], A) <= 2 * _residual(
        j["Q"], j["R"], j["J"], A)
    assert np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1])) <= 1e-13


def _residual(Q, R, J, A):
    return np.linalg.norm(Q @ R - A[:, J]) / np.linalg.norm(A)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("tag", HQ)
def test_hqrrp_matches_jax(runs, tag, p):
    _, jx, port = runs
    res, j = port[p], jx[tag]
    r = res[0][tag]
    np.testing.assert_array_equal(r["J"], j["J"])
    assert bool(r["fail"]) == bool(j["fail"]) and int(r["rank"]) == j["rank"]
    for key in ("R", "taus"):
        assert _rel(r[key], j[key]) <= TOL, key
    for key in ("Q", "packed"):
        assert _rel(_stack(res, tag, key), j[key]) <= TOL, key
    assert r["counter"] == 1


def _row_signs(ref, x):
    s = np.sign(np.sum(ref * x, axis=1))
    return np.where(s == 0, 1.0, s)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("tag", AB)
def test_abrik_matches_jax(runs, tag, p):
    _, jx, port = runs
    res, j = port[p], jx[tag]
    r = res[0][tag]
    assert r["iters"] == int(j["iters"])
    if tag == "tol":
        assert r["iters"] < runs[0]["abrik"][tag]["kw"]["max_iters"]
    assert np.abs(r["S"] - j["S"]).max() <= TOL * j["S"][0]
    assert _rel(r["capture"], j["capture"]) <= TOL
    sg = _row_signs(j["Vt"], r["Vt"])
    assert _rel(r["Vt"] * sg[:, None], j["Vt"]) <= TOL
    assert _rel(_stack(res, tag, "U") * sg[None, :], j["U"]) <= TOL
    assert r["counter"] == (1 if tag == "geqrf" else 2)


REPLICATED = {**{t: ("R", "J", "rank", "fail") for t in BQ},
              **{t: ("R", "J", "rank", "fail", "taus") for t in HQ},
              **{t: ("S", "Vt", "iters", "capture") for t in AB},
              "drawn_bqrrp": ("R", "J"), "drawn_hqrrp": ("R", "J"),
              "drawn_abrik": ("S", "Vt")}


@pytest.mark.parametrize("p", (2, 4))
def test_replicated_outputs_bit_equal_across_ranks(runs, p):
    res = runs[2][p]
    for tag, keys in REPLICATED.items():
        for key in keys:
            for r in res[1:]:
                assert np.array_equal(r[tag][key], res[0][tag][key]), \
                    (tag, key)


@pytest.mark.parametrize("tag", (*BQ, *HQ, *AB))
def test_one_rank_is_the_unsharded_driver_bit_for_bit(runs, tag):
    r = runs[2][1][0][tag]
    for key, v in r["single"].items():
        assert np.array_equal(r[key], v), key


@pytest.mark.parametrize("tag", (*BQ, *HQ, *AB, "drawn_bqrrp",
                                 "drawn_hqrrp", "drawn_abrik"))
def test_world_size_does_not_change_the_result(runs, tag):
    port = runs[2]
    r1 = port[1][0][tag]
    tol = BF16X3_TOL if tag.endswith("bf16x3") else TOL
    for p in (2, 4):
        r = port[p][0][tag]
        if "J" in r1:
            np.testing.assert_array_equal(r["J"], r1["J"])
            assert _rel(r["R"], r1["R"]) <= tol
        else:
            assert np.abs(r["S"] - r1["S"]).max() <= TOL * r1["S"][0]
            sg = _row_signs(r1["Vt"], r["Vt"])
            assert _rel(r["Vt"] * sg[:, None], r1["Vt"]) <= TOL
