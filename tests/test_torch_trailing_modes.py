"""The port's trailing-precision modes (``trailing_precision`` "high",
"default" and "bf16_3x_emul" of BQRRP, HQRRP and CQRRPT's sketch BQRRP)
against the JAX package on the CPU.

On the CPU "high" and "default" are the "highest" products (XLA's CPU
dot ignores the precision, and so does the port there), and
"bf16_3x_emul" is ``bf16_3x_matmul`` in both packages: bf16 halves of
each operand, three products accumulated in fp32. The halves are compared
bit for bit; a product within 1e-6 relative (fp32 accumulation in two
summation orders); the mixed K1/K2 functions within 1e-5 of max|W| in f32
and 1e-12 (the fp64 modes) or 1e-6 (bf16_3x_emul) in f64. The drivers
run at the JAX tests' own sizes (512² f32, tests/test_bqrrp_factored.py
``TestTrailingPrecision``, tests/test_hqrrp.py
``TestHQRRPTrailingPrecision``) with the JAX-drawn sketch injected: J
equal and R's rows within 1e-4 of max|R| on the leading half of the
pivots (``_hold`` says why not past it), and the JAX tests' gates on the
port (residual < 3e-5, ‖QᵀQ − I‖_F < 1e-4, HQRRP < 1e-3, ``fail``
False). The JAX results are computed once per module.
The kernels' forms are held against the ``*_reference`` functions on the
card (tests/test_torch_cuda.py, chip_smoke.py's ``[wy-modes]``).
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.drivers import BQRRPConfig as JBCfg
from randlapack_tpu.drivers import HQRRPConfig as JHCfg
from randlapack_tpu.drivers import bqrrp as j_bqrrp
from randlapack_tpu.drivers import bqrrp_factored as j_factored
from randlapack_tpu.drivers import hqrrp as j_hqrrp
from randlapack_tpu.gen import fast_decay_matrix as j_fast_decay
from randlapack_tpu.ops import pallas_wy as jwy

import randlapack_tpu_torch as rt
from randlapack_tpu_torch.drivers import (BQRRPConfig, CQRRPTConfig,
                                          HQRRPConfig, QRCPKind, bqrrp,
                                          bqrrp_factored, bqrrp_q, cqrrpt,
                                          hqrrp)
from randlapack_tpu_torch.ops import util as tutil
from randlapack_tpu_torch.ops import wy as twy

MODES = ("high", "default", "bf16_3x_emul")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one PyTorch thread keeps them at their own
    cost beside the other test processes. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _operands(m, b, w, dtype, seed):
    """V (m,b), A (m,w), Z (b,w) with entries spread over 2^±12 and a 0/1
    mask: the bf16 halves then round at every exponent."""
    rng = np.random.default_rng(seed)

    def spread(*shape):
        return (rng.standard_normal(shape)
                * 2.0 ** rng.integers(-12, 13, shape)).astype(dtype)
    mask = (rng.random(w) < 0.6).astype(dtype)
    return spread(m, b), spread(m, w), spread(b, w), mask


# -- bf16_3x_matmul --------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16_halves_bit_equal_to_jax(dtype):
    X = _operands(48, 40, 1, dtype, 1)[0]
    X[0, :6] = [np.inf, -np.inf, np.nan, 0.0, 1e-30, -3.0e38]
    jh = jnp.asarray(X).astype(jnp.bfloat16)
    jl = (jnp.asarray(X) - jh.astype(X.dtype)).astype(jnp.bfloat16)
    th, tl = twy._bf16_halves(torch.tensor(X))
    np.testing.assert_array_equal(np.asarray(jh.astype(jnp.float32)),
                                  th.float().numpy())
    np.testing.assert_array_equal(np.asarray(jl.astype(jnp.float32)),
                                  tl.float().numpy())


@pytest.mark.parametrize("k", [1, 33, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16_3x_matmul_matches_jax(k, dtype):
    V, A, _, _ = _operands(k, 40, 24, dtype, k)
    X, Y = V.T.copy(), A
    P = twy.bf16_3x_matmul(torch.tensor(X), torch.tensor(Y))
    Pj = np.asarray(jwy.bf16_3x_matmul(jnp.asarray(X), jnp.asarray(Y)))
    assert P.dtype == torch.tensor(X).dtype
    err = np.linalg.norm(P.numpy() - Pj) / np.linalg.norm(Pj)
    assert err <= 1e-6, err
    # and it is the three products of the halves: within bf16's lo·lo
    # term of the exact product
    exact = X.astype(np.float64) @ Y.astype(np.float64)
    assert np.linalg.norm(P.numpy() - exact) <= 2.0 ** -14 * np.linalg.norm(
        np.abs(X.astype(np.float64)) @ np.abs(Y.astype(np.float64)))


# -- the mixed K1/K2 functions, per mode -------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("tp", MODES + ("no_such_mode",))
def test_mixed_functions_match_jax(tp, dtype):
    V, A, Z, mask = _operands(96, 24, 40, dtype, 7)
    tol = 1e-5 if dtype == np.float32 else (
        1e-12 if tp in ("high", "default") else 1e-6)
    W = twy.masked_vt_a_mixed(*map(torch.tensor, (V, A, mask)), tp)
    Wj = jwy.masked_vt_a_mixed(*map(jnp.asarray, (V, A, mask)), tp)
    assert _rel(W, Wj) <= tol
    At = torch.tensor(A)
    out = twy.a_minus_vz_masked_mixed(At, *map(torch.tensor, (V, Z, mask)),
                                      tp)
    Aj = jwy.a_minus_vz_masked_mixed(*map(jnp.asarray, (A, V, Z, mask)), tp)
    assert out is At and _rel(At, Aj) <= tol
    # the update itself, not only A's bulk
    assert _rel(At.numpy() - A, np.asarray(Aj) - A) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tp", ["high", "default"])
def test_high_and_default_are_highest_on_the_cpu(tp, dtype):
    V, A, Z, mask = (torch.tensor(x).to(dtype)
                     for x in _operands(64, 16, 32, np.float64, 3))
    assert twy.trailing_form(tp, A) == "highest"
    assert torch.equal(twy.masked_vt_a_mixed(V, A, mask, tp),
                       twy.masked_vt_a_mixed(V, A, mask, "highest"))
    assert torch.equal(twy.a_minus_vz_masked_mixed(A.clone(), V, Z, mask, tp),
                       twy.a_minus_vz_masked_mixed(A.clone(), V, Z, mask))
    before = dict(twy.LAUNCHES)
    twy.masked_vt_a_mixed(V, A, mask, "bf16_3x_emul")
    assert twy.LAUNCHES == before        # the CPU path launches nothing


def test_forms_as_the_card_maps_them():
    """``trailing_form`` reads a tensor's device and type only: on a CUDA
    f32 tensor each mode takes its kernel form, in f64 "high" and
    "default" take "highest"'s f64 kernels."""
    def on_card(dtype):
        return types.SimpleNamespace(device=torch.device("cuda"),
                                     dtype=dtype)
    for tp, f32, f64 in (("highest", "highest", "highest"),
                         ("high", "tf32", "highest"),
                         ("default", "bf16", "highest"),
                         ("bf16_3x_emul", "bf16x3", "bf16x3"),
                         ("no_such_mode", "bf16x3", "bf16x3")):
        assert twy.trailing_form(tp, on_card(torch.float32)) == f32
        assert twy.trailing_form(tp, on_card(torch.float64)) == f64
    assert twy.FORMS == ("tf32", "bf16", "bf16x3")


def test_form_references_round_their_operands():
    """The one-product references are the fp32 product of the rounded
    operands: TF32 by ``cvt.rna`` (as ``_split_tf32``'s hi), bf16 to
    nearest even; the three-product ones ``bf16_3x_matmul``."""
    V, A, Z, mask = (torch.tensor(x) for x in
                     _operands(64, 16, 32, np.float32, 5))
    hi = twy._split_tf32(V)[0]
    Am = A * mask[None, :]
    assert torch.equal(twy.masked_vt_a_tf32_reference(V, A, mask),
                       hi.T @ twy._split_tf32(Am)[0])
    Vb = V.to(torch.bfloat16).float()
    assert torch.equal(twy.masked_vt_a_bf16_reference(V, A, mask),
                       Vb.T @ Am.to(torch.bfloat16).float())
    assert torch.equal(twy.masked_vt_a_bf16x3_reference(V, A, mask),
                       twy.bf16_3x_matmul(V.T, Am))
    assert torch.equal(
        twy.a_minus_vz_masked_bf16_reference(A, V, Z, mask),
        A - (Vb @ Z.to(torch.bfloat16).float()) * mask[None, :])
    assert torch.equal(
        twy.a_minus_vz_masked_tf32_reference(A, V, Z, mask),
        A - (hi @ twy._split_tf32(Z)[0]) * mask[None, :])
    assert torch.equal(twy.a_minus_vz_masked_bf16x3_reference(A, V, Z, mask),
                       A - twy.bf16_3x_matmul(V, Z) * mask[None, :])


# -- the drivers in "bf16_3x_emul", against the JAX package -------------------

def _jax_matrix(seed):
    A, _ = j_fast_decay(512, 512, JRNG(seed), dtype=jnp.float32)
    return np.asarray(A)


def _normal_sketch(seed, d, m):
    """BQRRP's sketch as the JAX drivers draw it in f32
    (drivers/bqrrp.py:510-511, :905-906)."""
    key, _ = JRNG(seed).spawn()
    return torch.tensor(np.asarray(
        jax.random.normal(key, (d, m), dtype=jnp.float32) / math.sqrt(d)))


def _uniform_sketch(seed, d, m):
    """HQRRP's G as the JAX driver draws it in f32 (drivers/hqrrp.py:404)."""
    key, _ = JRNG(seed).spawn()
    return torch.tensor(np.asarray(jax.random.uniform(
        key, (d, m), dtype=jnp.float32, minval=-1.0, maxval=1.0)))


def _quality(A, Q, R, J):
    A, Q, R = (torch.tensor(np.array(x, dtype=np.float64))
               for x in (A, Q, R))
    J = torch.as_tensor(np.asarray(J))
    res = float(torch.linalg.norm(Q @ R - A[:, J]) / torch.linalg.norm(A))
    return res, float(tutil.orthogonality_check(Q))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's runs of its own trailing-precision tests, once."""
    out = {}
    A = _jax_matrix(0)
    fac, _ = j_factored(jnp.asarray(A), JBCfg(
        block_size=128, trailing_precision="bf16_3x_emul"), JRNG(1))
    out["factored"] = (A, np.asarray(fac.J), np.asarray(fac.R))
    A = _jax_matrix(2)
    _, R, J, _, _, _ = j_bqrrp(jnp.asarray(A), JBCfg(
        block_size=128, trailing_precision="bf16_3x_emul"), JRNG(3))
    out["explicit"] = (A, np.asarray(J), np.asarray(R))
    A = _jax_matrix(21)
    for defer in (1, 4):
        _, R, J, _, _, _ = j_hqrrp(jnp.asarray(A), JHCfg(
            block_size=64, update_defer=defer,
            trailing_precision="bf16_3x_emul"), JRNG(22))
        out[f"hqrrp{defer}"] = (A, np.asarray(J), np.asarray(R))
    return out


def _hold(jax_run, Q, R, J, fail, orth_gate):
    """J and R's rows on the leading half of the pivots against the JAX
    run, the JAX tests' gates on the whole factorization. Past the
    leading half the two packages part: a late block's pivots are chosen
    from a sketch downdated through products whose bf16 rounding noise
    (≈2⁻¹⁶ of |V·U|) is amplified by the cancellation in the small trailing
    columns, so fp32 summation order alone moves them (measured at these
    inputs: the first differing pivot at positions 491–507 of 512, and
    already at 355 for the explicit form in "highest")."""
    A, Jj, Rj = jax_run
    r = A.shape[1] // 2
    np.testing.assert_array_equal(J.numpy()[:r], Jj[:r])
    # R's leading rows in the original column order (Q[:, :r]ᵀ·A), which
    # do not depend on how the later columns were ordered
    assert _rel(R.numpy()[:r][:, np.argsort(J.numpy())],
                Rj[:r][:, np.argsort(Jj)]) <= 1e-4
    res, orth = _quality(A, Q, R, J)
    assert res < 3e-5 and orth < orth_gate, (res, orth)
    assert not bool(fail)


def test_factored_emulation_matches_jax(jax_runs):
    A = torch.tensor(jax_runs["factored"][0])
    fac, _ = bqrrp_factored(A, BQRRPConfig(
        block_size=128, trailing_precision="bf16_3x_emul"), rt.RNGState(1),
        sketch=_normal_sketch(1, 160, 512))
    _hold(jax_runs["factored"], bqrrp_q(fac), fac.R, fac.J, fac.fail, 1e-4)


def test_explicit_emulation_matches_jax(jax_runs):
    A = torch.tensor(jax_runs["explicit"][0])
    Q, R, J, _, fail, _ = bqrrp(A, BQRRPConfig(
        block_size=128, trailing_precision="bf16_3x_emul"), rt.RNGState(3),
        sketch=_normal_sketch(3, 160, 512))
    _hold(jax_runs["explicit"], Q, R, J, fail, 1e-4)


@pytest.mark.parametrize("defer", [1, 4])
def test_hqrrp_emulation_matches_jax(jax_runs, defer):
    A = torch.tensor(jax_runs[f"hqrrp{defer}"][0])
    Q, R, J, _, fail, _ = hqrrp(A, HQRRPConfig(
        block_size=64, update_defer=defer,
        trailing_precision="bf16_3x_emul"), rt.RNGState(22),
        sketch=_uniform_sketch(22, 74, 512))
    _hold(jax_runs[f"hqrrp{defer}"], Q, R, J, fail, 1e-3)


def test_unknown_mode_string_takes_the_emulation(jax_runs):
    """Any string but the three named modes is the emulation, as the JAX
    package's ``_tp_matmul`` makes it: the factored run above, bit for
    bit."""
    A = torch.tensor(jax_runs["factored"][0])
    S = _normal_sketch(1, 160, 512)
    runs = [bqrrp_factored(A, BQRRPConfig(
        block_size=128, trailing_precision=tp), rt.RNGState(1),
        sketch=S)[0] for tp in ("bf16_3x_emul", "bf16x6_not_a_mode")]
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.parametrize("qrcp", [QRCPKind.geqp3, QRCPKind.bqrrp])
def test_cqrrpt_insensitive_to_sketch_trailing(qrcp):
    """The counterpart of the JAX test of the same name (at its size and
    matrix, 4096×256 f32, decay 6): CQRRPT's R and J do not move with the
    sketch BQRRP's trailing precision. The JAX test runs the default
    sketch QRCP (geqp3), which never reads the option; the bqrrp case is
    the one the option reaches."""
    A, _ = j_fast_decay(4096, 256, JRNG(4), dtype=jnp.float32, decay=6.0)
    A = torch.tensor(np.asarray(A))
    outs = {}
    for tp in ("highest", "bf16_3x_emul"):
        _, R, J, _, fail, _ = cqrrpt(A, CQRRPTConfig(
            qrcp=qrcp, bqrrp_trailing_precision=tp), rt.RNGState(5))
        outs[tp] = (J, R)
        assert not bool(fail)
    assert torch.equal(outs["highest"][0], outs["bf16_3x_emul"][0])
    R0 = outs["highest"][1]
    assert float((outs["bf16_3x_emul"][1] - R0).abs().max()) \
        <= 1e-5 * float(R0.abs().max())
