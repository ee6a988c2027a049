"""The port's kernel modules (randlapack_tpu_torch.ops.wy / .lu) and the
Householder reconstruction built on them, against the JAX package on the
CPU in f64 (the kernels themselves are held against these plain versions
on the card by tests/test_torch_cuda.py).

On the CPU the routed functions take the plain versions; the JAX side
runs as its own CPU tests run it (its routers take the jnp references).
Tolerance 1e-12 relative: the inputs are orthonormal blocks or Gaussian
matrices, so summation order (MKL vs XLA) moves results by a few ulps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu.ops import householder as jhh
from randlapack_tpu.ops import pallas_wy as jwy

from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.ops import householder as thh
from randlapack_tpu_torch.ops import lu as tlu
from randlapack_tpu_torch.ops import wy as twy


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _orthonormal(k, seed):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.standard_normal((k, k)))[0]


def _rotations(blocks=8, th=0.7):
    R2 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return np.kron(np.eye(blocks), R2)


# -- getrfnp (plain version behind K3) ---------------------------------------

@pytest.mark.parametrize("k", [4, 32, 48, 96])
def test_getrfnp_parity_and_invariants(k):
    Q = _orthonormal(k, k)
    Fj, sj = jhh.getrfnp(jnp.asarray(Q))
    Ft, st = tlu.getrfnp(torch.tensor(Q))
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    assert _rel(Ft, Fj) < 1e-12
    L = torch.tril(Ft, -1) + torch.eye(k, dtype=Ft.dtype)
    U = torch.triu(Ft)
    assert float(torch.linalg.norm(L @ U - (torch.tensor(Q)
                                            - torch.diag(st)))) < 1e-13
    assert float(U.diagonal().abs().min()) >= 1.0 - 1e-12


def test_getrfnp_adversarial_rotation():
    """Q1·S_fixed has an eigenvalue exactly 1 here; adaptive signs hold."""
    Q = _rotations()
    Fj, sj = jhh.getrfnp(jnp.asarray(Q))
    Ft, st = thh.getrfnp(torch.tensor(Q))
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    assert _rel(Ft, Fj) < 1e-12
    assert float(torch.triu(Ft).diagonal().abs().min()) >= 1.0 - 1e-12


def test_getrfnp_cuda_wrapper_refuses_cpu_tensors():
    before = dict(tlu.LAUNCHES)
    with pytest.raises(RandLAPACKError):
        tlu.getrfnp_cuda(torch.eye(4, dtype=torch.float64))
    F, s = tlu.getrfnp_routed(torch.eye(4, dtype=torch.float64))
    assert torch.equal(s, -torch.ones(4, dtype=torch.float64))
    assert tlu.LAUNCHES == before


# -- orhr_col ------------------------------------------------------------

@pytest.mark.parametrize("m,b,c", [(40, 6, 9), (64, 64, 0),
                                   (100, 50, 50), (96, 32, 33)])
def test_orhr_col_parity_and_invariants(m, b, c):
    rng = np.random.default_rng(m + b)
    A = rng.standard_normal((m, b))
    A[:c] = 0.0
    Q = np.linalg.qr(A)[0]
    Vj, Tj, sj = jhh.orhr_col(jnp.asarray(Q), c)
    Vt, Tt, st = thh.orhr_col(torch.tensor(Q), c)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    assert _rel(Vt, Vj) < 1e-12 and _rel(Tt, Tj) < 1e-12
    H = torch.eye(m, dtype=Vt.dtype) - Vt @ Tt @ Vt.T
    assert float(torch.linalg.norm(H.T @ H - torch.eye(m,
                                                       dtype=H.dtype))) < 1e-12
    assert float(torch.linalg.norm(H[:, c:c + b] - torch.tensor(Q) * st)) \
        < 1e-12
    assert float(torch.linalg.norm(torch.tril(Tt, -1))) == 0.0
    assert float(torch.linalg.norm(Vt[:c])) < 1e-13


def test_orhr_col_square_orthogonal_block():
    Q = _rotations()
    Vj, Tj, sj = jhh.orhr_col(jnp.asarray(Q), 0)
    Vt, Tt, st = thh.orhr_col(torch.tensor(Q), 0)
    assert _rel(Vt, Vj) < 1e-12 and _rel(Tt, Tj) < 1e-12
    H = torch.eye(16, dtype=Vt.dtype) - Vt @ Tt @ Vt.T
    assert float(torch.linalg.norm(H - torch.tensor(Q) * st)) < 1e-12


# -- K1 / K2 plain versions ----------------------------------------------

def _wy_operands(m, w, k, seed, nan_under_mask=False):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((m, k))
    A = rng.standard_normal((m, w))
    Z = rng.standard_normal((k, w))
    mask = (rng.random(w) < 0.6).astype(np.float64)
    if nan_under_mask:
        A[1, np.nonzero(mask == 0)[0][0]] = np.nan
    return V, A, Z, mask


@pytest.mark.parametrize("m,w,k", [(64, 48, 8), (130, 77, 33)])
def test_wy_plain_versions_match_jax(m, w, k):
    V, A, Z, mask = _wy_operands(m, w, k, m)
    Wj = jwy.masked_vt_a_reference(jnp.asarray(V), jnp.asarray(A),
                                   jnp.asarray(mask))
    Wt = twy.masked_vt_a_reference(*map(torch.tensor, (V, A, mask)))
    assert _rel(Wt, Wj) < 1e-12
    Uj = jwy.a_minus_vz_masked_reference(*map(jnp.asarray, (A, V, Z, mask)))
    Ut = twy.a_minus_vz_masked_reference(*map(torch.tensor, (A, V, Z, mask)))
    assert _rel(Ut, Uj) < 1e-12


def test_masked_vt_a_multiplies_the_mask():
    """A non-finite entry under mask 0 gives NaN on both sides (A*mask,
    not a skipped column)."""
    V, A, _, mask = _wy_operands(32, 20, 4, 1, nan_under_mask=True)
    Wj = np.asarray(jwy.masked_vt_a_reference(jnp.asarray(V),
                                              jnp.asarray(A),
                                              jnp.asarray(mask)))
    Wt = twy.masked_vt_a_routed(*map(torch.tensor, (V, A, mask))).numpy()
    np.testing.assert_array_equal(np.isnan(Wj), np.isnan(Wt))
    assert np.isnan(Wt).any()


def test_routed_updates_in_place_on_cpu():
    V, A, Z, mask = _wy_operands(40, 30, 12, 2)
    At = torch.tensor(A)
    before = dict(twy.LAUNCHES)
    out = twy.a_minus_vz_masked_mixed(At, torch.tensor(V), torch.tensor(Z),
                                      torch.tensor(mask))
    assert out is At
    np.testing.assert_array_equal(
        At.numpy(), twy.a_minus_vz_masked_reference(
            *map(torch.tensor, (A, V, Z, mask))).numpy())
    assert twy.LAUNCHES == before        # the CPU path launches nothing


@pytest.mark.parametrize("tp", ["default", "high", "bf16_3x_emul",
                                "no_such_mode"])
def test_only_highest_trailing_precision(tp):
    """The modes other than "highest" were refused before they were
    ported; now each runs, on the CPU as the JAX package's mixed
    functions do: "high" and "default" are the "highest" products, bit for
    bit, and "bf16_3x_emul" (like any other string) ``bf16_3x_matmul``,
    within fp32 accumulation (1e-6) of the JAX function."""
    V, A, Z, mask = _wy_operands(8, 8, 2, 3)
    Vt, At, Zt, mt = map(torch.tensor, (V, A, Z, mask))
    W = twy.masked_vt_a_mixed(Vt, At, mt, tp)
    Wj = jwy.masked_vt_a_mixed(*map(jnp.asarray, (V, A, mask)), tp)
    A2 = twy.a_minus_vz_masked_mixed(At.clone(), Vt, Zt, mt, tp)
    Aj = jwy.a_minus_vz_masked_mixed(*map(jnp.asarray, (A, V, Z, mask)), tp)
    if tp in ("default", "high"):
        assert torch.equal(W, twy.masked_vt_a_mixed(Vt, At, mt))
        assert torch.equal(A2, twy.a_minus_vz_masked_mixed(At.clone(), Vt,
                                                           Zt, mt))
        tol = 1e-12
    else:
        assert torch.equal(W, twy.masked_vt_a_bf16x3_reference(Vt, At, mt))
        tol = 1e-6
    assert _rel(W, Wj) <= tol and _rel(A2, Aj) <= tol


def test_kernel_wrappers_refuse_cpu_tensors():
    V, A, Z, mask = map(torch.tensor, _wy_operands(8, 8, 2, 4))
    with pytest.raises(RandLAPACKError):
        twy.masked_vt_a(V, A, mask)
    with pytest.raises(RandLAPACKError):
        twy.a_minus_vz_masked(A, V, Z, mask)
