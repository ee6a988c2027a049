"""The panel schedule of K3's blocked kernel (csrc/getrfnp.cu), modelled in
plain PyTorch by ``ops.lu.getrfnp_schedule``, against the JAX package's
recursive ``getrfnp``, its Pallas kernel ``getrfnp_pallas`` in interpret
mode (k <= 96, which keeps it to about a second a call) and the port's
plain ``getrfnp``, on the CPU. The kernel itself is held against the model
on the card (tests/test_torch_cuda.py).

Inputs are orthonormal blocks (numpy seeds) and the 2x2-rotation block
of tests/test_torch_wy_lu.py, on which a fixed sign choice is exactly
singular. Gates: s exactly equal; max|dF| within 1e-12 (f64) / 1e-5
(f32) of every reference: the model takes each entry's terms in the
elimination's order, the recursion sums them in blocked products, so
they differ by rounding that the pivots (|u_jj| >= 1) do not grow;
||L·U − (M − diag s)|| within 1e-13 (f64) / 1e-5 (f32); min|u_jj| >= 1 − eps-scale."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu.ops import householder as jhh
from randlapack_tpu.ops.pallas_lu import getrfnp_pallas

from randlapack_tpu_torch.ops import lu as tlu

DTYPES = {"float32": (np.float32, 1e-5, 1e-5),
          "float64": (np.float64, 1e-12, 1e-13)}


def _orthonormal(k, seed):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.standard_normal((k, k)))[0]


def _rotations(blocks=8, th=0.7):
    R2 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return np.kron(np.eye(blocks), R2)


def _check(M, refs, nb, dtype):
    """The model of ``M`` against each (F, s) of ``refs``, and its own
    invariants."""
    _, tol, res_tol = DTYPES[dtype]
    F, s = tlu.getrfnp_schedule(torch.tensor(M), nb)
    for Fr, sr in refs:
        np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
        assert np.abs(F.numpy() - np.asarray(Fr)).max() <= tol
    k = M.shape[0]
    L = torch.tril(F, -1) + torch.eye(k, dtype=F.dtype)
    U = torch.triu(F)
    res = (L @ U - (torch.tensor(M) - torch.diag(s))).abs().max()
    assert float(res) <= res_tol
    eps = float(torch.finfo(F.dtype).eps)
    assert float(U.diagonal().abs().min()) >= 1.0 - 8 * eps


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 31, 32, 33, 96, 200])
def test_schedule_matches_jax_and_plain(dtype, k):
    M = _orthonormal(k, k).astype(DTYPES[dtype][0])
    refs = [jhh.getrfnp(jnp.asarray(M)), tlu.getrfnp(torch.tensor(M))]
    _check(M, refs, tlu.NB, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 31, 32, 33, 96])
def test_schedule_matches_the_pallas_kernel(dtype, k):
    M = _orthonormal(k, 7 * k).astype(DTYPES[dtype][0])
    _check(M, [getrfnp_pallas(jnp.asarray(M), interpret=True)], tlu.NB,
           dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_schedule_on_the_adversarial_rotations(dtype):
    """Q·S_fixed has an eigenvalue exactly 1 here; the adaptive signs
    keep every pivot >= 1 in all four versions."""
    M = _rotations().astype(DTYPES[dtype][0])
    refs = [jhh.getrfnp(jnp.asarray(M)), tlu.getrfnp(torch.tensor(M)),
            getrfnp_pallas(jnp.asarray(M), interpret=True)]
    _check(M, refs, tlu.NB, dtype)


@pytest.mark.parametrize("nb", [1, 8, 48])
def test_schedule_does_not_depend_on_the_panel_width(nb):
    """Any panel width blocks the same elimination: the signs are equal
    and F agrees at rounding level with the kernel's width."""
    M = _orthonormal(100, 3)
    F, s = tlu.getrfnp_schedule(torch.tensor(M))
    _check(M, [(F.numpy(), s.numpy())], nb, "float64")


@pytest.mark.parametrize("wrapper", ["getrfnp_cuda", "getrfnp_flat"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """Both K3 kernels take only CUDA tensors and count only launches; a
    CPU tensor through the router takes the plain version."""
    from randlapack_tpu_torch.errors import RandLAPACKError
    before = dict(tlu.LAUNCHES)
    assert set(before) == {"getrfnp", "getrfnp_flat"}
    with pytest.raises(RandLAPACKError):
        getattr(tlu, wrapper)(torch.eye(4, dtype=torch.float32))
    F, s = tlu.getrfnp_routed(torch.eye(4, dtype=torch.float32))
    assert torch.equal(s, -torch.ones(4))
    assert tlu.LAUNCHES == before
