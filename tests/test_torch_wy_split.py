"""The fp32-by-three-TF32-products arithmetic of the port's K1/K2 kernels
(randlapack_tpu_torch.ops.wy), in its plain PyTorch form, on the CPU.

On the card the f32 kernels split every operand into two TF32 halves and
take three tensor-core products per fp32 product; ``_split_tf32`` and the
``*_split_reference`` functions are that arithmetic with ordinary tensor
operations (the kernels are held against them by tests/test_torch_cuda.py).
Here they are held against f64 and against the JAX package's references.

Tolerances: the split loses at most 2⁻²¹ of |x| (two roundings to 11
significant bits); a three-product result must stay within 4× the error
of the fp32 ``@`` product, both measured against the f64 product in the
Frobenius norm."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu.ops import pallas_wy as jwy

from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.ops import wy as twy


def _operands(m, w, k, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((m, k)).astype(f32),
            rng.standard_normal((m, w)).astype(f32),
            rng.standard_normal((k, w)).astype(f32),
            (rng.random(w) < 0.6).astype(f32))


def _relf(x, ref):
    return float(torch.linalg.norm(x.double() - ref)
                 / torch.linalg.norm(ref))


def _low_bits(t):
    return t.view(torch.int32) & 0x1FFF


@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e20])
def test_split_halves_sum_to_x(scale):
    rng = np.random.default_rng(0)
    x = torch.tensor((rng.standard_normal(4096) * scale
                      * np.exp(4 * rng.standard_normal(4096)))
                     .astype(np.float32))
    hi, lo = twy._split_tf32(x)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    # hi alone is x to 11 significant bits, lo is the small half
    assert bool(((hi - x).abs() <= 2.0 ** -11 * x.abs()).all())
    assert bool((lo.abs() <= 2.0 ** -11 * x.abs() * (1 + 2.0 ** -10)).all())


def test_split_halves_are_tf32_values():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal(4096).astype(np.float32))
    hi, lo = twy._split_tf32(x)
    assert int(_low_bits(hi).abs().max()) == 0
    assert int(_low_bits(lo).abs().max()) == 0


def test_split_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)              # TF32 spacing in [1, 2)
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 0.0, -0.0], dtype=torch.float32)
    hi, _ = twy._split_tf32(x)
    expect = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 0.0,
                           -0.0], dtype=torch.float32)
    assert torch.equal(hi, expect)
    assert bool(torch.signbit(hi[5])) and not bool(torch.signbit(hi[4]))


def test_split_of_non_finite_values():
    x = torch.tensor([float("inf"), float("-inf"), float("nan")])
    hi, lo = twy._split_tf32(x)
    assert torch.equal(hi[:2], x[:2]) and bool(torch.isnan(hi[2]))
    assert bool(torch.isnan(lo).all())        # Inf − Inf = NaN


def test_split_refuses_other_dtypes():
    with pytest.raises(RandLAPACKError):
        twy._split_tf32(torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("m,w,k", [(513, 1025, 200), (96, 64, 32)])
def test_three_products_hold_fp32_accuracy(m, w, k):
    V, A, Z, mask = map(torch.tensor, _operands(m, w, k, m + w))
    Vd, Ad, Zd, md = (t.double() for t in (V, A, Z, mask))
    ref1 = Vd.T @ (Ad * md)
    e_split = _relf(twy.masked_vt_a_split_reference(V, A, mask), ref1)
    e_plain = _relf(twy.masked_vt_a_reference(V, A, mask), ref1)
    assert e_split <= 4 * e_plain
    ref2 = Ad - (Vd @ Zd) * md
    e_split = _relf(twy.a_minus_vz_masked_split_reference(A, V, Z, mask),
                    ref2)
    e_plain = _relf(twy.a_minus_vz_masked_reference(A, V, Z, mask), ref2)
    assert e_split <= 4 * e_plain


def test_one_tf32_product_does_not_hold_it():
    """What the split is for: hi·hi alone is three orders worse."""
    V, A, _, mask = map(torch.tensor, _operands(513, 1025, 200, 3))
    ref = V.double().T @ (A.double() * mask.double())
    Vh, _ = twy._split_tf32(V)
    Ah, _ = twy._split_tf32(A * mask)
    assert _relf(Vh.T @ Ah, ref) \
        > 100 * _relf(twy.masked_vt_a_split_reference(V, A, mask), ref)


@pytest.mark.parametrize("m,w,k", [(64, 48, 8), (130, 77, 33)])
def test_split_references_match_jax(m, w, k):
    """Against the JAX package's references (fp32 at HIGHEST on the CPU):
    a few units of fp32 roundoff on sums of k (m) terms."""
    V, A, Z, mask = _operands(m, w, k, m)
    Wj = np.asarray(jwy.masked_vt_a_reference(*map(jnp.asarray,
                                                   (V, A, mask))))
    Wt = twy.masked_vt_a_split_reference(*map(torch.tensor, (V, A, mask)))
    assert np.abs(Wt.numpy() - Wj).max() <= 1e-5 * np.abs(Wj).max()
    Uj = np.asarray(jwy.a_minus_vz_masked_reference(
        *map(jnp.asarray, (A, V, Z, mask))))
    Ut = twy.a_minus_vz_masked_split_reference(
        *map(torch.tensor, (A, V, Z, mask)))
    assert np.abs(Ut.numpy() - Uj).max() <= 1e-5 * np.abs(Uj).max()


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_split_references_keep_the_non_finite_pattern(bad):
    """An Inf may come out NaN, but the finite/non-finite pattern is the
    plain version's, under mask 1 and under mask 0 (A·mask, not a skip)."""
    V, A, Z, mask = map(torch.tensor, _operands(40, 24, 12, 5))
    live = int(torch.nonzero(mask == 1)[0])
    dead = int(torch.nonzero(mask == 0)[0])
    A1 = A.clone()
    A1[3, live] = bad
    A1[7, dead] = bad
    Ws = twy.masked_vt_a_split_reference(V, A1, mask)
    Wp = twy.masked_vt_a_reference(V, A1, mask)
    assert torch.equal(torch.isfinite(Ws), torch.isfinite(Wp))
    assert not bool(torch.isfinite(Ws[:, dead]).any())   # bad·0 = NaN
    Z1 = Z.clone()
    Z1[2, live] = bad
    Z1[4, dead] = bad
    Us = twy.a_minus_vz_masked_split_reference(A, V, Z1, mask)
    Up = twy.a_minus_vz_masked_reference(A, V, Z1, mask)
    assert torch.equal(torch.isfinite(Us), torch.isfinite(Up))


@pytest.mark.parametrize("m,w,k", [(0, 5, 3), (4, 0, 3), (4, 5, 0)])
def test_split_references_take_zero_size_operands(m, w, k):
    V, A, Z, mask = map(torch.tensor, _operands(m, w, k, 0))
    W = twy.masked_vt_a_split_reference(V, A, mask)
    assert W.shape == (k, w) and not bool(W.any())
    U = twy.a_minus_vz_masked_split_reference(A, V, Z, mask)
    assert U.shape == (m, w) and torch.equal(U, A)


def test_masked_vt_a_splits_fill_the_card():
    """The reduction is split only where the output has too few tiles,
    never into parts shorter than 512 rows, and by the shapes alone."""
    assert twy.masked_vt_a_splits(8192, 256, 8192, 132) == 1
    assert twy.masked_vt_a_splits(8192, 256, 4096, 132) == 2
    assert twy.masked_vt_a_splits(8192, 256, 256, 132) == 16
    assert twy.masked_vt_a_splits(300, 256, 256, 132) == 1
    assert twy.masked_vt_a_splits(65536, 200, 1900, 132) == 4
    assert twy.masked_vt_a_splits(8192, 2048, 8192, 132) == 1


def test_takes_tensor_cores_by_dtype_and_row_length():
    f32 = torch.float32
    assert twy.takes_tensor_cores(torch.zeros(8, 12, dtype=f32),
                                  torch.zeros(12, dtype=f32))
    assert not twy.takes_tensor_cores(torch.zeros(8, 13, dtype=f32))
    assert not twy.takes_tensor_cores(torch.zeros(8, 12,
                                                  dtype=torch.float64))
    # a view that starts 4 bytes into its storage is not 16-byte aligned
    assert not twy.takes_tensor_cores(torch.zeros(17, dtype=f32)[1:])


def test_simt_wrappers_refuse_cpu_tensors():
    V, A, Z, mask = map(torch.tensor, _operands(8, 8, 4, 4))
    before = dict(twy.LAUNCHES)
    with pytest.raises(RandLAPACKError):
        twy.masked_vt_a_simt(V, A, mask)
    with pytest.raises(RandLAPACKError):
        twy.a_minus_vz_masked_simt(A, V, Z, mask)
    assert twy.LAUNCHES == before
