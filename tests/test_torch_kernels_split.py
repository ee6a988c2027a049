"""The arithmetic of the f32 tensor-core kernels K4 (kernel_matmat) and K7
(gaussian_sketch) in plain PyTorch, on the CPU: the ``*_split_reference``
functions of randlapack_tpu_torch.ops.kernels, the pure helpers that size
the kernels' launches, and the defaults that send every entry point to the
card. The kernels themselves are held to these functions on the card by
tests/test_torch_cuda.py.

Tolerances. A split reference is fp32 arithmetic in another order than the
plain version's, so it is held to the f64 result: a relative Frobenius
error of at most 4x the plain f32 version's (or 4 units of fp32 roundoff
where that one happens to be nearly exact). Against the JAX package's
``kernel_matmat_reference`` and its Pallas kernel in interpret mode, on
the same numpy inputs in f32, the JAX kernel test's own tolerance (rtol
2e-5, atol 1e-5). The sketch cannot be held to the JAX kernel entry by
entry (the TPU's PRNG does not exist on the CPU), so it is held to the
checks of the JAX kernel test: norm ratio and determinism."""
import inspect
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu.ops import pallas_kernels as jk

import randlapack_tpu_torch as rt
from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.ops import kernels as tk
from randlapack_tpu_torch.ops import wy as twy


def _relf(x, ref):
    return float(torch.linalg.norm(x.double() - ref) / torch.linalg.norm(ref))


def _gate(plain_err):
    return 4 * max(plain_err, 2.0 ** -24)


def _xv(d, n, s, seed):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal((d, n)), dtype=torch.float32),
            torch.tensor(rng.standard_normal((n, s)), dtype=torch.float32))


# -- kernel_matmat_split_reference (K4's arithmetic) -------------------------

@pytest.mark.parametrize("d,n,s", [(3, 300, 1), (8, 257, 4), (17, 203, 5),
                                   (70, 130, 130), (8, 512, 1)])
def test_kernel_matmat_split_reference_holds_fp32_accuracy(d, n, s):
    """Ragged d (not a multiple of 8), s (1, 4, 5, 130) and n (not a
    multiple of 8), against the plain version in f64."""
    X, V = _xv(d, n, s, d + n + s)
    bw = 0.9 * math.sqrt(d)
    ref = tk.kernel_matmat_reference(X.double(), V.double(), bw)
    plain = _relf(tk.kernel_matmat_reference(X, V, bw), ref)
    assert _relf(tk.kernel_matmat_split_reference(X, V, bw), ref) \
        <= _gate(plain)


@pytest.mark.parametrize("d,n,s,bw", [(8, 512, 128, 1.3), (3, 300, 1, 0.7),
                                      (20, 257, 5, 4.0)])
def test_kernel_matmat_split_reference_against_the_jax_reference(d, n, s, bw):
    X, V = _xv(d, n, s, d + n)
    ref = jk.kernel_matmat_reference(jnp.asarray(X.numpy()),
                                     jnp.asarray(V.numpy()), bw)
    out = tk.kernel_matmat_split_reference(X, V, bw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=1e-5)


def test_kernel_matmat_split_reference_against_the_pallas_kernel():
    """The JAX kernel test's own shape and tolerance, the Pallas kernel in
    interpret mode."""
    X, V = _xv(8, 512, 128, 0)
    pal = jk.kernel_matmat(jnp.asarray(X.numpy()), jnp.asarray(V.numpy()),
                           1.3, interpret=True)
    out = tk.kernel_matmat_split_reference(X, V, 1.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), rtol=2e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d", [3, 8, 17])
def test_kernel_matmat_split_reference_has_a_unit_diagonal(d):
    """K·I is K itself: at the bandwidth the median heuristic gives for
    standardized points (about 1.36·√d) the folded norms and the split
    cross term cancel on the diagonal to within 1e-6 (the error is a few
    units of fp32 roundoff of ‖x′ᵢ‖²), and the clamp keeps K ≤ 1."""
    X, _ = _xv(d, 200, 1, d)
    K = tk.kernel_matmat_split_reference(X, torch.eye(200),
                                         1.36 * math.sqrt(d))
    assert float((K.diagonal() - 1).abs().max()) <= 1e-6
    assert float(K.max()) <= 1.0
    assert float((K - K.T).abs().max()) <= 1e-6


def test_kernel_matmat_split_reference_blocks_and_zero_rows():
    """Evaluating K in column blocks, or padding the points with zero
    coordinates up to a multiple of 8 as the kernel's prologue does,
    changes the result only by fp32 summation order."""
    X, V = _xv(5, 300, 4, 9)
    whole = tk.kernel_matmat_split_reference(X, V, 2.0)
    blocked = tk.kernel_matmat_split_reference(X, V, 2.0, block=64)
    padded = tk.kernel_matmat_split_reference(
        torch.cat([X, torch.zeros(3, 300)]), V, 2.0)
    scale = float(whole.abs().max())
    assert float((blocked - whole).abs().max()) <= 1e-5 * scale
    assert float((padded - whole).abs().max()) <= 1e-5 * scale
    with pytest.raises(RandLAPACKError, match="float32"):
        tk.kernel_matmat_split_reference(X.double(), V.double(), 2.0)


# -- gaussian_sketch_split_reference (K7's arithmetic) -----------------------

@pytest.mark.parametrize("m,n,d", [(2048, 256, 64), (1000, 300, 13),
                                   (515, 36, 70)])
def test_gaussian_sketch_split_reference_holds_fp32_accuracy(m, n, d):
    """Against the f64 product of the same (f32) S: within 4x the error
    of the plain fp32 product."""
    A = torch.tensor(np.random.default_rng(m + n).standard_normal((m, n)),
                     dtype=torch.float32)
    S = tk.gaussian_sketch_matrix(d, m, 11, torch.float32, "cpu")
    ref = S.double() @ A.double()
    plain = _relf(tk.gaussian_sketch_reference(A, d, 11), ref)
    assert _relf(tk.gaussian_sketch_split_reference(A, d, 11), ref) \
        <= _gate(plain)


def test_gaussian_sketch_split_reference_statistics():
    """What the JAX kernel test asks of the sketch (its shapes): the norm
    ratio, determinism, another seed differs."""
    m, n, d = 2048, 256, 64
    A = torch.tensor(np.random.default_rng(4).standard_normal((m, n)),
                     dtype=torch.float32)
    out = tk.gaussian_sketch_split_reference(A, d, 11)
    assert out.shape == (d, n) and out.dtype == torch.float32
    assert abs(float(torch.linalg.norm(out) / torch.linalg.norm(A)) - 1) < 0.1
    assert torch.equal(out, tk.gaussian_sketch_split_reference(A, d, 11))
    assert not torch.allclose(out,
                              tk.gaussian_sketch_split_reference(A, d, 12))


def test_split_sketch_carries_non_finite_columns_like_the_plain_version():
    """An Inf in A splits into Inf and NaN: the column it sits in comes
    out non-finite in both versions, and no other column does."""
    A = torch.tensor(np.random.default_rng(1).standard_normal((64, 12)),
                     dtype=torch.float32)
    A[5, 3] = float("inf")
    A[9, 7] = float("nan")
    split = tk.gaussian_sketch_split_reference(A, 8, 3)
    plain = tk.gaussian_sketch_reference(A, 8, 3)
    assert torch.equal(torch.isfinite(split), torch.isfinite(plain))
    assert not bool(torch.isfinite(split[:, 3]).any())
    assert bool(torch.isfinite(split[:, 0]).all())


# -- the helpers that size the launches --------------------------------------

@pytest.mark.parametrize("d,m,n,wave,splits", [
    (2560, 131072, 2048, 30, 3),        # 80 items a part: 240 are 8 waves
    (2560, 131072, 2048, 33, 7),        # 560 items: 17 waves, 16.97 at best
    (2560, 131072, 2048, 8, 1),         # 80 items are 10 full waves already
    (320, 8192, 8192, 30, 5),           # 48 items a part: 240 are 8 waves
    (13, 1000, 300, 30, 1),             # m too short to split
    (64, 2048, 256, 30, 2),             # 1 item: parts fill more of the card
    (128, 10**6, 128 * 4 * 30, 30, 1)])   # one full wave already
def test_gaussian_sketch_splits(d, m, n, wave, splits):
    """The split of K7's reduction depends on the shapes and the card
    alone, keeps every part at least 1024 long, never exceeds 8 and takes
    the least count among those that fill the waves equally well."""
    got = tk.gaussian_sketch_splits(d, m, n, wave)
    assert got == splits
    assert 1 <= got <= 8 and (got == 1 or m // got >= 1024)


def test_gaussian_sketch_splits_fill_the_last_wave():
    tiles, wave = 80, 30        # 20 x 16 tiles of out in clusters of 4
    z = tk.gaussian_sketch_splits(2560, 131072, 2048, wave)
    waves = -(-tiles * z // wave) / z
    assert waves < -(-tiles // wave)           # better than no split
    assert waves - tiles / wave < 0.02         # within 2 % of a full card


@pytest.mark.parametrize("n,s,rows,min_blocks,splits", [
    (65536, 1, 64, 1024, 1), (8192, 1, 64, 1024, 8), (1000, 130, 64, 1024, 7),
    (65536, 1, 256, 1024, 4), (300, 4, 256, 1024, 3)])
def test_kernel_matmat_splits_follow_the_tiling(n, s, rows, min_blocks,
                                                splits):
    """The SIMT kernel's 64-row blocks and the tensor-core kernel's
    256-row blocks split the sum over j by the same rule."""
    assert tk.kernel_matmat_splits(n, s, rows, min_blocks) == splits
    assert tk.kernel_matmat_splits(n, s, rows, min_blocks) <= -(-n // 128)


def _source_constant(source, name):
    text = (Path(tk.__file__).parents[1] / "csrc" / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, f"{name} in {source}: {found}"
    return int(found[0])


@pytest.mark.parametrize("source,name,value", [
    ("gaussian_sketch.cu", "kCluster", tk._SKETCH_CLUSTER),
    ("gaussian_sketch.cu", "BI", tk._SKETCH_TILE),
    ("gaussian_sketch.cu", "BJ", tk._SKETCH_TILE),
    ("kernel_matmat.cu", "kBI", tk._TI),
    ("kernel_matmat.cu", "kTcTJ", tk._TJ),
    ("kernel_matmat.cu", "kTI", tk._SIMT_TI),
    ("kernel_matmat.cu", "kTJ", tk._TJ),
    ("kernel_matmat.cu", "kMaxKSteps", tk._MAX_TC_D // 8)])
def test_wrapper_tiling_constants_are_the_kernel_sources(source, name, value):
    """The wrappers size scratch, splits and routes from the kernels'
    tiling; the two copies of each constant must agree."""
    assert _source_constant(source, name) == value


def test_a_producer_warp_generates_one_row_of_core_matrices():
    """128 rows of an S tile over the producer warps of the 4 blocks of a
    cluster: a warp's share is 8 rows, one row of 8x4 core matrices, so
    that it is contiguous for the bulk copy to the other blocks."""
    producers = _source_constant("gaussian_sketch.cu", "kProducers")
    assert tk._SKETCH_TILE // (producers * tk._SKETCH_CLUSTER) == 8


def test_tensor_core_routing_predicate_for_the_sketch():
    """K7 takes the tensor cores for f32 operands that 16-byte copies can
    read: aligned, n a multiple of 4."""
    A = torch.zeros(64, 36)
    assert twy.takes_tensor_cores(A)
    assert not twy.takes_tensor_cores(torch.zeros(64, 37))
    assert not twy.takes_tensor_cores(A.double())
    view = torch.zeros(64 * 36 + 1)[1:].view(64, 36)
    assert view.is_contiguous() and not twy.takes_tensor_cores(view)


@pytest.mark.parametrize("d,n,s", [(8, 65536, 1), (8, 8192, 4),
                                   (17, 1000, 5)])
def test_recounted_bound_keeps_every_operation(d, n, s):
    """K4's work function names the cross term apart, as a matrix product
    that may run on the tensor cores, and leaves the total as it was
    counted before: n² (2d + 2s + 6) flops and n² exponentials (none in
    f64, whose exponential is a polynomial)."""
    work = tk.kernel_matmat_work(d, n, s)
    assert work["flops"] + work["product_flops"] \
        == n * n * (2 * d + 2 * s + 6)
    assert work["product_flops"] == 2 * d * n * n
    assert work["special"] == n * n
    assert work["nbytes"] == 4 * (d * n + 2 * n * s)
    work64 = tk.kernel_matmat_work(d, n, s, 8)
    assert work64["special"] == 0 and work64["nbytes"] == 2 * work["nbytes"]
    assert work64["flops"] == work["flops"]


# -- every entry point runs on the card unless told otherwise ----------------

def test_entry_points_default_to_the_card():
    assert inspect.signature(rt.RNGState.spawn).parameters[
        "device"].default == "cuda"
    assert inspect.signature(tk.gaussian_sketch_matrix).parameters[
        "device"].default == "cuda"
    package = Path(rt.__file__).parent
    pattern = re.compile(r"def [^)]*device\s*(:[^=,)]*)?=\s*[\"']cpu[\"']",
                         re.S)
    offenders = [str(path.relative_to(package))
                 for path in sorted(package.rglob("*.py"))
                 if pattern.search(path.read_text())]
    assert offenders == []


def test_rng_state_advance_is_spawn_without_the_generator():
    st = rt.RNGState(7)
    _, nxt = st.spawn("cpu")
    adv = st.advance()
    assert (adv.key, adv.counter) == (nxt.key, nxt.counter) == (7, 1)
    assert (st.key, st.counter) == (7, 0)


def test_simt_wrappers_refuse_cpu_tensors_and_count_nothing():
    X, V = _xv(4, 50, 3, 1)
    before = dict(tk.LAUNCHES)
    with pytest.raises(RandLAPACKError, match="CUDA"):
        tk.kernel_matmat_simt(X, V, 1.0)
    with pytest.raises(RandLAPACKError, match="CUDA"):
        tk.gaussian_sketch_simt(X, 3, 1)
    assert tk.LAUNCHES == before
    assert set(before) == {"kernel_matmat", "gaussian_sketch",
                           "kernel_matmat_simt", "gaussian_sketch_simt"}
