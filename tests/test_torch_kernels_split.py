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


# -- kernel_matmat_wide_reference (K4's wide body) ---------------------------

# d 1, 8, 9 and 32 (one, one, two and four k-steps of the cross term), n
# ragged against the 32-point stages and the 128-point padding, s below,
# at and above the 128 columns of a block
_WIDE_CASES = [(1, 1000, 17), (8, 4097, 100), (9, 1000, 1000),
               (32, 4097, 128), (8, 1000, 128), (9, 4097, 17),
               (32, 1000, 100), (1, 4097, 1000)]


@pytest.mark.parametrize("d,n,s", _WIDE_CASES)
def test_kernel_matmat_wide_reference_holds_fp32_accuracy(d, n, s):
    """The entries' split products with V's halves, restarted every
    stage, against the plain version in f64: within 4x the plain f32
    version's error, as the narrow body's arithmetic is held."""
    X, V = _xv(d, n, s, d + n + s)
    bw = 0.9 * math.sqrt(d)
    ref = tk.kernel_matmat_reference(X.double(), V.double(), bw)
    plain = _relf(tk.kernel_matmat_reference(X, V, bw), ref)
    assert _relf(tk.kernel_matmat_wide_reference(X, V, bw), ref) \
        <= _gate(plain)


@pytest.mark.parametrize("d,n,s", _WIDE_CASES[:4])
def test_kernel_matmat_wide_reference_against_the_jax_reference(d, n, s):
    """Against the JAX package's ``kernel_matmat_reference`` on the same
    numpy inputs: the JAX kernel test's tolerance (rtol 2e-5, atol 1e-5),
    the absolute part taken of the largest entry, as sums of thousands of
    terms reach tens."""
    X, V = _xv(d, n, s, d + n)
    bw = 1.36 * math.sqrt(d)
    ref = np.asarray(jk.kernel_matmat_reference(jnp.asarray(X.numpy()),
                                                jnp.asarray(V.numpy()), bw))
    out = tk.kernel_matmat_wide_reference(X, V, bw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("splits,chunk", [(1, 0), (1, 4), (3, 1), (8, 2)])
def test_kernel_matmat_wide_reference_splits_and_chunks(splits, chunk):
    """Splitting the stages into parts added in index order, or folding
    the running sum every ``chunk`` stages (0: once a part), moves the
    result by fp32 summation order only."""
    X, V = _xv(9, 1000, 100, 5)
    one = tk.kernel_matmat_wide_reference(X, V, 2.0)
    other = tk.kernel_matmat_wide_reference(X, V, 2.0, splits=splits,
                                            chunk=chunk)
    scale = float(one.abs().max())
    assert float((other - one).abs().max()) <= 1e-5 * scale
    assert torch.equal(other, tk.kernel_matmat_wide_reference(
        X, V, 2.0, splits=splits, chunk=chunk))


def test_kernel_matmat_wide_reference_keeps_a_nan():
    """A NaN coordinate makes its point's entries NaN, in every row (its
    column of K) and in its own row: every output is NaN, as in the plain
    version; the clamp does not turn the NaN into an entry of 1."""
    X, V = _xv(8, 300, 40, 2)
    X[3, 17] = float("nan")
    out = tk.kernel_matmat_wide_reference(X, V, 2.0)
    assert torch.equal(torch.isnan(out),
                       torch.isnan(tk.kernel_matmat_reference(X, V, 2.0)))
    assert bool(torch.isnan(out).all())


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


@pytest.mark.parametrize("d,n,s,dtype,body,splits", [
    (8, 65536, 1024, torch.float32, "wide", 1),    # REVD2's: 512 x 8 blocks
    (8, 8192, 1024, torch.float32, "wide", 2),     # 512 blocks: two parts
    (32, 65536, 128, torch.float32, "wide", 2),
    (8, 1000, 100, torch.float32, "wide", 8),      # one block a part
    (8, 65536, 1, torch.float32, "narrow", 4),     # KRILL's
    (8, 8192, 4, torch.float32, "narrow", 32),
    (8, 65536, 16, torch.float32, "narrow", 4),
    (33, 65536, 1024, torch.float32, "simt", 1),
    (8, 65536, 1024, torch.float64, "simt", 1),
    (8, 8192, 1, torch.float64, "simt", 8)])
def test_kernel_matmat_plan_routes_by_shape(d, n, s, dtype, body, splits):
    """K4's body and its split of the sum over j depend on d, n, s and
    the type alone: the wide body takes f32 with d ≤ 32 from _WIDE_MIN_S
    columns of V on, in blocks of 128 rows by 128 columns."""
    assert tk.kernel_matmat_plan(d, n, s, dtype) == (body, splits)


def test_kernel_matmat_plan_threshold():
    """The last narrow width and the first wide one."""
    t = tk._WIDE_MIN_S
    assert tk.kernel_matmat_plan(8, 65536, t - 1)[0] == "narrow"
    assert tk.kernel_matmat_plan(8, 65536, t)[0] == "wide"
    assert tk.kernel_matmat_plan(32, 4097, t)[0] == "wide"
    assert tk.kernel_matmat_plan(33, 4097, t)[0] == "simt"


@pytest.mark.parametrize("d,n,s", [(8, 1000, 100), (9, 4097, 1000),
                                   (8, 1000, 16), (32, 300, 4)])
def test_k4_wrapper_routes_sizes_and_counts(d, n, s, monkeypatch):
    """K4's f32 wrapper on CPU tensors as far as the launch (the device
    check passed, ``_build.call`` recorded): one launch of
    ``rl_kernel_matmat`` with the plan's splits and ``wy.CHUNK``, scratch
    for the body the plan names (the wide body: points padded to the
    shared-memory stride, V's TF32 hi and lo tiles of 128 columns), the
    wide body counted in ``LAUNCHES`` and, in a recording span, its
    columns in ``k4.wide_columns`` against all the launch's."""
    from randlapack_tpu_torch import _build
    from randlapack_tpu_torch.utils import timing
    calls = []
    monkeypatch.setattr(tk, "_check_kernel_matmat",
                        lambda X, V: (*X.shape, V.shape[1]))
    monkeypatch.setattr(_build, "call", lambda name, out, *a: calls.append(
        (name, *a)))
    monkeypatch.setattr(tk, "LAUNCHES", dict.fromkeys(tk.LAUNCHES, 0))
    X, V = _xv(d, n, s, 3)
    with timing.span("off"):
        pass
    with timing.tracing():
        with timing.span("k4"):
            tk.kernel_matmat(X, V, 2.0)
        counted = timing.counters()
    body, splits = tk.kernel_matmat_plan(d, n, s)
    wide = body == "wide"
    assert [c[0] for c in calls] == ["rl_kernel_matmat"]
    assert calls[0][-2:] == (splits, twy.CHUNK)
    ks = -(-d // 8) if d > 8 else 1
    ks = 4 if ks > 2 else ks
    n_pad = -(-n // 128) * 128
    if wide:
        floats = n_pad * ((16 if ks == 1 else 16 * ks + 16) + 1
                          + -(-s // 128) * 256)
    else:
        sc = 1 if s == 1 else 4 if s <= 4 else 16
        floats = n_pad * (16 * ks + 1 + -(-s // sc) * sc)
    floats += splits * n * s if splits > 1 else 0
    assert calls[0][3].numel() == floats
    assert tk.LAUNCHES == {**dict.fromkeys(tk.LAUNCHES, 0),
                           "kernel_matmat": 1, "kernel_matmat_wide": int(wide)}
    assert counted["k4.wide_columns"] == [s if wide else 0, s]


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
    ("kernel_matmat.cu", "kMaxKSteps", tk._MAX_TC_D // 8),
    ("kernel_matmat.cu", "kWideBI", tk._WIDE_TI),
    ("kernel_matmat.cu", "kWideBN", tk._WIDE_SC),
    ("kernel_matmat.cu", "kWideMinS", tk._WIDE_MIN_S),
    ("tc.cuh", "BK", tk._WIDE_BK)])
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
                           "kernel_matmat_simt", "gaussian_sketch_simt",
                           "kernel_matmat_wide"}
