"""The TF32 form ("high") of the port's K1/K2 kernels (csrc/wy_ring.cu) in
its plain PyTorch form, on the CPU.

On the card the form rounds its small operands to TF32 once a call, into
tiles laid out for the tensor cores (``tf32_tiles``), and sums in a fixed
order: runs of ``wy.CHUNK`` stages of 32 on the tensor cores, folded into
an fp32 sum in order, K1's parts added in index order. Here the plain
pre-pass is held bit for bit to ``_tf32_rna`` and the transposes (ties,
subnormals, ±Inf and NaN included), the plain versions of that order
(``*_tf32_order_reference``) to the forms' plain versions within 1e-6 of
their largest entry (fp32 sums of the same rounded products in another
order), and the routing to the form table, with no fallback. The kernels
themselves are held to these on the card (tests/test_torch_cuda.py,
chip_smoke.py's ``[wy-modes]``); the CPU route in "high", unchanged, keeps
its parity with the JAX package (tests/test_torch_trailing_modes.py)."""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from randlapack_tpu_torch import _build
from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.ops import wy as twy

CSRC = Path(twy.__file__).parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one PyTorch thread keeps them at their own
    cost beside the other test processes. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _operands(m, w, k, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return tuple(map(torch.tensor, (
        rng.standard_normal((m, k)).astype(f32),
        rng.standard_normal((m, w)).astype(f32),
        rng.standard_normal((k, w)).astype(f32),
        (rng.random(w) < 0.6).astype(f32))))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _expected_tiles(X):
    """tf32_tiles_reference's layout written out entry by entry: X (R, K)
    rounded, at (i·S + s)·4096 + ((r/8)·8 + q/4)·32 + (r % 8)·4 + q % 4
    for r = 128 i + (row in the tile), q = 32 s + (column in the stage)."""
    R, K = X.shape
    S = -(-K // 32)
    out = torch.zeros(-(-R // 128) * 128 * S * 32, dtype=torch.float32)
    r = torch.arange(R)[:, None]
    q = torch.arange(K)[None, :]
    off = (((r // 128) * S + q // 32) * 4096
           + (((r % 128) // 8) * 8 + (q % 32) // 4) * 32
           + (r % 8) * 4 + q % 4)
    out[off.reshape(-1)] = twy._tf32_rna(X).reshape(-1)
    return out


def _special_values(n, seed):
    """Normal values with ties (half a TF32 unit, both signs), subnormals,
    ±0, ±Inf, NaN and values that round up into the next binade or to
    Inf, scattered through an n-vector."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    ulp = 2.0 ** -10
    special = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + 3 * ulp / 2,
                        2 - ulp / 2, 1e-40, -3e-39, 1.2e-38, 0.0, -0.0,
                        np.inf, -np.inf, np.nan, 3.4e38,
                        np.float32(3.4028235e38)], dtype=np.float32)
    at = rng.choice(n, min(n, special.size), replace=False)
    x[at] = special[:at.size]
    return torch.tensor(x)


# -- the pre-pass ----------------------------------------------------------

@pytest.mark.parametrize("R,K", [(128, 32), (200, 70), (1, 1), (300, 33),
                                 (129, 257)])
def test_tiles_reference_is_the_rounding_in_the_kernel_layout(R, K):
    X = _special_values(R * K, R + K).view(R, K)
    T = twy.tf32_tiles_reference(X)
    assert T.numel() == twy._tiles_floats(R, K)
    assert torch.equal(_bits(T), _bits(_expected_tiles(X)))


@pytest.mark.parametrize("R,K", [(64, 96), (257, 40)])
def test_tiles_reference_of_a_transpose(R, K):
    """The form tiles Zᵀ (K2) and Vᵀ (K1): a transposed view tiles as its
    contiguous copy, bit for bit."""
    Y = _special_values(R * K, 3).view(K, R)
    assert torch.equal(_bits(twy.tf32_tiles_reference(Y.T)),
                       _bits(twy.tf32_tiles_reference(Y.T.contiguous())))
    assert torch.equal(_bits(twy.tf32_tiles_reference(Y.T)),
                       _bits(_expected_tiles(Y.T.contiguous())))


def test_tiles_keep_ties_subnormals_and_non_finite_values():
    one, ulp = 1.0, 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, 1e-40,
                      float("inf"), float("-inf"), float("nan"), -0.0,
                      3.4028235e38], dtype=torch.float32)
    T = twy.tf32_tiles_reference(x[None, :])
    at = (torch.arange(9) // 4) * 32 + torch.arange(9) % 4
    got = T[at]
    assert torch.equal(_bits(got[:2]), _bits(torch.tensor(
        [one + ulp, -(one + ulp)])))                       # ties away
    assert float(got[2]) == one
    assert torch.equal(_bits(got), _bits(twy._tf32_rna(x)))
    assert int(_bits(got[3])) & 0x1FFF == 0 and float(got[3]) > 0
    assert torch.isinf(got[4:6]).all() and bool(torch.isnan(got[6]))
    assert bool(torch.signbit(got[7])) and bool(torch.isinf(got[8]))
    # the padding is zeros
    pad = torch.ones(T.numel(), dtype=torch.bool)
    pad[at] = False
    assert not bool(T[pad].any())


def test_tiles_on_the_cpu_are_the_plain_version_and_count_nothing():
    X = torch.randn(50, 40)
    before = dict(twy.LAUNCHES)
    assert torch.equal(twy.tf32_tiles(X.T), twy.tf32_tiles_reference(X.T))
    assert twy.LAUNCHES == before
    with pytest.raises(RandLAPACKError):
        twy.tf32_tiles(X.double())


# -- the order of sums -----------------------------------------------------

@pytest.mark.parametrize("m,w,k,splits", [
    (96, 100, 32, 1), (300, 260, 128, 1), (1000, 36, 128, 3),
    (520, 132, 1024 // 8, 2), (33, 4, 200, 1), (1, 4, 1, 1)])
def test_order_references_match_the_forms_plain_versions(m, w, k, splits):
    """Ragged shapes (m, w off the 128 tile, m off the 32-row stage) and
    reductions of 32, 128 and 1024/8 terms (K2's k; K1's m is larger): the
    same rounded products, summed in the kernels' order, within 1e-6 of
    the plain version's largest entry."""
    V, A, Z, mask = _operands(m, w, k, m + w + k)
    W = twy.masked_vt_a_tf32_order_reference(V, A, mask, splits)
    Wp = twy.masked_vt_a_tf32_reference(V, A, mask)
    assert W.shape == Wp.shape
    assert float((W - Wp).abs().max()) <= 1e-6 * float(Wp.abs().max())
    U = twy.a_minus_vz_masked_tf32_order_reference(A, V, Z, mask)
    Up = twy.a_minus_vz_masked_tf32_reference(A, V, Z, mask)
    assert float((U - Up).abs().max()) <= 1e-6 * float(Up.abs().max())


@pytest.mark.parametrize("chunk", [0, 1, 2, 5])
def test_order_references_restart_every_chunk(chunk):
    """Every restart interval, never (0) included, sums the same products:
    within 1e-6; a run of `chunk` stages is one fp32 product of its own."""
    V, A, Z, mask = _operands(700, 68, 130, chunk)
    W = twy.masked_vt_a_tf32_order_reference(V, A, mask, 2, chunk)
    Wp = twy.masked_vt_a_tf32_reference(V, A, mask)
    assert float((W - Wp).abs().max()) <= 1e-6 * float(Wp.abs().max())
    U = twy.a_minus_vz_masked_tf32_order_reference(A, V, Z, mask, chunk)
    Up = twy.a_minus_vz_masked_tf32_reference(A, V, Z, mask)
    assert float((U - Up).abs().max()) <= 1e-6 * float(Up.abs().max())
    # one run of 32·chunk terms is exactly that fp32 product
    if chunk:
        Vr, Ar = twy._tf32_rna(V), twy._tf32_rna(A * mask[None, :])
        n = min(32 * chunk, 700)
        head = twy._chunk_sums(Vr.T, Ar, 0, n, chunk)
        assert torch.equal(head, Vr[:n].T @ Ar[:n])


def test_order_reference_parts_are_whole_stages_added_in_order():
    """K1's parts: m cut into whole 32-row stages (the entry point's
    kper), the parts summed one by one in index order."""
    V, A, _, mask = _operands(1000, 40, 8, 11)
    Vr, Ar = twy._tf32_rna(V).T, twy._tf32_rna(A * mask[None, :])
    kper = 352                       # ceil(ceil(1000 / 3) / 32) · 32
    parts = [twy._chunk_sums(Vr, Ar, k0, min(1000, k0 + kper), twy.CHUNK)
             for k0 in range(0, 1000, kper)]
    assert len(parts) == 3
    assert torch.equal(twy.masked_vt_a_tf32_order_reference(V, A, mask, 3),
                       (parts[0] + parts[1]) + parts[2])


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_order_references_keep_the_non_finite_pattern(bad):
    """A mask of 0 over Inf gives NaN, as A ⊙ mask does; the pattern is the
    plain version's."""
    V, A, Z, mask = _operands(96, 40, 64, 5)
    dead = int(torch.nonzero(mask == 0)[0])
    live = int(torch.nonzero(mask == 1)[0])
    A[3, dead] = bad
    A[5, live] = bad
    W = twy.masked_vt_a_tf32_order_reference(V, A, mask)
    Wp = twy.masked_vt_a_tf32_reference(V, A, mask)
    assert torch.equal(torch.isfinite(W), torch.isfinite(Wp))
    assert bool(torch.isnan(W[:, dead]).all())
    Z[2, dead] = bad
    U = twy.a_minus_vz_masked_tf32_order_reference(A, V, Z, mask)
    Up = twy.a_minus_vz_masked_tf32_reference(A, V, Z, mask)
    assert torch.equal(torch.isfinite(U), torch.isfinite(Up))


# -- routing: the form table, no fallback ----------------------------------

def test_form_table_names_the_ring_kernels_and_the_earlier_form():
    assert twy.FORMS == ("tf32", "bf16", "bf16x3")
    assert twy.FORM_KERNELS["tf32"] == ("rl_masked_vt_a_tf32",
                                        "rl_a_minus_vz_masked_tf32")
    assert twy.FORM_KERNELS["tf32_wy"] == ("rl_masked_vt_a_mode",
                                             "rl_a_minus_vz_masked_mode")
    assert twy._FORM_MODES["tf32_wy"] == 1 and "tf32" not in twy._FORM_MODES
    for names in twy.FORM_KERNELS.values():
        assert all(name in _build._SIGNATURES for name in names)
    src = (CSRC / "wy_ring.cu").read_text()
    for name in (*twy.FORM_KERNELS["tf32"], "rl_tf32_tiles"):
        assert re.search(rf"^int {name}_f32\(", src, re.M), name
    # the earlier form is csrc/wy.cu's kTf32 instance, mode 1
    assert re.search(r"constexpr int kTf32x3 = 0, kTf32 = 1,",
                     (CSRC / "wy.cu").read_text())


def test_the_tf32_route_has_no_fallback():
    """No try/except in the module; the "tf32" branch of each form wrapper
    launches the ring kernel and nothing else; the ring wrappers call no
    plain version and not the earlier form's kernel."""
    module = inspect.getsource(twy)
    assert "try:" not in module and "except" not in module
    # the ring forms, "tf32" among them, share one ring wrapper for each kernel
    assert "tf32" in twy._RING_SETS
    body = inspect.getsource(twy.masked_vt_a_form)
    assert re.search(r"if form in _RING_SETS:\n\s+W = _ring_masked_vt_a\(",
                     body)
    body = inspect.getsource(twy.a_minus_vz_masked_form)
    assert re.search(r"if form in _RING_SETS:\n\s+_ring_a_minus_vz_masked\(",
                     body)
    for fn, call in ((twy._ring_masked_vt_a, "FORM_KERNELS[form][0]"),
                     (twy._ring_a_minus_vz_masked, "FORM_KERNELS[form][1]")):
        body = inspect.getsource(fn)
        assert f"_build.call({call}" in body
        assert "_reference" not in body and "_tc_" not in body
        assert "_FORM_MODES" not in body


def test_wrapper_tiling_constants_are_the_kernel_source():
    src = (CSRC / "wy_ring.cu").read_text()
    assert re.findall(r"constexpr int kTileRows = (\d+);", src) == [
        str(twy._TILE)]
    assert re.findall(r"constexpr int BK = (\d+);",
                      (CSRC / "tc.cuh").read_text()) == [str(twy._STAGE)]


def test_forms_refuse_cpu_tensors_and_count_nothing():
    V, A, Z, mask = _operands(64, 64, 16, 2)
    before = dict(twy.LAUNCHES)
    for form in ("tf32", "tf32_wy"):
        with pytest.raises(RandLAPACKError):
            twy.masked_vt_a_form(V, A, mask, form)
        with pytest.raises(RandLAPACKError):
            twy.a_minus_vz_masked_form(A, V, Z, mask, form)
    assert twy.LAUNCHES == before
    for key in ("masked_vt_a_tf32_wy", "a_minus_vz_masked_tf32_wy",
                "tf32_tiles"):
        assert key in twy.LAUNCHES


def test_cpu_route_in_high_is_unchanged():
    """On the CPU "high" is the "highest" product (as XLA's CPU dot), not
    the TF32 form, and launches nothing."""
    V, A, Z, mask = _operands(80, 48, 24, 6)
    before = dict(twy.LAUNCHES)
    assert twy.trailing_form("high", A) == "highest"
    assert torch.equal(twy.masked_vt_a_mixed(V, A, mask, "high"),
                       twy.masked_vt_a_reference(V, A, mask))
    assert torch.equal(
        twy.a_minus_vz_masked_mixed(A.clone(), V, Z, mask, "high"),
        twy.a_minus_vz_masked_reference(A, V, Z, mask))
    assert twy.LAUNCHES == before
