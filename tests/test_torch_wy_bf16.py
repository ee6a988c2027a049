"""The bf16 forms of K1 and K2 ("default": one bf16 product;
"bf16_3x_emul": three bf16 products of hi/lo halves) as the port's ring
kernel computes them (csrc/wy_ring.cu), in their plain PyTorch form, on
the CPU.

On the card K2's forms round V and Zᵀ, K1's Vᵀ, once a call into bf16
tiles laid out for the tensor cores (``bf16_tiles``; for "bf16x3" a hi
and a lo tile a block; K1's A ⊙ mask is rounded as the kernel reads it),
and sum in a fixed order: runs of ``wy.CHUNK`` stages of 32 on the tensor
cores (lo·hi, hi·lo, hi·hi in a run for "bf16x3"), folded into an fp32
sum in order, and K1's reduction over m in parts added in index order.
Here the plain pre-pass is held bit for bit to the bf16 rounding written
out entry by entry and to JAX's split (``X.astype(jnp.bfloat16)``,
``(X − xh).astype(jnp.bfloat16)``) on finite inputs, and to its own
rounding rules on ties, subnormals, ±0, ±Inf and NaN (written 0x7FC0);
the plain versions of the kernel's order of sums
(``a_minus_vz_masked_bf16*_order_reference``,
``masked_vt_a_bf16*_order_reference``) to the forms' plain versions
within 1e-6 of their largest entry (fp32 sums of the same rounded
products in another order); "bf16x3"'s plain versions to the JAX
package's ``a_minus_vz_masked_mixed`` / ``masked_vt_a_mixed(...,
"bf16_3x_emul")`` within 1e-5 (as ``tests/test_torch_trailing_modes.py``
holds the mixed functions in f32); and the routing to the form table,
with no fallback. The kernels themselves are held to these on the card
(tests/test_torch_cuda.py, chip_smoke.py's ``[wy-modes]``)."""
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu.ops import pallas_wy as jwy
from randlapack_tpu_torch import _build
from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.ops import wy as twy

CSRC = Path(twy.__file__).parents[1] / "csrc"
FORMS = ("bf16", "bf16x3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one PyTorch thread keeps them at their own
    cost beside the other test processes. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spread(rng, *shape):
    """float32 entries spread over 2^±12, so that the bf16 halves round
    at every exponent."""
    return (rng.standard_normal(shape)
            * 2.0 ** rng.integers(-12, 13, shape)).astype(np.float32)


def _operands(m, w, k, seed):
    rng = np.random.default_rng(seed)
    return tuple(map(torch.tensor, (
        _spread(rng, m, k), _spread(rng, m, w), _spread(rng, k, w),
        (rng.random(w) < 0.6).astype(np.float32))))


def _bits(t):
    return t.contiguous().view(torch.int16)


def _offsets(R, K):
    """Where entry (r, q) of a tile set lies in ``bf16_tiles_reference``'s
    layout, sets counted apart: (i·S + s)·4096 + ((r/8)·4 + q/8)·64 +
    (r % 8)·8 + q % 8 within set 0, for r = 128 i + (row in the tile),
    q = 32 s + (column in the stage), S stages."""
    S = -(-K // 32)
    r = torch.arange(R)[:, None]
    q = torch.arange(K)[None, :]
    return ((r // 128) * S + q // 32, (((r % 128) // 8) * 4 + (q % 32) // 8)
            * 64 + (r % 8) * 8 + q % 8)


def _unpack(T, R, K, sets):
    """The tile sets of T back as R × K int16 matrices, and the mask of
    the padding."""
    block, within = _offsets(R, K)
    out = [T.view(torch.int16)[(block * sets + s) * 4096 + within]
           for s in range(sets)]
    pad = torch.ones(T.numel(), dtype=torch.bool)
    for s in range(sets):
        pad[((block * sets + s) * 4096 + within).reshape(-1)] = False
    return out, pad


def _jax_halves(X):
    """JAX's bf16 split of the float32 array X, as int16 bit patterns."""
    xh = jnp.asarray(X).astype(jnp.bfloat16)
    xl = (jnp.asarray(X) - xh.astype(jnp.float32)).astype(jnp.bfloat16)
    return tuple(torch.tensor(np.asarray(h).view(np.int16)) for h in (xh, xl))


# -- the pre-pass ----------------------------------------------------------

@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("R,K", [(128, 32), (200, 70), (1, 1), (300, 33)])
def test_tiles_reference_is_the_rounding_in_the_kernel_layout(R, K, split):
    """Ragged shapes; the tiles unpack to JAX's hi (and lo) halves bit for
    bit, and the padding is zeros."""
    X = _spread(np.random.default_rng(R + K), R, K)
    T = twy.bf16_tiles_reference(torch.tensor(X), split)
    sets = 2 if split else 1
    assert T.dtype == torch.bfloat16
    assert T.numel() == twy._tiles_floats(R, K) * sets
    got, pad = _unpack(T, R, K, sets)
    for g, want in zip(got, _jax_halves(X)):
        assert torch.equal(g, want)
    assert not bool(_bits(T)[pad].any())


@pytest.mark.parametrize("R,K", [(64, 96), (257, 40)])
def test_tiles_reference_of_a_transpose(R, K):
    """The forms tile Zᵀ: a transposed view tiles as its contiguous copy,
    bit for bit."""
    Y = torch.tensor(_spread(np.random.default_rng(3), K, R))
    for split in (False, True):
        assert torch.equal(_bits(twy.bf16_tiles_reference(Y.T, split)),
                           _bits(twy.bf16_tiles_reference(
                               Y.T.contiguous(), split)))


def test_tiles_keep_ties_subnormals_and_non_finite_values():
    u = 2.0 ** -8                               # bf16's unit at 1
    x = torch.tensor([1 + u / 2, 1 + 3 * u / 2, -(1 + u / 2), 1 + u / 4,
                      1e-40, -3e-39, 0.0, -0.0, float("inf"), float("-inf"),
                      float("nan"), 3.4028235e38], dtype=torch.float32)
    (hi, lo), _ = _unpack(twy.bf16_tiles_reference(x[None, :], True), 1,
                          x.numel(), 2)
    hi, lo = hi[0], lo[0]
    hv, lv = twy._bf16_value(hi), twy._bf16_value(lo)
    # ties to even: 1 + u/2 down to 1, 1 + 3u/2 up to 1 + 2u
    assert hv[:4].tolist() == [1.0, 1 + 2 * u, -1.0, 1.0]
    assert lv[:4].tolist() == [u / 2, -u / 2, -u / 2, u / 4]
    # subnormals stay nonzero with their sign, ±0 keep theirs
    assert float(hv[4]) > 0 > float(hv[5])
    assert hi[6:8].tolist() == [0, -0x8000] and lo[6:8].tolist() == [0, 0]
    # Inf keeps its sign with a NaN lo half; NaN is 0x7FC0 in both; the
    # largest float rounds up to Inf, its lo half is -Inf
    assert hi[8:12].tolist() == [0x7F80, -0x80, 0x7FC0, 0x7F80]
    assert lo[8:11].tolist() == [0x7FC0] * 3 and lo[11] == -0x80
    # finite entries as PyTorch's own conversion rounds them
    fin = torch.isfinite(x) & torch.isfinite(hv)
    assert torch.equal(hi[fin], _bits(x.to(torch.bfloat16))[fin])


def test_bf16_bits_is_the_round_to_nearest_even_conversion():
    X = torch.tensor(_spread(np.random.default_rng(5), 4000))
    X[::97] = float("nan")
    got = twy._bf16_bits(X)
    nan = torch.isnan(X)
    assert torch.equal(got[~nan], _bits(X.to(torch.bfloat16))[~nan])
    assert bool((got[nan] == 0x7FC0).all())


def test_tiles_on_the_cpu_are_the_plain_version_and_count_nothing():
    X = torch.randn(50, 40)
    before = dict(twy.LAUNCHES)
    for split in (False, True):
        assert torch.equal(_bits(twy.bf16_tiles(X.T, split)),
                           _bits(twy.bf16_tiles_reference(X.T, split)))
    assert twy.LAUNCHES == before
    with pytest.raises(RandLAPACKError):
        twy.bf16_tiles(X.double())


# -- the order of sums -----------------------------------------------------

def _refs(form):
    return (getattr(twy, f"a_minus_vz_masked_{form}_order_reference"),
            getattr(twy, f"a_minus_vz_masked_{form}_reference"))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("m,w,k", [(96, 100, 32), (300, 260, 128),
                                   (33, 4, 200), (1, 4, 1), (130, 36, 1024)])
def test_order_references_match_the_forms_plain_versions(form, m, w, k):
    """Ragged shapes (m, w off the 128 tile, k off the 32-deep stage) and
    reductions up to 1024 terms: the same rounded products, summed in the
    kernel's order, within 1e-6 of the plain version's largest entry."""
    V, A, Z, mask = _operands(m, w, k, m + w + k)
    order, plain = _refs(form)
    U, Up = order(A, V, Z, mask), plain(A, V, Z, mask)
    assert U.shape == Up.shape
    assert float((U - Up).abs().max()) <= 1e-6 * float(Up.abs().max())


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("chunk", [0, 1, 2, 5])
def test_order_references_restart_every_chunk(form, chunk):
    """Every restart interval, never (0) included, sums the same products
    within 1e-6; a run of `chunk` stages is one fp32 sum of its own (for
    bf16x3 lo·hi + hi·lo + hi·hi over the run)."""
    V, A, Z, mask = _operands(70, 68, 300, chunk)
    order, plain = _refs(form)
    U, Up = order(A, V, Z, mask, chunk), plain(A, V, Z, mask)
    assert float((U - Up).abs().max()) <= 1e-6 * float(Up.abs().max())
    if chunk:
        (Vh, Vl), (Zh, Zl) = twy._bf16_halves(V), twy._bf16_halves(Z)
        n = 32 * chunk
        if form == "bf16":
            P, Q, run = Vh, Zh, Vh[:, :n] @ Zh[:n]
        else:
            P, Q = (Vl, Vh, Vh), (Zh, Zl, Zh)
            run = (Vl[:, :n] @ Zh[:n] + Vh[:, :n] @ Zl[:n]) + Vh[:, :n] @ Zh[:n]
        assert torch.equal(twy._chunk_sums(P, Q, 0, n, chunk), run)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_order_references_keep_the_non_finite_pattern(form, bad):
    """A mask of 0 over Inf gives NaN, as A ⊙ mask does; an Inf in V or Z
    gives NaN lo halves; the pattern is the plain version's."""
    V, A, Z, mask = _operands(96, 40, 64, 5)
    dead = int(torch.nonzero(mask == 0)[0])
    live = int(torch.nonzero(mask == 1)[0])
    V[3, 7] = bad
    Z[2, dead] = bad
    Z[5, live] = bad
    order, plain = _refs(form)
    U, Up = order(A, V, Z, mask), plain(A, V, Z, mask)
    assert torch.equal(torch.isfinite(U), torch.isfinite(Up))
    assert bool(torch.isnan(U[:, dead]).all())


def test_bf16x3_reference_matches_jax():
    """The "bf16_3x_emul" form's plain version and its order of sums
    against the JAX package's mixed function, in f32, within 1e-5 of the
    largest entry (the tolerance of test_mixed_functions_match_jax), the
    update itself too."""
    V, A, Z, mask = _operands(96, 24, 40, 7)
    Aj = np.asarray(jwy.a_minus_vz_masked_mixed(
        *map(jnp.asarray, (A.numpy(), V.numpy(), Z.numpy(), mask.numpy())),
        "bf16_3x_emul"))

    def rel(x, y):
        return np.abs(x - y).max() / np.abs(y).max()
    for U in (twy.a_minus_vz_masked_bf16x3_reference(A, V, Z, mask),
              twy.a_minus_vz_masked_bf16x3_order_reference(A, V, Z, mask)):
        assert rel(U.numpy(), Aj) <= 1e-5
        assert rel(U.numpy() - A.numpy(), Aj - A.numpy()) <= 1e-5


# -- K1's order of sums ----------------------------------------------------

def _k1_refs(form):
    return (getattr(twy, f"masked_vt_a_{form}_order_reference"),
            getattr(twy, f"masked_vt_a_{form}_reference"))


def _k1_operands(m, w, b, seed):
    V, A, _, mask = _operands(m, w, b, seed)
    return V, A, mask


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("m,w,b,splits", [
    (300, 132, 72, 2), (1000, 36, 200, 3), (33, 4, 5, 1), (520, 260, 130, 2),
    (1, 4, 1, 1)])
def test_k1_order_references_match_the_forms_plain_versions(form, m, w, b,
                                                            splits):
    """Ragged m (off the 32-row stage), w % 4 == 0 off the 128 tile, b not
    a multiple of 128, the reduction in 1–3 parts: the same rounded
    products, summed in the kernel's order, within 1e-6 of the plain
    version's largest entry."""
    V, A, mask = _k1_operands(m, w, b, m + w + b)
    order, plain = _k1_refs(form)
    W, Wp = order(V, A, mask, splits), plain(V, A, mask)
    assert W.shape == Wp.shape == (b, w)
    assert float((W - Wp).abs().max()) <= 1e-6 * float(Wp.abs().max())


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("chunk", [0, 1, 2, 5])
def test_k1_order_references_restart_every_chunk(form, chunk):
    """Every restart interval, never (0) included, sums the same products
    within 1e-6; a run of `chunk` stages is one fp32 sum of its own (for
    bf16x3 Vₕᵀ·Aₗ + Vₗᵀ·Aₕ + Vₕᵀ·Aₕ over the run: Wᵀ's lo·hi, hi·lo,
    hi·hi)."""
    V, A, mask = _k1_operands(700, 68, 40, chunk)
    order, plain = _k1_refs(form)
    W, Wp = order(V, A, mask, 2, chunk), plain(V, A, mask)
    assert float((W - Wp).abs().max()) <= 1e-6 * float(Wp.abs().max())
    if chunk:
        (Vh, Vl), (Ah, Al) = (twy._bf16_halves(V),
                              twy._bf16_halves(A * mask[None, :]))
        n = 32 * chunk
        if form == "bf16":
            P, Q, run = Vh.T, Ah, Vh[:n].T @ Ah[:n]
        else:
            P, Q = (Vh.T, Vl.T, Vh.T), (Al, Ah, Ah)
            run = (Vh[:n].T @ Al[:n] + Vl[:n].T @ Ah[:n]) + Vh[:n].T @ Ah[:n]
        assert torch.equal(twy._chunk_sums(P, Q, 0, n, chunk), run)
        # the parts: whole stages, added in index order
        kper = 352                       # ceil(ceil(700 / 2) / 32) · 32
        parts = [twy._chunk_sums(P, Q, k0, min(700, k0 + kper), chunk)
                 for k0 in (0, kper)]
        assert torch.equal(W, parts[0] + parts[1])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_k1_order_references_keep_the_non_finite_pattern(form, bad):
    """A mask of 0 over Inf gives NaN, as A ⊙ mask does; an Inf in V gives
    NaN lo halves; the pattern is the plain version's."""
    V, A, mask = _k1_operands(96, 40, 24, 5)
    dead = int(torch.nonzero(mask == 0)[0])
    live = int(torch.nonzero(mask == 1)[0])
    A[3, dead] = bad
    A[5, live] = bad
    V[7, 2] = bad
    order, plain = _k1_refs(form)
    W, Wp = order(V, A, mask, 2), plain(V, A, mask)
    assert torch.equal(torch.isfinite(W), torch.isfinite(Wp))
    assert bool(torch.isnan(W[:, dead]).all())


def test_k1_bf16x3_reference_matches_jax():
    """K1's "bf16_3x_emul" plain version and its order of sums against the
    JAX package's mixed function, in f32, within 1e-5 of the largest
    entry (the tolerance of test_mixed_functions_match_jax)."""
    V, A, mask = _k1_operands(300, 36, 20, 7)
    Wj = np.asarray(jwy.masked_vt_a_mixed(
        *map(jnp.asarray, (V.numpy(), A.numpy(), mask.numpy())),
        "bf16_3x_emul"))
    for W in (twy.masked_vt_a_bf16x3_reference(V, A, mask),
              twy.masked_vt_a_bf16x3_order_reference(V, A, mask, 2)):
        assert np.abs(W.numpy() - Wj).max() <= 1e-5 * np.abs(Wj).max()


# -- routing: the form table, no fallback ----------------------------------

def test_form_table_names_the_bf16_ring_kernels_and_the_yardsticks():
    assert twy.FORMS == ("tf32", "bf16", "bf16x3")
    assert twy.FORM_KERNELS["bf16"] == ("rl_masked_vt_a_bf16",
                                        "rl_a_minus_vz_masked_bf16")
    assert twy.FORM_KERNELS["bf16x3"] == ("rl_masked_vt_a_bf16x3",
                                          "rl_a_minus_vz_masked_bf16x3")
    # the earlier bodies: csrc/wy.cu's kBf16 (mode 2) and kBf16x3 (3), as
    # the yardsticks of both kernels; the ring forms take no mode
    for form, mode in (("bf16", 2), ("bf16x3", 3)):
        assert twy.FORM_KERNELS[f"{form}_wy"] == (
            "rl_masked_vt_a_mode", "rl_a_minus_vz_masked_mode")
        assert twy._FORM_MODES[f"{form}_wy"] == mode
        assert form not in twy._FORM_MODES
        assert f"a_minus_vz_masked_{form}_wy" in twy.LAUNCHES
        assert f"masked_vt_a_{form}_wy" in twy.LAUNCHES
    assert re.search(r"kTf32 = 1, kBf16 = 2, kBf16x3 = 3;",
                     (CSRC / "wy.cu").read_text())
    assert "bf16_tiles" in twy.LAUNCHES
    src = (CSRC / "wy_ring.cu").read_text()
    for name in ("rl_masked_vt_a_bf16", "rl_masked_vt_a_bf16x3",
                 "rl_a_minus_vz_masked_bf16", "rl_a_minus_vz_masked_bf16x3",
                 "rl_bf16_tiles"):
        params = re.search(rf"^int {name}_f32\(([^)]*)\)", src, re.M)
        assert params, name
        # the binding passes one argument per parameter, the stream last
        sig = _build._SIGNATURES[name]["_f32"]
        assert len(sig) == params.group(1).count(",") + 1
        assert params.group(1).rstrip().endswith("void* stream")


def test_bf16_forms_refuse_cpu_tensors_and_count_nothing():
    V, A, Z, mask = _operands(64, 64, 16, 2)
    before = dict(twy.LAUNCHES)
    for form in (*FORMS, "bf16_wy", "bf16x3_wy"):
        with pytest.raises(RandLAPACKError):
            twy.a_minus_vz_masked_form(A, V, Z, mask, form)
        with pytest.raises(RandLAPACKError):
            twy.masked_vt_a_form(V, A, mask, form)
    assert twy.LAUNCHES == before


def _record_launches(monkeypatch):
    """Runs K1's wrappers on CPU tensors as far as the launch: the device
    check passes, the card has 132 multiprocessors, and each
    ``_build.call`` is recorded (name, then the arguments) instead of
    launched. ``LAUNCHES`` is a copy for the test."""
    calls = []
    monkeypatch.setattr(twy, "_check_kernel_operands", lambda mats, mask: None)
    monkeypatch.setattr(twy, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "call", lambda name, out, *a: calls.append(
        (name, *a)))
    monkeypatch.setattr(twy, "LAUNCHES", dict.fromkeys(twy.LAUNCHES, 0))
    return calls


@pytest.mark.parametrize("form,mode", [("bf16_wy", 2), ("bf16x3_wy", 3)])
def test_k1_has_no_bf16_yardstick(form, mode, monkeypatch):
    """(The name is kept from before K1's bf16 forms moved to the ring
    kernel, when they were csrc/wy.cu's bodies and had no yardstick.) K1's
    bf16 yardsticks are those bodies: the form launches
    ``rl_masked_vt_a_mode`` in its mode (2 one bf16 product, 3 three) and
    counts under its own key, not under the ring form's."""
    calls = _record_launches(monkeypatch)
    V, A, _, mask = _operands(64, 64, 16, 2)
    W = twy.masked_vt_a_form(V, A, mask, form)
    assert W.shape == (16, 64)
    assert [c[0] for c in calls] == ["rl_masked_vt_a_mode"]
    assert calls[0][-1] == mode
    assert twy.LAUNCHES == {**dict.fromkeys(twy.LAUNCHES, 0),
                            f"masked_vt_a_{form}": 1}


@pytest.mark.parametrize("form", twy.FORMS)
@pytest.mark.parametrize("m,b,w", [(300, 72, 132), (64, 256, 33)])
def test_k1_ring_wrapper_sizes_its_scratch(form, m, b, w, monkeypatch):
    """K1's ring forms launch their entry point once with Vᵀ's tile
    scratch in the form's type (TF32 floats, or bf16 values, bf16x3 two
    sets a block), A and the mask zero-padded to w % 4 == 0, and count
    under the form's key."""
    calls = _record_launches(monkeypatch)
    V, A, _, mask = _operands(m, w, b, 3)
    W = twy.masked_vt_a_form(V, A, mask, form)
    assert W.shape == (b, w)
    (name, Vc, Ap, mp, Wc, part, vt, m_, b_, w4, splits, chunk), = calls
    assert name == twy.FORM_KERNELS[form][0] == f"rl_masked_vt_a_{form}"
    assert (m_, b_, w4, chunk) == (m, b, -(-w // 4) * 4, twy.CHUNK)
    assert Ap.shape == (m, w4) and mp.shape == (w4,) and Vc is V
    assert splits == twy.masked_vt_a_splits(m, b, w4, 132)
    assert vt.dtype == (torch.float32 if form == "tf32" else torch.bfloat16)
    assert vt.numel() == twy._tiles_floats(b, m) * twy._RING_SETS[form]
    assert twy.LAUNCHES == {**dict.fromkeys(twy.LAUNCHES, 0),
                            f"masked_vt_a_{form}": 1}


def test_the_bf16_route_has_no_fallback():
    """No try/except in the module; the ring branch of each form wrapper
    takes every form of ``FORMS`` and no "_wy" form; the ring wrappers
    launch the form's entry point and call no plain version and not the
    earlier forms' kernel."""
    module = inspect.getsource(twy)
    assert "try:" not in module and "except" not in module
    assert set(twy._RING_SETS) == set(twy.FORMS)
    assert twy._RING_SETS["bf16x3"] == 2 and twy._RING_SETS["bf16"] == 1
    body = inspect.getsource(twy.a_minus_vz_masked_form)
    assert re.search(r"if form in _RING_SETS:\n\s+_ring_a_minus_vz_masked\(",
                     body)
    body = inspect.getsource(twy.masked_vt_a_form)
    assert re.search(r"if form in _RING_SETS:\n\s+W = _ring_masked_vt_a\(",
                     body)
    for fn, k in ((twy._ring_masked_vt_a, 0), (twy._ring_a_minus_vz_masked, 1)):
        body = inspect.getsource(fn)
        assert f"_build.call(FORM_KERNELS[form][{k}]" in body
        assert "_reference" not in body and "_tc_" not in body
        assert "_FORM_MODES" not in body


def test_wrapper_tiling_constants_are_the_kernel_source():
    """The wrapper sizes the scratch as the kernel lays out the tiles: 128
    rows by 32 of the reduction a tile, bf16x3 two tile sets a block."""
    src = (CSRC / "wy_ring.cu").read_text()
    assert re.findall(r"constexpr int kTileRows = (\d+);", src) == [
        str(twy._TILE)]
    assert re.findall(r"constexpr int BK = (\d+);",
                      (CSRC / "tc.cuh").read_text()) == [str(twy._STAGE)]
    assert re.search(r"kTileFloats \* 2 \* \(kForm == kFormBf16x3 \? 2 : 1\)",
                     src)
