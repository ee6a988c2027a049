"""REVD2 over the implicit squared-exponential operator against the
benchmark's plain float64 reference (``cardbench/reference_revd2.py``),
its spans and counters, and the benchmark's REVD2 cell pieces on the CPU:
the point maker, the check's numbers, K4's yardstick and the span
readers. Small and on one thread, as ``test_torch_revd2.py``; imports no
JAX (that file holds the port to the JAX package).

The port and the reference start from the same injected Ω and v0 over
the same points (n 1024, d 8, k 64). The Nyström approximation depends
on range(Q) alone, so the port's CholQR2 and 2^(e−40) pad against the
reference's Householder QR and unpadded LU move (V, λ) only by rounding.
"""
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from randlapack_tpu_torch import RNGState
from randlapack_tpu_torch.drivers import REVD2Config, revd2_fixed_rank
from randlapack_tpu_torch.ops.kernels import kernel_matmat_work
from randlapack_tpu_torch.pdkernels import SquaredExpKernelLinOp
from randlapack_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cardbench import harness, inputs  # noqa: E402
from cardbench import reference_revd2 as ref  # noqa: E402
from cardbench import yardstick_sqexp  # noqa: E402

CELL = "kernel_sqexp_n65536.revd2_k1024"
N, D, K = 1024, 8, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread beside the other test processes (as
    ``test_torch_revd2.py``), restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(dtype=torch.float32, n=N, seed=2**31 + 3):
    """The cell's maker at n points: ``(X, bandwidth)``."""
    cfg = {**harness.config(harness.workload(CELL)["config"]),
           "shape": [n, D], "dtype": str(dtype).split(".")[1]}
    return inputs.make(cfg, seed, "cpu")


def _starts(n=N, k=K, seed=7):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, k), generator=g, dtype=torch.float64),
            torch.randn((n, 1), generator=g, dtype=torch.float64))


def _port(X, bw, omega, v0, k=K):
    op = SquaredExpKernelLinOp(X, bw, 0.0, evals_include_reg=False)
    return revd2_fixed_rank(op, k, REVD2Config(), RNGState(0),
                            omega=omega.to(X.dtype), v0=v0.to(X.dtype))


@pytest.fixture(scope="module")
def pair64():
    X, bw = _points(torch.float64)
    omega, v0 = _starts()
    return X, bw, _port(X, bw, omega, v0), ref.revd2_plain(X, bw, K, omega,
                                                           v0)


@pytest.fixture(scope="module")
def pair32():
    X, bw = _points(torch.float32)
    omega, v0 = _starts()
    return X, bw, _port(X, bw, omega, v0), ref.revd2_plain(X, bw, K, omega,
                                                           v0)


def _aligned_gap(V, Vr, m):
    """max |V − Vr| over the leading m columns, each column's sign
    aligned first."""
    V, Vr = V[:, :m].double(), Vr[:, :m]
    sign = torch.sign((V * Vr).sum(0))
    return float((V * sign - Vr).abs().max())


# f64: both sides round at 1.1e-16, so λ agrees to rounding (read: 5e-14
# of λ₁), the leading 9 eigenvectors, with gaps of 1.8e-3 of λ₁ or more
# (``test_leading_pairs_are_separated``), to rounding over the gap (read:
# 2.6e-15), and the error estimates, norms of the same size from the same
# start, to rounding (read: 4e-14 of λ₁)
def test_port_matches_the_plain_reference_in_f64(pair64):
    X, bw, (V, lam, err, nu, fail, _), (Vr, lr, er, nur, fr) = pair64
    l1 = float(lr[0])
    assert not bool(fail) and not fr
    assert float(nu) == pytest.approx(nur, rel=1e-12)
    assert float((lam - lr).abs().max()) <= 1e-12 * l1
    assert _aligned_gap(V, Vr, 9) <= 1e-11
    assert abs(float(err) - float(er)) <= 1e-12 * l1


# f32 against float64 from the same f32 points: every product and
# factorization rounds at 6e-8 of its scale. The shift ν = √n·u·‖Y‖ (3.9e-6
# of λ₁ here, the same formula on both sides) is the scale at which the
# rounding of Y enters λ, so λ is held at half of it, 2e-6 of λ₁ (read:
# 1.8e-7); ν itself at 1e-4 (‖Y‖_F in f32; read: 9e-6); the leading 9
# eigenvectors at 1e-4, rounding over gaps of 1.8e-3 (read: 2.4e-6); the
# error estimate, a norm of 3e-4 of λ₁ taken in f32, at 1e-6 of λ₁ (read:
# 1.2e-8)
def test_port_matches_the_plain_reference_in_f32(pair32):
    X, bw, (V, lam, err, nu, fail, _), (Vr, lr, er, nur, fr) = pair32
    l1 = float(lr[0])
    assert V.dtype == torch.float32 and not bool(fail) and not fr
    assert float(nu) == pytest.approx(nur, rel=1e-4)
    assert float((lam.double() - lr).abs().max()) <= 2e-6 * l1
    assert _aligned_gap(V, Vr, 9) <= 1e-4
    assert abs(float(err) - float(er)) <= 1e-6 * l1


def test_leading_pairs_are_separated(pair64):
    """The gaps the V tolerances lean on: λ₁ alone, then eight close
    eigenvalues (the coordinates' own directions, d 8), then a drop of
    ten times."""
    lr = pair64[3][1] / pair64[3][1][0]
    assert float((lr[:9] - lr[1:10]).min()) >= 1e-3, lr[:10]
    assert float(lr[8] / lr[9]) >= 5, lr[:10]


def test_reference_numbers_pass_its_own_output_and_refuse_faults(pair64):
    """On the reference's own output the leading pairs' residuals read
    rounding (pairs 9: 5e-13), λ and V's Rayleigh quotients differ by the
    rank-64 approximation's error in the trailing pairs (7e-6 of λ₁); λ₁
    × 1.01, λ reversed, the breakdown flag and a NaN V are read as
    such."""
    X, bw, _, (Vr, lr, _, _, _) = pair64
    sound = ref.numbers(X, bw, Vr, lr, False, 9)
    assert sound["pair_residual"] <= 1e-11 and sound["lambda_error"] <= 1e-4
    assert sound["orthogonality"] <= 1e-12
    assert sound["order"] == 0 and sound["fail"] == 0
    assert 0.0 < sound["trace_error"] < 1.0
    up = lr.clone()
    up[0] *= 1.01
    assert ref.numbers(X, bw, Vr, up, False, 9)["lambda_error"] == \
        pytest.approx(0.01 / 1.01, rel=1e-6)
    assert ref.numbers(X, bw, Vr, lr.flip(0), False, 9)["order"] > 0
    assert ref.numbers(X, bw, Vr, lr, True, 9)["fail"] == 1.0
    nan = ref.numbers(X, bw, Vr.clone().fill_(float("nan")), lr, False, 9)
    assert math.isnan(nan["pair_residual"])


def test_kernel_times_is_the_dense_product():
    X, bw = _points(torch.float64, n=300)
    M = _starts(n=300, k=5)[0]
    d2 = torch.cdist(X.T, X.T) ** 2
    dense = torch.exp(-d2 / (2 * bw ** 2)) @ M
    assert torch.allclose(ref.kernel_times(X, bw, M, block=64), dense,
                          rtol=0, atol=1e-12)


def test_spans_nest_and_counters_count():
    X, bw = _points(torch.float64, n=256)
    omega, v0 = _starts(n=256, k=16)
    k = 16
    op = SquaredExpKernelLinOp(X, bw, 0.0, evals_include_reg=False)
    with timing.span("off"):
        pass
    with timing.tracing():
        revd2_fixed_rank(op, k, REVD2Config(), RNGState(0), omega=omega,
                         v0=v0)
    sp, cnt = timing.spans(), timing.counters()
    by = {s["id"]: s for s in sp}

    def kids(s):
        return [c["name"] for c in sp if c["parent"] == s["id"]]
    root, = [s for s in sp if s["parent"] is None]
    assert root["name"] == "revd2"
    assert kids(root) == ["syps", "apply_a", "syrf_orth", "apply_a",
                          "nystrom_factor", "error_est"]
    syps_, = [s for s in sp if s["name"] == "syps"]
    assert kids(syps_) == ["apply_a", "stabilize"] * 3
    est, = [s for s in sp if s["name"] == "error_est"]
    assert kids(est) == ["apply_a"] * 10
    assert all(by[s["parent"]]["name"] in ("revd2", "syps", "error_est")
               for s in sp if s["name"] == "apply_a")
    assert cnt["revd2.applies"] == [15, 0]
    assert cnt["revd2.apply_columns"] == [256 * (5 * k + 10), 256 * k]
    assert cnt["revd2.host_reads"] == [4, 0]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spans_leave_the_outputs_bit_for_bit(dtype):
    X, bw = _points(dtype, n=512)
    omega, v0 = _starts(n=512, k=32)
    with timing.span("off"):
        pass
    off = _port(X, bw, omega, v0, k=32)
    with timing.tracing():
        on = _port(X, bw, omega, v0, k=32)
    for a, b in zip(off[:5], on[:5]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_maker_orders_one_point_set_by_the_seed():
    X1, bw1 = _points(torch.float32, n=512, seed=2**40 + 1)
    X2, bw2 = _points(torch.float32, n=512, seed=2**40 + 2)
    again, _ = _points(torch.float32, n=512, seed=2**40 + 1)
    assert torch.equal(X1, again) and not torch.equal(X1, X2)
    assert bw1 == bw2 > 0
    key = (lambda X: X[:, torch.argsort(X[0])])
    assert torch.equal(key(X1), key(X2))
    assert float((X1 * X1).sum(0).mean()) == pytest.approx(D, rel=1e-5)


def test_k4_yardstick_at_the_cells_shapes():
    """n²(2s + 2d + 6) operations (the port's ``kernel_matmat_work``,
    flops and product flops together), n exponentials, (dn + 2ns)·4
    bytes; at n 65536, d 8 the s 1024 product is bound by its operations
    at three TF32 products' rate (53.9 ms), the s 1 product by its
    exponentials (1.03 ms)."""
    n, d = 65536, 8
    for s in (1, 1024):
        ours = yardstick_sqexp.kernel_matmat_work(d, n, s)
        port = kernel_matmat_work(d, n, s)
        assert ours["flops"] == port["flops"] + port["product_flops"]
        assert ours["exps"] == port["special"]
        assert ours["bytes"] == port["nbytes"]
    wide = yardstick_sqexp.bound(yardstick_sqexp.kernel_matmat_work(d, n,
                                                                    1024))
    narrow = yardstick_sqexp.bound(yardstick_sqexp.kernel_matmat_work(d, n,
                                                                      1))
    assert round(wide * 1e3, 1) == 53.9 and round(narrow * 1e3, 2) == 1.03
    sched = harness.entry("revd2_fixed_rank").schedule(
        [n, d], harness.workload(CELL)["settings"])
    assert [w["s"] for w in sched] == [1024] * 5 + [1] * 10


def _made_record(spans_, k4_ms=(600.0, 2.0)):
    """A traced record of one REVD2 call with the given spans: one K4
    launch a product, nothing else on the card."""
    work = yardstick_sqexp.revd2_schedule(65536, 8, 1024, 5, 10)
    dev = [["void kernel_matmat_tc_kernel<1, 16>(float const*)", 0.0,
            k4_ms[0] * 1e-3]] * 5 + [
        ["void kernel_matmat_tc_kernel<1, 1>(float const*)", 0.0,
         k4_ms[1] * 1e-3]] * 10
    return dict(calls=1, window_s=3.5, device=dev, host=[],
                kernel_files={"kernel_matmat": ["kernel_matmat_tc_kernel"]},
                work=work, phases={}, spans=spans_, setup_spans=[])


def _span(i, name, parent, ms):
    return dict(name=name, id=i, call=1, parent=parent, start_ns=i,
                end_ns=i + 1, host_ms=ms, device_ms=ms, self_host_ms=ms,
                self_device_ms=ms)


def test_readers_on_a_made_record():
    sp = [_span(1, "revd2", None, 3500.0), _span(2, "syps", 1, 2000.0),
          _span(3, "apply_a", 2, 600.0), _span(4, "stabilize", 2, 20.0),
          _span(5, "syrf_orth", 1, 50.0), _span(6, "apply_a", 1, 600.0),
          _span(7, "nystrom_factor", 1, 210.0), _span(8, "error_est", 1,
                                                      25.0),
          _span(9, "apply_a", 8, 2.0)]
    rec = _made_record(sp)
    read = {m: harness.reader(m)(rec) for m in (
        "driver.apply_a_device_ms", "driver.stabilize_device_ms",
        "driver.nystrom_factor_device_ms", "kernels.k4_roofline")}
    assert read["driver.apply_a_device_ms"] == pytest.approx(1202.0)
    assert read["driver.stabilize_device_ms"] == pytest.approx(70.0)
    assert read["driver.nystrom_factor_device_ms"] == pytest.approx(210.0)
    least = 5 * 53.88 + 10 * 1.0275
    assert read["kernels.k4_roofline"] == pytest.approx(
        100 * least / (5 * 600 + 10 * 2), rel=1e-3)
    # a program without REVD2's spans (the QR cells', or an older one)
    qr = _made_record([_span(1, "hqrrp", None, 500.0)])
    assert harness.reader("driver.apply_a_device_ms")(qr) is None
    assert harness.reader("driver.nystrom_factor_device_ms")(qr) is None
    json.dumps(rec)


def test_span_trace_reads_revd2_phases_and_counters():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "span_trace", ROOT / "tools" / "span_trace.py")
    st = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(st)
    X, bw = _points(torch.float64, n=256)
    omega, v0 = _starts(n=256, k=16)
    op = SquaredExpKernelLinOp(X, bw, 0.0, evals_include_reg=False)
    with timing.span("off"):
        pass
    with timing.tracing():
        revd2_fixed_rank(op, 16, REVD2Config(), RNGState(0), omega=omega,
                         v0=v0)
    c = st.revd2_checks(timing.spans(), timing.counters(), 1)
    assert c["applies"] == 15 and c["host_reads"] == 4
    assert c["apply_columns"] == pytest.approx(5 + 10 / 16)
    assert set(c["device_ms"]) == set(st.REVD2_PHASES)
    assert st.revd2_checks([_span(1, "hqrrp", None, 1.0)], {}, 1) is None


def test_span_trace_reports_the_wide_columns_share():
    """``k4_wide_columns``: the counter ``k4.wide_columns`` a call and
    its share (the cell's traced call: 5 products at s 1024 of 15, the
    others at s 1); None where the counter is missing, as in a program
    without the wide body."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "span_trace", ROOT / "tools" / "span_trace.py")
    st = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(st)
    roots = [_span(1, "revd2", None, 900.0), _span(2, "revd2", None, 900.0)]
    c = st.revd2_checks(roots, {"k4.wide_columns": [10240, 10260]}, 2)
    assert c["k4_wide_columns"] == {"columns": 5120, "of": 5130,
                                    "share": pytest.approx(5120 / 5130)}
    assert st.revd2_checks(roots, {}, 2)["k4_wide_columns"] is None
