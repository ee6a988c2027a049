"""The port's HQRRP (randlapack_tpu_torch.drivers.hqrrp) against the JAX
package's on the CPU in f64, with the JAX-drawn uniform sketch operator G
injected into the port (the two packages' random streams differ by
design).

Gates: pivots J exactly equal; R, the packed reflectors, taus and Q
within 1e-10 of the largest entry. Summation order differs between MKL
and XLA's CPU dot, which moves R by a few ulps but Q's column k by about
eps·|r₁₁|/|r_kk|: at cond 1e6 (the JAX grid's matrix) that is 1.7e-10
on the 500×200 case with R still within 5e-16, so the parity grid uses
cond 1e4. Past a numerical rank only the first ``rank`` pivots are
compared, as for BQRRP. Each grid case also holds the driver's own A: a
group of blocks from row c leaves its rows above c bit for bit as they
were, and the counters (``utils.timing.count``) give the rows its
products read."""
import contextlib
import importlib
import inspect
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu import RNGState as JRNG
from randlapack_tpu.drivers import HQRRPConfig as JCfg
from randlapack_tpu.drivers import PanelQR as JPanel
from randlapack_tpu.drivers import hqrrp as j_hqrrp
from randlapack_tpu.drivers import hqrrp_lapack_format as j_lapack
from randlapack_tpu.gen import MatGenInfo, MatType, adversarial_matrix, mat_gen
from randlapack_tpu.ops.householder import apply_reflectors as j_apply

import randlapack_tpu_torch as rt
from randlapack_tpu_torch.drivers import (HQRRPConfig, PanelQR, hqrrp,
                                          hqrrp_lapack_format)
from randlapack_tpu_torch.errors import RandLAPACKError
from randlapack_tpu_torch.interop import (lapack_format_from_numpy,
                                          lapack_format_to_numpy)
from randlapack_tpu_torch.ops import householder as thh
from randlapack_tpu_torch.ops import lu as tlu
from randlapack_tpu_torch.ops import qrcp as tqrcp
from randlapack_tpu_torch.utils import timing

t_hqrrp = importlib.import_module("randlapack_tpu_torch.drivers.hqrrp")


def _gen(m, n, kind, seed, **kw):
    A, st = mat_gen(MatGenInfo(m, n, kind, **kw), JRNG(seed))
    return np.asarray(A), st


def _jax_G(st, d, m):
    """G exactly as hqrrp.py's _hqrrp_core draws it."""
    key, _ = st.spawn()
    return np.asarray(jax.random.uniform(key, (d, m), dtype=jnp.float64,
                                         minval=-1.0, maxval=1.0))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _both(A, st, kw, fn=("hqrrp", "hqrrp"), timing=False):
    m, n = A.shape
    d = min(kw.get("block_size", 64), m, n) + kw.get("oversample", 10)
    G = torch.tensor(_jax_G(st, d, m))
    jkw = dict(kw)
    if "panel_qr" in kw:
        jkw["panel_qr"] = JPanel(kw["panel_qr"].value)
    jf = j_hqrrp if fn[0] == "hqrrp" else j_lapack
    tf = hqrrp if fn[0] == "hqrrp" else hqrrp_lapack_format
    extra = dict(timing=True) if timing else {}
    oj = jf(jnp.asarray(A), JCfg(**jkw), st, **extra)
    ot = tf(torch.tensor(A), HQRRPConfig(**kw), rt.RNGState(3), sketch=G,
            **extra)
    return oj, ot


@contextlib.contextmanager
def _watched(monkeypatch):
    """Trace the port's calls in the scope (``timing.tracing``, so the
    driver's counters count) and keep the driver's A as each group of
    blocks starts (c, A) and as each run of blocks ends (None, A)."""
    seen = []

    def at_start(fn, first):
        def run(st, c, *args, **kw):
            if first(args):
                seen.append((c, st.A.clone()))
            return fn(st, c, *args, **kw)
        return run

    def ends(fn):
        def run(st, *args, **kw):
            fn(st, *args, **kw)
            seen.append((None, st.A.clone()))
        return run

    monkeypatch.setattr(t_hqrrp, "_block_step",
                        at_start(t_hqrrp._block_step, lambda a: True))
    monkeypatch.setattr(t_hqrrp, "_subblock_deferred",
                        at_start(t_hqrrp._subblock_deferred,
                                 lambda a: a[1] == 0))
    monkeypatch.setattr(t_hqrrp, "_blocks", ends(t_hqrrp._blocks))
    with timing.span("off"):
        pass                     # the next root clears the counters
    with timing.tracing():
        yield seen


def _hold_rows(seen, counters, shape, b, defer):
    """Each group of blocks (one block where the updates are eager) at
    row c leaves A's rows above c bitwise as they were; the counters give
    Vᵀ·A's rows as Σ(m − c) over the blocks against nb·m, the update's as
    Σ(m − c₀) over the groups, and no masked copy of A's size."""
    m, n = shape
    K = min(m, n)
    b = min(b, K)
    nb, r = divmod(K, b)
    g = max(1, min(defer, nb))
    tail = [nb * b] if r else []
    blocks = [i * b for i in range(nb)] + tail
    groups = [i * b for i in range(0, nb, g)] + tail
    last = seen[-1][1].view(torch.int64)
    starts = [c for c, _ in seen if c is not None]
    assert starts == groups
    for c, A in seen:
        if c is not None:
            assert torch.equal(A.view(torch.int64)[:c], last[:c]), c
    assert counters["hqrrp.rows.vt_a"] == [sum(m - c for c in blocks),
                                           len(blocks) * m]
    assert counters["hqrrp.rows.a_update"] == [sum(m - c for c in groups),
                                               len(groups) * m]
    assert "hqrrp.masked_copies" not in counters


GRID = [(shape, b, panel, defer, "highest")
        for shape, b in [((500, 200), 50), ((300, 300), 64),
                         ((150, 260), 32)]
        for panel in PanelQR for defer in (1, 4)] + [
    # groups of 3 (a last group of 1 at 500×200), m not a multiple of b
    # (150 = 4·32 + 22; 333 = 6·48 + 45, K 250 = 5·48 + 10)
    ((500, 200), 50, PanelQR.qrcp, 3, "highest"),
    ((150, 260), 32, PanelQR.qrcp, 3, "highest"),
    ((333, 250), 48, PanelQR.cholqr, 3, "highest"),
    # the trailing products as three bf16 products (K1/K2's form)
    ((500, 200), 50, PanelQR.qrcp, 4, "bf16_3x_emul"),
    ((333, 250), 48, PanelQR.geqrf, 1, "bf16_3x_emul"),
    ((150, 260), 32, PanelQR.qrcp, 3, "bf16_3x_emul")]


@pytest.mark.parametrize(
    "shape,b,panel,defer,trailing", GRID,
    ids=[f"{s[0]}x{s[1]}-b{b}-{p.value}-defer{g}"
         + ("" if t == "highest" else f"-{t}") for s, b, p, g, t in GRID])
def test_hqrrp_parity_grid(shape, b, panel, defer, trailing, monkeypatch):
    A, st = _gen(*shape, MatType.polynomial, 5, cond_num=1e4)
    kw = dict(block_size=b, panel_qr=panel, update_defer=defer,
              trailing_precision=trailing)
    with _watched(monkeypatch) as seen:
        oj, ot = _both(A, st, kw)
    counters = timing.counters()
    (Qj, Rj, Jj, rj, fj, _), (Qt, Rt, Jt, rk, fk, st_t) = oj, ot
    K = min(shape)
    if trailing == "highest":
        np.testing.assert_array_equal(Jt.numpy(), np.asarray(Jj))
        assert _rel(Rt, Rj) < 1e-10 and _rel(Qt, Qj) < 1e-10
    else:
        # the gates of tests/test_torch_trailing_modes.py's ``_hold``: the
        # products' fp32 sums in two orders move late pivots, and Q's
        # column k by about their error times |r₁₁|/|r_kk|
        r = K // 2
        np.testing.assert_array_equal(Jt.numpy()[:r], np.asarray(Jj)[:r])
        assert _rel(Rt[:r][:, np.argsort(Jt.numpy())],
                    np.asarray(Rj)[:r][:, np.argsort(np.asarray(Jj))]) \
            < 1e-5
    assert bool(fk) == bool(fj) is False and int(rk) == int(rj)
    assert st_t.counter == 1
    res = torch.linalg.norm(Qt @ Rt - torch.tensor(A)[:, Jt]) \
        / np.linalg.norm(A)
    assert float(res) < (1e-13 if trailing == "highest" else 3e-5)
    assert float(torch.linalg.norm(Qt.T @ Qt - torch.eye(
        K, dtype=Qt.dtype))) < 1e-12
    _hold_rows(seen, counters, shape, b, defer)


CASES = [
    # K = 210 with b = 64: a remainder block of 18
    ("remainder_317x210", (317, 210, MatType.exponential, 7),
     dict(cond_num=1e4), dict(block_size=64, update_defer=4), None),
    ("block_bigger_than_k", (120, 40, MatType.gaussian, 8), {},
     dict(block_size=64), None),
    # numerical rank 40: past it pivots are picked among rounding-level
    # columns, where the summation orders may pick differently
    ("rank_deficient_40", (200, 160, MatType.polynomial, 9),
     dict(cond_num=1e4, rank=40), dict(block_size=32, update_defer=2), 40),
]


@pytest.mark.parametrize("name,gen,gkw,kw,r", CASES,
                         ids=[c[0] for c in CASES])
def test_hqrrp_lapack_format_parity(name, gen, gkw, kw, r):
    m, n, kind, seed = gen
    A, st = _gen(m, n, kind, seed, **gkw)
    oj, ot = _both(A, st, kw, fn=("lapack", "lapack"))
    (pj, tj, Rj, Jj, _), (pt, tt, Rt, Jt, _) = oj, ot
    K = min(m, n)
    r = K if r is None else r
    np.testing.assert_array_equal(Jt.numpy()[:r], np.asarray(Jj)[:r])
    # R's leading r rows in the original column order (= Q[:, :r]ᵀ·A,
    # whatever order the columns past the rank took)
    assert _rel(Rt[:r][:, np.argsort(Jt.numpy())],
                np.asarray(Rj)[:r][:, np.argsort(np.asarray(Jj))]) < 1e-10
    assert _rel(pt[:, :r], np.asarray(pj)[:, :r]) < 1e-10
    assert _rel(tt[:r], np.asarray(tj)[:r]) < 1e-10
    Qj = np.asarray(j_apply(pj, tj))
    Qt = thh.apply_reflectors(pt, tt)
    assert _rel(Qt[:, :r], Qj[:, :r]) < 1e-10
    X = torch.tensor(np.random.default_rng(1).standard_normal((K, 3)))
    assert _rel(thh.apply_reflectors(pt, tt, X), Qt @ X) < 1e-14
    res = torch.linalg.norm(Qt @ Rt - torch.tensor(A)[:, Jt]) \
        / np.linalg.norm(A)
    assert float(res) < 1e-13
    # the GEQP3-format tuple crosses the packages through numpy
    back = lapack_format_from_numpy(
        {"packed": np.asarray(pj), "taus": np.asarray(tj),
         "R": np.asarray(Rj), "J": np.asarray(Jj)}, device="cpu")
    assert back[3].dtype == torch.int64
    assert _rel(thh.apply_reflectors(back[0], back[1]), Qj) < 1e-14
    arrays = lapack_format_to_numpy(pt, tt, Rt, Jt)
    assert sorted(arrays) == ["J", "R", "packed", "taus"]
    assert np.array_equal(arrays["J"], Jt.numpy())


def test_cholqr_panel_breakdown_stays_finite():
    """The adversarial input of tests/test_edge_cases.py:206 through CholQR
    panels: finite outputs with ``fail`` raised, as in JAX."""
    A, _ = adversarial_matrix(222, 99, JRNG(520), jnp.float64)
    A = np.asarray(A)
    kw = dict(block_size=16, panel_qr=PanelQR.cholqr)
    oj, ot = _both(A, JRNG(520), kw)
    Qt, Rt, Jt, _, ft, _ = ot
    assert bool(torch.isfinite(Qt).all() and torch.isfinite(Rt).all())
    assert bool(ft) and bool(oj[4])
    assert sorted(Jt.tolist()) == list(range(99))


def test_timing_phases_match_jax():
    A, st = _gen(160, 120, MatType.polynomial, 4, cond_num=1e3)
    kw = dict(block_size=32, update_defer=4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        oj, ot = _both(A, st, kw, timing=True)
    assert sum("forces eager" in str(w.message) for w in caught) == 2
    assert set(ot[6]) == set(oj[6])
    assert {"qrcp", "qr", "wy_t", "updating_A", "updating_sketch_g",
            "updating_sketch_y", "downdating"} <= set(ot[6])
    np.testing.assert_array_equal(ot[2].numpy(), np.asarray(oj[2]))
    assert _rel(ot[1], oj[1]) < 1e-10


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never launches a kernel, under "auto" or "never", and
    both routes give the same factorization."""
    A, st = _gen(130, 100, MatType.polynomial, 6, cond_num=1e4)
    At = torch.tensor(A)
    for counts in (tqrcp.LAUNCHES, tlu.LAUNCHES):
        for name in counts:
            counts[name] = 0
    outs = [hqrrp(At, HQRRPConfig(block_size=32, pallas_qrcp=route,
                                  pallas_panel=route), rt.RNGState(1))
            for route in ("auto", "never")]
    assert not any(tqrcp.LAUNCHES.values())
    assert tlu.LAUNCHES == {"getrfnp": 0, "getrfnp_flat": 0}
    for a, b in zip(outs[0][:5], outs[1][:5]):
        assert torch.equal(a, b)


def test_drawn_sketch_is_replayable_and_leaves_A():
    A, _ = _gen(140, 96, MatType.polynomial, 2, cond_num=1e5)
    At = torch.tensor(A)
    A0 = At.clone()
    cfg = HQRRPConfig(block_size=32, update_defer=2)
    Q1, R1, J1, _, f1, s1 = hqrrp(At, cfg, rt.RNGState(4))
    Q2, R2, J2, _, _, _ = hqrrp(At, cfg, rt.RNGState(4))
    assert torch.equal(At, A0) and s1.counter == 1 and not bool(f1)
    assert torch.equal(J1, J2) and torch.equal(R1, R2)
    res = torch.linalg.norm(Q1 @ R1 - At[:, J1]) / torch.linalg.norm(At)
    assert float(res) < 1e-13


def test_float32_headline_config_gates():
    """bench.py's config 6 (b 128, defer 4) scaled to 512², in f32 on the
    CPU, against the f32 gates chip_smoke.py applies at 8192²."""
    A, st = rt.gen.fast_decay_matrix(512, 512, rt.RNGState(7),
                                     device="cpu")
    packed, taus, R, J, _ = hqrrp_lapack_format(
        A, HQRRPConfig(block_size=128, update_defer=4), st)
    Q = thh.apply_reflectors(packed, taus)
    gate = 10 * float(np.finfo(np.float32).eps) ** 0.75
    res = float(torch.linalg.norm(Q @ R - A[:, J]) / torch.linalg.norm(A))
    orth = float(torch.linalg.norm(Q.T @ Q - torch.eye(512)))
    assert res <= gate and orth <= gate * math.sqrt(512), (res, orth)


@pytest.mark.parametrize("field,value,exc", [
    # refused until the row-sharded mode was ported (the id is kept): now
    # it needs a mesh of that axis set (parallel.set_mesh), and with none
    # it raises ValueError
    pytest.param("shard_axis", "rows", ValueError,
                 id="shard_axis-rows-NotImplementedError"),
    # refused until the trailing modes were ported (the id is kept): now
    # it runs, and on the CPU "default" is the "highest" product
    pytest.param("trailing_precision", "default", None,
                 id="trailing_precision-default-NotImplementedError"),
    ("pallas_qrcp", "always", RandLAPACKError),
    ("pallas_panel", "always", RandLAPACKError),
])
def test_unported_options_refused(field, value, exc):
    A = torch.eye(16, dtype=torch.float64)
    if exc is None:
        A, _ = _gen(96, 80, MatType.polynomial, 4, cond_num=1e4)
        A = torch.tensor(A)
        for defer in (1, 2):
            runs = [hqrrp(A, HQRRPConfig(block_size=16, update_defer=defer,
                                         **kw), rt.RNGState(0))
                    for kw in ({field: value}, {})]
            assert all(torch.equal(x, y) for x, y in zip(*runs)
                       if isinstance(x, torch.Tensor))
        return
    with pytest.raises(exc):
        hqrrp(A, HQRRPConfig(block_size=4, **{field: value}),
              rt.RNGState(0))


def test_bad_sketch_shape_and_precision_refused():
    A = torch.eye(16, dtype=torch.float64)
    with pytest.raises(RandLAPACKError):
        hqrrp(A, HQRRPConfig(block_size=4), rt.RNGState(0),
              sketch=torch.zeros(3, 16, dtype=torch.float64))
    # precision="high" was refused until the driver-level precision was
    # ported; on the CPU it is the "highest" product, bit for bit
    runs = [hqrrp(A, HQRRPConfig(block_size=4), rt.RNGState(0),
                  precision=p) for p in ("high", "highest")]
    assert all(torch.equal(x, y) for x, y in zip(*runs)
               if isinstance(x, torch.Tensor))


def test_entry_points_default_to_the_card():
    """The user-facing generators and converters make their tensors on
    the card unless the caller asks for the CPU; the port's defaults for
    the two HQRRP kernels are "auto"."""
    for fn in (rt.gen.fast_decay_matrix, rt.interop.factors_from_numpy,
               lapack_format_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    cfg = HQRRPConfig()
    assert cfg.pallas_qrcp == cfg.pallas_panel == "auto"


def _last_block_cond(A, b):
    """Condition number of the last b×b trailing block of A's R from
    LAPACK geqp3 in f64."""
    import scipy.linalg
    R = scipy.linalg.qr(A.astype(np.float64), mode="r", pivoting=True)[0]
    s = np.linalg.svd(R[-b:, -b:], compute_uv=False)
    return s[0] / s[-1]


def test_f32_cholqr_panels_break_on_an_ill_conditioned_last_block():
    """CholQR panels square a panel's condition number, so in f32 they
    break down where a panel's exceeds 1/√eps32 (2.9e3). A square
    ``fast_decay_matrix`` ends in such a block (its square Gaussian factor
    puts a cliff at the tail of the spectrum): at 512², b 128, seed 1 the
    last 128×128 trailing block has condition 1.2e5, and both packages'
    f32 HQRRP with CholQR panels raise ``fail``. A matrix with orthogonal
    factors and the same e^(−6i/n) spectrum keeps the block near 10, and
    neither raises it. (chip_smoke.py's sharded CholQR-panel entry runs on
    such a matrix for this reason.)"""
    from randlapack_tpu.gen import fast_decay_matrix as j_fast_decay
    n, b = 512, 128
    g = np.random.default_rng(1)
    Q1 = np.linalg.qr(g.standard_normal((n, n)))[0]
    Q2 = np.linalg.qr(g.standard_normal((n, n)))[0]
    smooth = ((Q1 * np.exp(-6.0 * np.arange(n) / n)) @ Q2.T).astype(
        np.float32)
    cliff = np.asarray(j_fast_decay(n, n, JRNG(1), dtype=jnp.float32)[0])
    eps32 = float(np.finfo(np.float32).eps)
    for A, broken in ((cliff, True), (smooth, False)):
        assert (_last_block_cond(A, b) > 1 / math.sqrt(eps32)) == broken
        st = JRNG(101)
        fj = j_hqrrp(jnp.asarray(A), JCfg(block_size=b,
                                          panel_qr=JPanel.cholqr), st)[4]
        key, _ = st.spawn()
        G = np.asarray(jax.random.uniform(key, (b + 10, n),
                                          dtype=jnp.float32, minval=-1.0,
                                          maxval=1.0))
        ft = hqrrp(torch.tensor(A), HQRRPConfig(
            block_size=b, panel_qr=PanelQR.cholqr), rt.RNGState(0),
            sketch=torch.tensor(G))[4]
        assert bool(fj) == bool(ft) == broken
