"""The step schedule of K5 and K6's step kernels (csrc/qrcp.cu), modelled
in plain PyTorch by ``ops.qrcp.qrcp_select_pivots_schedule`` and
``qrcp_panel_schedule``, against the plain versions of ``ops/qr.py`` and
the JAX package (its jnp loops and its Pallas kernels in interpret mode),
on the CPU. The kernels themselves are held against the models on the
card (tests/test_torch_cuda.py).

The K5 model takes each step's pivot as the best of the offers of
8-column groups (a warp's columns) and builds the reflector from the
winning offer's column; the K6
model takes each norm and head from the previous step's sums of squares
and row, downdates one step late and pivots through a logical column map.

Gates: pivot orders exactly equal. W and taus within 1e-12 (f64; W
relative to max|W|): the model sums each norm as a plain sum of squares
where the plain version calls vector_norm, a rounding-level difference
(~1e-15) that b steps of Householder updates can grow by a few orders.
Within 1e-4·max|W| and 1e-4 in f32, the kernel tests' gates, for the
same reason at fp32's rounding (~1e-7). Against JAX the f32 gates are
tests/test_torch_qrcp.py's (W 1e-4, V and taus 1e-5). Inputs have their
columns scaled by exp(-3·U), so no two column norms sit within rounding
of each other unless a test makes them tie exactly."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu.ops import pallas_qrcp as jpq

from randlapack_tpu_torch.ops import qrcp as tqrcp

jqr = importlib.import_module("randlapack_tpu.ops.qr")
tqr = importlib.import_module("randlapack_tpu_torch.ops.qr")

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def _spread(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp(-3 * rng.random(shape[1]))[None, :])


def _close(model, ref, tdt):
    """W and taus of ``model`` against ``ref`` (both (W, V, taus, sigma))
    at the gates of the module docstring."""
    W, _, taus, _ = model
    Wr, _, tr, _ = (np.asarray(x) for x in ref)
    W, taus = W.numpy(), taus.numpy()
    tol = 1e-12 if tdt == torch.float64 else 1e-4
    assert np.abs(W - Wr).max() <= tol * np.abs(Wr).max()
    assert np.abs(taus - tr).max() <= tol


# -- K5 -----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d,n,b", [(74, 512, 64), (26, 256, 16)])
def test_select_schedule_matches_jax_and_pallas(dtype, d, n, b):
    npdt, _ = DTYPES[dtype]
    Y = _spread((d, n), d + n).astype(npdt)
    live = np.ones(n, dtype=npdt)
    live[:7] = 0.0
    out = tqrcp.qrcp_select_pivots_schedule(torch.tensor(Y), b,
                                            torch.tensor(live))
    ref = np.asarray(jqr.qrcp_select_pivots(jnp.asarray(Y), b,
                                            jnp.asarray(live)))
    pal = np.asarray(jpq.qrcp_select_pivots_pallas(
        jnp.asarray(Y), b, jnp.asarray(live), interpret=True))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), pal)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d,n,b,offer_cols", [(31, 130, 31, 8),
                                              (33, 130, 33, 8),
                                              (12, 37, 12, 8),
                                              (40, 300, 40, 64),
                                              (65, 200, 60, 3)])
def test_select_schedule_matches_plain(dtype, d, n, b, offer_cols):
    """d below and above a warp's width, n off the width of an offer's
    group (8 columns, a warp's, as the kernel has it; also 64 and 3)."""
    npdt, tdt = DTYPES[dtype]
    Y = torch.tensor(_spread((d, n), 3 * d + n), dtype=tdt)
    live = torch.ones(n, dtype=tdt)
    live[torch.tensor([1, 2, n // 3, n - 1])] = 0.0
    out = tqrcp.qrcp_select_pivots_schedule(Y, b, live, offer_cols)
    assert torch.equal(out, tqr.qrcp_select_pivots(Y, b, live))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_select_schedule_edge_cases(dtype):
    """An exact tie at the first step (a duplicated largest column: the
    lower index), a NaN column (chosen first), zero columns (never ahead
    of a nonzero one) and all but four columns retired (then column 0,
    as torch.argmax's first index of the masked maximum)."""
    _, tdt = DTYPES[dtype]
    Y = _spread((30, 200), 5)
    Y[:, 60] *= 2 * np.linalg.norm(Y, axis=0).max() / np.linalg.norm(
        Y[:, 60])
    Y[:, 150] = Y[:, 60]
    Y[:, [3, 99]] = 0.0
    live = torch.ones(200, dtype=tdt)
    Yt = torch.tensor(Y, dtype=tdt)
    out = tqrcp.qrcp_select_pivots_schedule(Yt, 25, live)
    assert torch.equal(out, tqr.qrcp_select_pivots(Yt, 25, live))
    assert int(out[0]) == 60 and not {150, 3, 99} & set(out.tolist())
    Y[7, 123] = np.nan
    Yt = torch.tensor(Y, dtype=tdt)
    out = tqrcp.qrcp_select_pivots_schedule(Yt, 10, live)
    assert int(out[0]) == 123
    assert int(tqr.qrcp_select_pivots(Yt, 10, live)[0]) == 123
    live = torch.zeros(200, dtype=tdt)
    live[torch.tensor([190, 5, 64, 63])] = 1.0
    Yt = torch.tensor(_spread((30, 200), 6), dtype=tdt)
    out = tqrcp.qrcp_select_pivots_schedule(Yt, 7, live)
    assert torch.equal(out, tqr.qrcp_select_pivots(Yt, 7, live))
    assert out.tolist()[4:] == [0, 0, 0]


# -- K6 -----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("m,b,r0", [(512, 64, 0), (512, 64, 128)])
def test_panel_schedule_matches_jax_and_pallas(dtype, pivot, m, b, r0):
    npdt, tdt = DTYPES[dtype]
    P = np.random.default_rng(m + b + r0).standard_normal((m, b))
    P = P.astype(npdt)
    Wt, Vt, tt, st = tqrcp.qrcp_panel_schedule(torch.tensor(P), r0, pivot)
    assert st.dtype == torch.int64
    _close((Wt, Vt, tt, st), tqr.qrcp_panel(torch.tensor(P), r0, pivot),
           tdt)
    for Wj, Vj, tj, sj in (
            jqr.qrcp_panel(jnp.asarray(P), r0, pivot),
            jpq.qrcp_panel_routed(jnp.asarray(P), r0, pivot,
                                  use_pallas="auto", interpret=True)):
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        if tdt == torch.float32:
            assert np.abs(Wt.numpy() - np.asarray(Wj)).max() < 1e-4
            assert np.abs(Vt.numpy() - np.asarray(Vj)).max() < 1e-5
            assert np.abs(tt.numpy() - np.asarray(tj)).max() < 1e-5
        else:
            _close((Wt, Vt, tt, st), (Wj, Vj, tj, sj), tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("m,b,r0", [(300, 1, 299), (300, 1, 0),
                                    (400, 31, 369), (400, 33, 367),
                                    (400, 33, 50), (300, 40, 100),
                                    (64, 64, 0), (270, 129, 141)])
def test_panel_schedule_matches_plain(dtype, pivot, m, b, r0):
    """b at 1, below and above a warp's width, past the step kernel's 128
    columns, and row0 = m - b (the last panel of a factorization)."""
    _, tdt = DTYPES[dtype]
    P = torch.tensor(_spread((m, b), m + 7 * b + r0), dtype=tdt)
    out = tqrcp.qrcp_panel_schedule(P, r0, pivot)
    ref = tqr.qrcp_panel(P, r0, pivot)
    assert torch.equal(out[3], ref[3])
    _close(out, ref, tdt)
    assert float((out[1] - ref[1]).abs().max()) <= (
        1e-12 if tdt == torch.float64 else 1e-4)
    if not pivot:
        assert torch.equal(out[3], torch.arange(b))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_panel_schedule_edge_cases(dtype):
    """A duplicated largest column (the lower index first, its twin last),
    a zero column (last, tau 0, alpha = x_i = 0) and a NaN column (first,
    and the result still a permutation)."""
    _, tdt = DTYPES[dtype]
    P = _spread((500, 40), 8)
    P[:, 7] *= 2 * np.linalg.norm(P, axis=0).max() / np.linalg.norm(P[:, 7])
    P[:, 30] = P[:, 7]
    Pt = torch.tensor(P, dtype=tdt)
    out = tqrcp.qrcp_panel_schedule(Pt, 60, True)
    ref = tqr.qrcp_panel(Pt, 60, True)
    assert torch.equal(out[3], ref[3])
    assert int(out[3][0]) == 7 and int(out[3][-1]) == 30
    P = _spread((500, 40), 9)
    P[:, 13] = 0.0
    Pt = torch.tensor(P, dtype=tdt)
    out = tqrcp.qrcp_panel_schedule(Pt, 50, True)
    ref = tqr.qrcp_panel(Pt, 50, True)
    assert torch.equal(out[3], ref[3]) and int(out[3][-1]) == 13
    _close(out, ref, tdt)
    assert float(out[2][-1]) == 0.0 and float(out[0][50 + 39, 39]) == 0.0
    P[3, 21] = np.nan
    out = tqrcp.qrcp_panel_schedule(torch.tensor(P, dtype=tdt), 0, True)
    assert int(out[3][0]) == 21
    assert sorted(out[3].tolist()) == list(range(40))
