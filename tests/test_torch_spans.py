"""The port's spans (``utils.timing.span``): their nesting and self
times, that a call with the switch off records nothing, the slots HQRRP
and CQRRPT record on both of HQRRP's paths, the set-up spans, and the
span readers of the benchmark (``cardbench/spans.py``) on made records
and on records traced on the card (``cardbench/tests/fixtures/``). One
test, marked ``cuda``, traces small calls on the card and reads every
span metric there. Imports no JAX."""
import collections
import gzip
import importlib.util
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from randlapack_tpu_torch import RNGState, _build
from randlapack_tpu_torch.drivers import (CQRRPTConfig, HQRRPConfig, cqrrpt,
                                          hqrrp, hqrrp_lapack_format)
from randlapack_tpu_torch.drivers.cqrrpt import QRCPKind
from randlapack_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cardbench import harness  # noqa: E402
from cardbench import spans as cspans  # noqa: E402

FIX = ROOT / "cardbench" / "tests" / "fixtures"
SLOTS = ["qrcp", "qr", "wy_t", "updating_A", "updating_sketch_g",
         "updating_sketch_y", "downdating"]
# the metrics read from the spans of the traced calls and the set-up (the
# two read from timing=True calls after the window aside)
SPAN_METRICS = [m["name"] for m in harness.benchmark()["per_layer"]
                if m["source"] == "program_span"
                and m["name"] not in ("driver.qrcp_ms", "driver.cholqr_ms")]


@pytest.fixture
def fresh():
    """The switch read off once more, so the next root that reads it on
    clears what earlier tests recorded."""
    with timing.span("off"):
        pass
    yield


def _tall(m=1200, n=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(m, n, generator=g, dtype=torch.float64)


def _square(n=160, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, n, generator=g, dtype=torch.float64)


def _children(sp, parent):
    return [s for s in sp if s["parent"] == parent["id"]]


def test_spans_nest_with_parents_calls_and_self_time(fresh):
    with timing.tracing():
        with timing.span("outer"):
            with timing.span("a"):
                time.sleep(0.002)
            with timing.span("b"):
                with timing.span("c"):
                    time.sleep(0.001)
        with timing.span("second"):
            pass
    sp = timing.spans()
    assert [s["name"] for s in sp] == ["outer", "a", "b", "c", "second"]
    by = {s["name"]: s for s in sp}
    assert by["outer"]["parent"] is None and by["second"]["parent"] is None
    assert by["a"]["parent"] == by["b"]["parent"] == by["outer"]["id"]
    assert by["c"]["parent"] == by["b"]["id"]
    assert {by[k]["call"] for k in "abc"} == {by["outer"]["id"]}
    assert by["second"]["call"] == by["second"]["id"]
    assert by["a"]["host_ms"] >= 2.0 and by["c"]["host_ms"] >= 1.0
    assert by["outer"]["self_host_ms"] == pytest.approx(
        by["outer"]["host_ms"] - by["a"]["host_ms"] - by["b"]["host_ms"])
    assert by["b"]["self_host_ms"] == pytest.approx(
        by["b"]["host_ms"] - by["c"]["host_ms"])
    assert 0.0 <= by["outer"]["self_host_ms"] < by["outer"]["host_ms"]
    for s in sp:
        assert s["device_ms"] is None and s["self_device_ms"] is None
        assert s["start_ns"] <= s["end_ns"]


def test_buffer_clears_when_the_switch_turns_on(fresh):
    with timing.tracing():
        with timing.span("one"):
            pass
    with timing.tracing():
        with timing.span("two"):
            pass
    assert [s["name"] for s in timing.spans()] == ["one", "two"]
    with timing.span("off"):
        pass
    assert [s["name"] for s in timing.spans()] == ["one", "two"]
    with timing.tracing():
        with timing.span("three"):
            pass
    assert [s["name"] for s in timing.spans()] == ["three"]


def test_counters_count_only_while_recording(fresh):
    timing.count("x", 5, 9)                 # no span open
    with timing.span("off"):
        timing.count("x", 5, 9)             # the switch off
    with timing.tracing():
        with timing.span("one"):
            timing.count("x", 2, 4)
            timing.count("x", 1, 4)
            timing.count("y")
    assert timing.counters() == {"x": [3, 8], "y": [1, 0]}
    with timing.span("off"):
        timing.count("x")
    assert timing.counters() == {"x": [3, 8], "y": [1, 0]}
    with timing.tracing():
        with timing.span("two"):
            pass
    assert timing.counters() == {}


def test_off_call_records_nothing_reads_no_clock_makes_no_event(
        monkeypatch, fresh):
    A, B = _square(), _tall()
    cfg = HQRRPConfig(block_size=32, update_defer=4)
    hqrrp_lapack_format(A, cfg, RNGState(0))
    before = [s["id"] for s in timing.spans()]

    def refuse(*args, **kwargs):
        raise AssertionError("an off span read a clock or made a record")
    monkeypatch.setattr(timing, "_now_ns", refuse)
    monkeypatch.setattr(timing, "_record_function", refuse)
    monkeypatch.setattr(timing._REC, "event", refuse)
    hqrrp_lapack_format(A, cfg, RNGState(0))
    hqrrp(A, HQRRPConfig(block_size=32), RNGState(0))
    cqrrpt(B, CQRRPTConfig(qrcp=QRCPKind.hqrrp, bqrrp_block=16),
           RNGState(0))
    assert [s["id"] for s in timing.spans()] == before
    with timing.span("root") as root:
        assert root is timing._OFF_ROOT
        assert timing.span("inner") is timing._NO_SPAN
        assert timing.span("inner2") is timing._NO_SPAN


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, timing.spans(), prof


@pytest.mark.parametrize("update_defer", [1, 4], ids=["eager", "deferred"])
def test_hqrrp_records_each_slot_once_a_block(update_defer, fresh):
    A = _square(200)
    cfg = HQRRPConfig(block_size=32, update_defer=update_defer)
    _, sp, prof = _profiled(lambda: hqrrp_lapack_format(A, cfg,
                                                        RNGState(3)))
    roots = [s for s in sp if s["parent"] is None]
    assert [r["name"] for r in roots] == ["hqrrp"]
    assert [s["name"] for s in _children(sp, roots[0])] == [
        "sketch", "blocks", "epilogue"]
    blocks_span = next(s for s in sp if s["name"] == "blocks")
    under = _children(sp, blocks_span)
    blocks = [s for s in under if s["name"] == "block"]
    assert len(blocks) == 7          # 6 blocks of 32 and one of 8
    for b in blocks:
        assert [s["name"] for s in _children(sp, b)] == SLOTS
    # each group of update_defer blocks ends in one update of A and of G
    groups = [s["name"] for s in under if s["name"] != "block"]
    assert groups == ([] if update_defer == 1 else
                      ["updating_A", "updating_sketch_g"] * 2)
    assert {"hqrrp", "block", "qrcp", "updating_A"} <= {
        e.key for e in prof.key_averages()}


def test_cqrrpt_records_its_slots_with_a_nested_hqrrp(fresh):
    B = _tall()
    cfg = CQRRPTConfig(qrcp=QRCPKind.hqrrp, bqrrp_block=16,
                       orthogonalization=True)
    _, sp, _ = _profiled(lambda: cqrrpt(B, cfg, RNGState(4)))
    root = next(s for s in sp if s["parent"] is None)
    assert root["name"] == "cqrrpt"
    top = _children(sp, root)
    assert [s["name"] for s in top] == [
        "saso", "qrcp", "rank_reveal", "a_mod_piv", "a_mod_trsm", "cholqr",
        "orth"]
    qrcp = top[1]
    assert [s["name"] for s in _children(sp, qrcp)] == ["hqrrp"]
    assert [s["name"] for s in _children(sp, top[5])] == [
        "cholqr_gram", "cholqr_potrf", "cholqr_qform", "cholqr_unprec"]
    assert collections.Counter(s["name"] for s in sp)["block"] == 4
    assert all(s["call"] == root["id"] for s in sp)


def test_cqrrpt_blockinv_solve_is_one_span(fresh):
    cfg = CQRRPTConfig(qrcp=QRCPKind.hqrrp, bqrrp_block=16,
                       trsm_mode="blockinv", trsm_block=16)
    _, sp, _ = _profiled(lambda: cqrrpt(_tall(), cfg, RNGState(5)))
    root = next(s for s in sp if s["parent"] is None)
    assert [s["name"] for s in _children(sp, root)] == [
        "saso", "qrcp", "rank_reveal", "a_mod_trsm", "cholqr"]


def test_timing_dicts_unchanged_and_spans_beside_them(fresh):
    A = _square(200)
    with pytest.warns(UserWarning, match="forces eager"):
        with timing.tracing():
            out = hqrrp(A, HQRRPConfig(block_size=32, update_defer=4),
                        RNGState(6), timing=True)
    assert set(out[-1]) == {"sketch", "blocks", "epilogue", *SLOTS}
    assert all(v > 0 for v in out[-1].values())
    sp = timing.spans()
    blocks = [s for s in sp if s["name"] == "block"]
    assert len(blocks) == 7
    for b in blocks:
        assert [s["name"] for s in _children(sp, b)] == SLOTS
    with timing.tracing():
        *_, times = cqrrpt(_tall(), CQRRPTConfig(qrcp=QRCPKind.hqrrp,
                                                 bqrrp_block=16),
                           RNGState(7), timing=True)
    assert set(times) == {"saso", "qrcp", "rank_reveal", "a_mod_piv",
                          "a_mod_trsm", "cholqr", "cholqr_gram",
                          "cholqr_potrf", "cholqr_qform", "cholqr_unprec"}
    assert times["cholqr"] >= times["cholqr_gram"]
    names = {s["name"] for s in timing.spans()}
    assert set(times) <= names


def test_phase_timer_accumulates_and_is_a_span(fresh):
    t = timing.PhaseTimer()
    with timing.tracing():
        for _ in range(2):
            with t.phase("p"):
                time.sleep(0.001)
    assert set(t.report()) == {"p"} and t.report()["p"] >= 0.002
    assert [s["name"] for s in timing.spans()] == ["p", "p"]
    assert timing.UNTIMED.report() == {}


def test_setup_spans_import_first_call_and_kernels(monkeypatch, tmp_path):
    names = [s["name"] for s in timing.setup_spans()]
    assert names.count("setup.import") == 1
    assert names.count("setup.first_call") <= 1
    # the kernels' load, and a build with an nvcc that only writes its -o
    srcs = []
    for name in ("one.cu", "two.cu"):
        (tmp_path / name).write_text(f"// {name}\n")
        srcs.append(tmp_path / name)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_sources", lambda: srcs)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_fns", None)
    monkeypatch.setattr(_build, "_load", lambda: (_build.build(), {})[1])
    assert _build.lib() == {}
    sp = timing.setup_spans()
    kern = [s for s in sp if s["name"] == "setup.kernels"][-1]
    nv = [s for s in sp if s["name"] == "nvcc"][-1]
    assert nv["parent"] == kern["id"]
    each = [s for s in sp if s["parent"] == nv["id"]]
    assert sorted(s["name"] for s in each) == ["one.cu", "two.cu"]
    assert all(s["host_ms"] <= nv["host_ms"] for s in each)
    assert len(list((tmp_path / "kernels").glob("*.so"))) == 2
    # a second load finds every library built: no nvcc span
    monkeypatch.setattr(_build, "_fns", None)
    _build.lib()
    assert [s["name"] for s in timing.setup_spans()].count("nvcc") == len(
        [s for s in sp if s["name"] == "nvcc"])


# -- the readers: made records, then the card's


def _made(offset=3.25, lag=2e-6, drop=None, stray=None):
    """Two calls' spans (a root with two children each) and a record whose
    ``cudaEventRecord`` calls sit ``offset`` s after the stamps, ``lag``
    late; a synchronize inside the first root and one after each."""
    sp, t, ident = [], 1_000_000_000, 0
    for _ in range(2):
        ident += 1
        root = dict(name="hqrrp", id=ident, call=ident, parent=None,
                    start_ns=t, device_ms=10.0)
        for k, name in enumerate(("sketch", "blocks")):
            ident += 1
            sp.append(dict(name=name, id=ident, call=root["id"],
                           parent=root["id"], start_ns=t + 100_000 +
                           k * 4_000_000, end_ns=t + 3_900_000 +
                           k * 4_000_000, device_ms=4.0))
        root["end_ns"] = t + 8_000_000
        sp.append(root)
        t += 10_000_000
    sp.sort(key=lambda s: s["id"])
    edges = sorted([(s["start_ns"], s["id"]) for s in sp]
                   + [(s["end_ns"], s["id"]) for s in sp])
    t0 = edges[0][0] * 1e-9 + offset - 0.003
    host = [["cudaEventRecordWithFlags", ns * 1e-9 + offset + lag - t0,
             3e-6] for ns, _ in edges]
    # the card busy 1-3 ms and 5-7 ms into each root: idle 2 ms inside
    # each, the rest of its idle outside the roots
    device = [["k", host[i][1] + a, 2e-3] for i in (0, 6)
              for a in (1e-3, 5e-3)]
    syncs = [["cudaStreamSynchronize", host[1][1] + 1e-3, 1e-4],
             ["cudaDeviceSynchronize", host[5][1] + 20e-6, 1e-3],
             ["cudaDeviceSynchronize", host[-1][1] + 20e-6, 1e-3]]
    if drop is not None:
        del host[drop]
    if stray is not None:
        host[stray][1] -= 100e-6
    host = sorted(host + syncs, key=lambda h: h[1])
    return dict(calls=2, window_s=0.025, device=device, host=host,
                kernel_files={}, work=[], phases={}, spans=sp,
                setup_spans=[])


def test_alignment_recovers_a_planted_offset():
    rec = _made()
    at = cspans.align(rec, cspans.of(rec))
    first = min(s["start_ns"] for s in rec["spans"])
    t0 = first * 1e-9 + 3.25 - 0.003
    assert at[1, True][0] == pytest.approx(0.003 + 2e-6, abs=1e-9)
    for s in rec["spans"]:
        assert at[s["id"], True][0] == pytest.approx(
            s["start_ns"] * 1e-9 + 3.25 + 2e-6 - t0, abs=1e-9)
    roots = cspans.root_intervals(rec)
    assert len(roots) == 2 and roots[0][1] < roots[1][0]
    assert cspans.syncs_per_call(rec) == 0.5
    assert cspans.idle_in_roots_share(rec) == pytest.approx(
        100 * 2 * 2e-3 / 0.025, rel=1e-9)
    assert harness.reader("device.idle_share")(rec) == pytest.approx(
        100 * (1 - 8e-3 / 0.025), rel=1e-9)


@pytest.mark.parametrize("bad", [dict(drop=3), dict(stray=2)],
                         ids=["count", "stray"])
def test_alignment_refuses_a_mismatch(bad):
    rec = _made(**bad)
    assert cspans.align(rec, cspans.of(rec)) is None
    assert cspans.syncs_per_call(rec) is None
    assert cspans.idle_in_roots_share(rec) is None


def test_readers_keep_the_last_calls_roots():
    rec = _made()
    rec["calls"] = 1
    assert [s["parent"] for s in cspans.of(rec)].count(None) == 1
    assert cspans.device_ms(rec, lambda s, up: up is None) == 10.0
    rec["calls"] = 3
    assert cspans.of(rec) is None


def _load(name):
    with gzip.open(FIX / f"{name}.json.gz", "rt") as f:
        return json.load(f)


# (fixture, metric) -> the reader's number on it, read when the fixture
# was saved: one call of each, traced on an H100 by tools/span_trace.py
# (the tall cell at its size; the square cell's settings at 4096²)
EXPECTED = {
    ('trace_spans_square4096', 'device.idle_in_driver_share'):
        14.998750410823867,
    ('trace_spans_square4096', 'driver.pivots_device_ms'): 51.96415984630585,
    ('trace_spans_square4096', 'driver.sketch_update_device_ms'):
        5.015743998810649,
    ('trace_spans_square4096', 'driver.trailing_device_ms'):
        10.281184017658234,
    ('trace_spans_square4096', 'host.syncs_per_call'): 0.0,
    ('trace_spans_square4096', 'setup.first_call_s'): 0.576325338,
    ('trace_spans_square4096', 'setup.import_s'): 0.30619097,
    ('trace_spans_square4096', 'setup.kernels_s'): 0.039712123999999994,
    ('trace_spans_tall', 'device.idle_in_driver_share'): 1.7976848733802493,
    ('trace_spans_tall', 'driver.cholqr_device_ms'): 44.637664794921875,
    ('trace_spans_tall', 'driver.pivots_device_ms'): 23.98777598142624,
    ('trace_spans_tall', 'driver.saso_device_ms'): 21.853824615478516,
    ('trace_spans_tall', 'host.syncs_per_call'): 0.0,
    ('trace_spans_tall', 'setup.first_call_s'): 0.8157629949999999,
    ('trace_spans_tall', 'setup.import_s'): 0.272344009,
    ('trace_spans_tall', 'setup.kernels_s'): 0.021347946,
}


@pytest.mark.parametrize("fixture,metric", sorted(EXPECTED),
                         ids=[f"{f}-{m}" for f, m in sorted(EXPECTED)])
def test_span_reader_reads_the_card_fixture(fixture, metric):
    value = harness.reader(metric)(_load(fixture))
    assert value == pytest.approx(EXPECTED[fixture, metric], rel=1e-9)


@pytest.mark.parametrize("fixture", ["trace_spans_square4096",
                                     "trace_spans_tall"])
def test_card_fixture_spans_cover_the_calls(fixture):
    """On the card the spans pair with the trace's records one for one;
    the root spans' device time lies between the card's busy time and the
    traced stretch, and their children cover them."""
    rec = _load(fixture)
    c = _span_trace().checks(rec)
    assert c["edges"] == c["event_records"] and c["aligned"]
    assert c["busy_ms"] <= c["root_ms"] <= c["stretch_ms"]
    assert c["children_share"] == pytest.approx(1.0, abs=0.02)
    assert sum(c["launches_by_span"].values()) == pytest.approx(
        c["launches_a_call"])
    assert c["unknown_parent"] == 0
    assert harness.reader("device.idle_in_driver_share")(rec) <= \
        harness.reader("device.idle_share")(rec)
    # the same record with one anchor lost reads nothing aligned
    rec["host"] = [h for i, h in enumerate(rec["host"])
                   if i != next(j for j, g in enumerate(rec["host"])
                                if g[0].startswith("cudaEventRecord"))]
    assert cspans.root_intervals(rec) is None


def _span_trace():
    spec = importlib.util.spec_from_file_location(
        "span_trace", ROOT / "tools" / "span_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_span_trace_shows_the_rows_hqrrp_reads(fresh):
    """``tools/span_trace.py`` on the CPU, the square cell cut to 256² at
    b 32 (8 blocks, 2 groups of 4): each product with a block's
    reflectors reads A's rows from the block's first row down, the
    group's updates and each block's VᵀV from the group's; no mask lies
    on an operand the size of A."""
    st = _span_trace()
    rec = st.traced("square16384.hqrrp", 2**31 + 11, 2, (256, 256),
                    {"block_size": 32}, "cpu")
    c = st.checks(rec)
    blocks = sum(256 - 32 * i for i in range(8)) / (8 * 256)
    groups = (256 + 128) / (2 * 256)
    assert c["rows_share"] == {"a_update": groups, "g_update": groups,
                               "g_v": blocks, "vt_a": blocks,
                               "wy_t": (4 * 256 + 4 * 128) / (8 * 256)}
    assert c["masked_copies"] == 0
    assert st.checks({**rec, "counters": None})["rows_share"] is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell,shape,settings", [
    ("square16384.hqrrp", (2048, 2048), {}),
    ("square16384.hqrrp_bf16x3", (2048, 2048), {}),
    ("tall131072x2048.cqrrpt_hqrrp", (32768, 512), {}),
], ids=["hqrrp", "bf16x3", "tall"])
def test_span_metrics_read_on_the_card(cell, shape, settings, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the spans' events need the card")
    st = _span_trace()
    rec = st.traced(cell, 2**31 + 11, 2, shape, settings, "cuda")
    names = [m["name"] for m in harness.metrics_of(cell, "per_layer")
             if m["name"] in SPAN_METRICS]
    assert names
    for name in names:
        assert harness.reader(name)(rec) is not None, name
    c = st.checks(rec)
    assert c["edges"] == c["event_records"] and c["aligned"]
    assert c["busy_ms"] * 0.99 <= c["root_ms"] <= c["stretch_ms"] * 1.01
    assert c["children_share"] == pytest.approx(1.0, abs=0.03)
    idle = harness.reader("device.idle_share")(rec)
    assert harness.reader("device.idle_in_driver_share")(rec) <= idle
    # the spans add no device activity
    monkeypatch.setattr(timing, "_switch", lambda: False)
    off = st.traced(cell, 2**31 + 11, 2, shape, settings, "cuda")
    assert len(off["device"]) == len(rec["device"])
