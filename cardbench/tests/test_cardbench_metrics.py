"""Each per-layer reader returns its number from records of traced runs
on the card (``trace.record`` of ``--trace 1`` runs, NVIDIA H100 80GB
HBM3 at 700 W, cut to their first call: ``fixtures/``), and nothing where
the record holds nothing for it."""
import gzip
import json
from pathlib import Path

import pytest

from cardbench import harness, trace

FIX = Path(__file__).resolve().parent / "fixtures"
# (fixture, metric) -> the reader's number on it, read when the fixture
# was cut
EXPECTED = {
    ("trace_bf16x3", "device.idle_share"): 3.3953662495014414,
    ("trace_bf16x3", "host.launches_per_call"): 8886.0,
    ("trace_bf16x3", "kernels.qrcp_roofline"): 0.5940528819019816,
    ("trace_bf16x3", "kernels.trailing_roofline"): 19.402510609455042,
    ("trace_bf16x3", "library.device_ms"): 75.62071199999993,
    ("trace_tall", "device.idle_share"): 6.187157256795983,
    ("trace_tall", "driver.cholqr_ms"): 45.165567000026385,
    ("trace_tall", "driver.qrcp_ms"): 29.82649699998774,
    ("trace_tall", "host.launches_per_call"): 1248.0,
    ("trace_tall", "kernels.qrcp_roofline"): 0.10620698322921088,
    ("trace_tall", "library.device_ms"): 93.28010999999995,
}



def load(name):
    with gzip.open(FIX / f"{name}.json.gz", "rt") as f:
        return json.load(f)


@pytest.mark.parametrize("fixture,metric", sorted(EXPECTED),
                         ids=[f"{f}-{m}" for f, m in sorted(EXPECTED)])
def test_reader_reads_fixture(fixture, metric):
    value = harness.reader(metric)(load(fixture))
    assert value == pytest.approx(EXPECTED[fixture, metric], rel=1e-9)
    if "roofline" in metric or "share" in metric:
        assert 0.0 < value <= 100.0


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    harness.benchmark()["per_layer"]])
def test_reader_finds_nothing_in_an_empty_record(metric):
    rec = dict(calls=1, window_s=1.0, device=[], host=[], kernel_files={},
               work=[], phases={})
    assert harness.reader(metric)(rec) is None


def test_kernel_names_from_sources():
    files = trace.kernel_files(harness.CSRC)
    assert "wy_ring_kernel" in files["wy_ring"]
    assert "add_parts_kernel" in files["tc"]
    assert {"qrcp_select_step_kernel", "qrcp_panel_step_kernel"} <= set(
        files["qrcp"])
    assert trace.matches("void (anonymous namespace)::wy_ring_kernel<true, "
                         "2, false>(float const*, int)", files["wy_ring"])
    assert not trace.matches("void trsm_right_kernel<int, float>()",
                             trace.program_kernels({"kernel_files": files}))


def test_busy_and_breakdown_on_a_made_record():
    rec = dict(calls=2, window_s=10.0, device=[["k1", 1.0, 2.0],
                                               ["k2", 2.0, 2.0],
                                               ["k3", 7.0, 1.0]],
               host=[["cudaStreamSynchronize", 5.0, 1.5]], kernel_files={},
               work=[], phases={})
    assert trace.busy_seconds(rec) == pytest.approx(4.0)
    assert harness.reader("device.idle_share")(rec) == pytest.approx(60.0)
    assert harness.reader("host.launches_per_call")(rec) == 1.5
    bd = trace.breakdown(rec)
    assert bd["device_ops"][0] == ["k1", 2.0]
    assert dict(map(tuple, bd["idle_gaps"])) == pytest.approx(
        {"host": 3.0, "cudaStreamSynchronize": 3.0})
