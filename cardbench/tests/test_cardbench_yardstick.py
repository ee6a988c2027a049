"""The benchmark's frozen arithmetic against the ``chip_smoke.py`` it was
copied from, at the shapes of PERF.md's kernel table (8192² f32)."""
import pytest
import torch

import chip_smoke
from cardbench import yardstick

N = 8192
K1 = (2 * N * 256 * N + N * N, 4 * (N * 256 + N * N + N + 256 * N))
K2 = (2 * N * 1024 * N + 2 * N * N, 4 * (2 * N * N + N * 1024 + 1024 * N + N))
K1_FORM = (2 * N * 256 * N, 4 * (N * 256 + N * N + N + 256 * N))


@pytest.mark.parametrize("work,table_ms", [(K1, 0.2086), (K2, 0.8338)],
                         ids=["K1", "K2"])
def test_bound_matches_chip_smoke(work, table_ms):
    ours = yardstick.bound(*work, tensor=True) * 1e3
    theirs = chip_smoke.bound(*work, tensor=True)["bound_ms"]
    assert ours == pytest.approx(theirs, rel=1e-12)
    assert round(ours, 4) == table_ms


@pytest.mark.parametrize("work,form,table_ms", [
    (K1_FORM, "tf32", 0.0851), (K1_FORM, "bf16x3", 0.1042),
    (K2, "bf16x3", 0.4173)], ids=["K1-tf32", "K1-bf16x3", "K2-bf16x3"])
def test_form_bound_matches_chip_smoke(work, form, table_ms):
    ours = yardstick.form_bound(*work, form) * 1e3
    theirs = chip_smoke.form_bound(*work, form)["bound_ms"]
    assert ours == pytest.approx(theirs, rel=1e-12)
    assert round(ours, 4) == table_ms


def test_k5_k6_work_match_chip_smoke():
    live = torch.ones(N)
    live[: N // 8] = 0.0
    Y = torch.empty(138, N)
    theirs = chip_smoke.select_pivots_work(Y, 128, live)
    ours = yardstick.select_pivots_work(138, N, 128, N - N // 8)
    assert ours == pytest.approx(theirs, rel=1e-15)
    # PERF.md's table: 4.1 µs (K5), 4.0 µs (K6), a call of 128 steps
    assert round(yardstick.bound(*ours) * 1e6, 1) == 4.1
    for r0 in (0, 4096):
        assert yardstick.panel_work(N, 128, r0) == pytest.approx(
            chip_smoke.panel_work(N, 128, r0, 4), rel=1e-15)
    assert round(yardstick.bound(*yardstick.panel_work(N, 128, 0)) * 1e6,
                 1) == 4.0


def test_schedules_count_the_launches():
    """One item a launch: HQRRP 16384², b 128 has 128 K5 + 128 K6, and
    in a K1/K2 form, 4 blocks a group, also 128 K1 and 32 K2; CQRRPT's
    sketch QRCP 16 + 16."""
    assert len(yardstick.hqrrp_schedule(16384, 16384, 128, 10, 4,
                                        "highest")) == 256
    items = yardstick.hqrrp_schedule(16384, 16384, 128, 10, 4, "bf16x3")
    assert len(items) == 256 + 128 + 32
    assert all(w["flops"] >= 0 and w["bytes"] > 0 for w in items)
    assert len(yardstick.hqrrp_schedule(2560, 2048, 128, 10, 1,
                                        "highest")) == 32
