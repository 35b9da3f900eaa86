"""The reduction of a profiler trace: the union of device intervals, the
idle share, and each gap charged to the host range open when it began."""
import pytest

from perfbench.core import trace


def test_union_merges_overlaps():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]


def test_busy_idle_and_gaps():
    window = (0, 1000)
    device = [("k1", 100, 300), ("k2", 200, 400), ("k1", 600, 700), ("k3", 950, 1200)]
    host = [("pb::step", 0, 500), ("pb::decode_step", 50, 450), ("pb::client", 500, 1000)]
    t = trace.reduce(window, device, host)
    assert t.busy_s == pytest.approx((300 + 100 + 50) / 1e9)
    assert t.window_s == pytest.approx(1e-6)
    assert 1 - t.busy_s / t.window_s == pytest.approx(0.55)
    assert t.by_kernel == pytest.approx({"k1": 300e-9, "k2": 200e-9, "k3": 50e-9})
    # gaps: [0,100) in step (decode_step opens at 50), [400,600) in decode_step,
    # [700,950) in client
    assert t.gaps == pytest.approx({"step": 100e-9, "decode_step": 200e-9, "client": 250e-9})
    assert t.spans["decode_step"] == pytest.approx([400e-9])


def test_no_device_time_is_all_idle():
    t = trace.reduce((0, 10), [], [])
    assert t.busy_s == 0 and t.gaps == {"outside": pytest.approx(10e-9)}
