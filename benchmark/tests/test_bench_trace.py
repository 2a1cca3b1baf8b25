"""Interval unions, idle and busy shares on a hand-made trace, and
percentiles over all requests."""

import types

import pytest

from harness import readers
from harness.drive import Window
from harness.trace import (Profile, device_share, gaps, intersect,
                           label_gaps, length, union)


def test_union_not_sum():
    # a copy and a kernel overlapping on two streams: 30 us busy, not 40
    iv = [(0, 20), (10, 30), (50, 60)]
    assert union(iv) == [(0, 30), (50, 60)]
    assert length(iv) == 40
    assert length([(0, 20), (10, 30)]) == 30
    assert intersect([(0, 30), (50, 60)], [(25, 55)]) == [(25, 30), (50, 55)]
    assert gaps([(10, 20), (30, 40)], [(0, 50)]) == [(0, 10), (20, 30),
                                                      (40, 50)]


def _profile():
    # two requests in service [0, 100) and [200, 300); device work inside
    # them, overlapping, plus a host span's shadow on the device timeline
    # and work outside service (the sensor's gap)
    dev = [("k1", 10, 40), ("copy", 30, 50), ("k2", 210, 260),
           ("bench.scan", 0, 100), ("k3", 150, 160)]
    host = [("bench.scan", 0, 100), ("bench.scan", 200, 300),
            ("cudaGraphLaunch", 0, 12), ("aten::copy_", 50, 100),
            ("aten::copy_", 260, 300)]
    return Profile(dev, host)


def test_device_busy_and_idle_in_service():
    p = _profile()
    p = Profile([d for d in p.device_ops if not d[0].startswith("bench.")],
                p.host_ops)
    spans = p.spans("bench.scan")
    busy, service = device_share(p.device_intervals(), spans)
    assert (busy, service) == (40 + 50, 200)
    assert p.device_count(spans) == 3
    assert p.kernel_us(("k1", "k2"), spans) == 30 + 50
    b = p.breakdown(spans)
    assert b["device_ops"][0] == ["k2", 50e-6]
    # the gaps: [0,10) under the graph launch, [50,100) and [260,300)
    # under the copies, [200,210) under the span alone
    assert dict(map(tuple, b["idle_gaps"])) == pytest.approx({
        "aten::copy_": 90e-6, "cudaGraphLaunch": 10e-6,
        "bench.scan": 10e-6})


def test_profile_of_drops_host_span_shadows():
    class E:
        def __init__(self, name, dev, s, e, ann=False):
            import torch
            self.name = name
            self.device_type = (torch.autograd.DeviceType.CUDA if dev
                                else torch.autograd.DeviceType.CPU)
            self.time_range = types.SimpleNamespace(start=s, end=e)
            self.is_user_annotation = ann

    prof = types.SimpleNamespace(events=lambda: [
        E("bench.scan", True, 0, 100), E("k", True, 10, 20),
        E("mine", True, 0, 50, ann=True), E("bench.scan", False, 0, 100)])
    p = Profile.of(prof)
    assert [d[0] for d in p.device_ops] == ["k"]
    assert p.spans("bench.scan") == [(0, 100)]


def test_label_gaps_takes_the_innermost_span():
    out = label_gaps([(20, 30)], [("outer", 0, 100), ("inner", 10, 40)])
    assert out == [["inner", 10e-6]]


def test_percentiles_over_all_requests():
    assert readers.percentile(range(1, 301), 0.95) == 285
    assert readers.percentile(range(1, 101), 0.95) == 95
    assert readers.percentile([3.0], 0.95) == 3.0
    w = Window()
    # 20 scans: 19 at 10 ms, one stall of 200 ms that delays the next too
    w.due = [0.1 * j for j in range(20)]
    lat = [0.010] * 20
    lat[5], lat[6] = 0.200, 0.110
    w.done = [d + x for d, x in zip(w.due, lat)]
    w.start = w.called = w.due
    w.items, w.slice = 20, (20, 20)
    run = types.SimpleNamespace(kind="stream", window=w,
                                latencies_s=lambda: [
                                    d - s for d, s in zip(w.done, w.due)])
    assert readers.latency_ms(run, "stream", "mean") == pytest.approx(
        (18 * 10 + 200 + 110) / 20)
    assert readers.latency_ms(run, "stream", "p95") == pytest.approx(110)
    assert readers.latency_ms(run, "serve", "mean") is None


def test_idle_share_against_untraced_service():
    p = Profile([("k", 10, 40), ("k", 210, 250)],
                [("bench.scan", 0, 100), ("bench.scan", 200, 300)])
    w = Window()
    # items 0-1 untraced, 50 us in service each; items 2-3 traced
    w.start = [0.0, 1.0, 2.0, 3.0]
    w.done = [50e-6, 1.0 + 50e-6, 2.0001, 3.0001]
    w.items, w.slice, w.profile = 4, (2, 4), p
    run = types.SimpleNamespace(
        kind="stream", window=w, untraced=lambda: [0, 1],
        item_windows=lambda: p.item_windows())
    # windows [0, 150) and [150, 300): 35 us busy a traced scan against
    # 50 us of untraced service, 30%
    assert readers.device_idle(run, "stream") == pytest.approx(30.0)
    assert readers.device_busy_ms(run, "stream") == pytest.approx(0.035)
    assert readers.launches(run, "stream") == 1.0


def test_item_windows_split_the_gaps_between_items():
    # a margin item before and after the two traced ones; the device's
    # first operation of the second item lands before its host span
    p = Profile([("k", 195, 210)],
                [("bench.margin", -200, -100), ("bench.scan", 0, 100),
                 ("bench.scan", 200, 300), ("bench.margin", 400, 500)])
    assert p.item_windows() == [(-50.0, 150.0), (150.0, 350.0)]
    assert p.device_count(p.item_windows()) == 1
    assert p.device_count(p.spans("bench.scan")) == 0
