"""What the metric readers (`metrics/<name>.py`) share. Each returns None
where its cell has nothing for it to read: a reader of the stream's
metrics in a serving cell, or a traced metric in a run without a trace."""

from __future__ import annotations

import math

from harness import roofline
from harness.trace import device_share


def mean(xs) -> float:
    xs = list(xs)
    return sum(xs) / len(xs)


def percentile(xs, q: float) -> float:
    """The nearest-rank q-quantile of all of xs."""
    s = sorted(xs)
    k = math.ceil(round(q * len(s), 9)) - 1
    return s[max(0, min(len(s) - 1, k))]


def latency_ms(run, kind: str, stat: str):
    if run.kind != kind:
        return None
    lat = [1e3 * x for x in run.latencies_s()]
    return mean(lat) if stat == "mean" else percentile(lat, 0.95)


def host_ms(run, kind: str, part: str):
    """Mean host time of the call into the program ("call") or of the
    wait for its results ("wait") over the window's items outside the
    profiled slice."""
    if run.kind != kind:
        return None
    w = run.window
    js = run.untraced()
    if part == "call":
        return mean(1e3 * (w.called[j] - w.start[j]) for j in js)
    return mean(1e3 * (w.done[j] - w.called[j]) for j in js)


def _traced(run, kind: str):
    if run.kind != kind or run.window.profile is None:
        return None
    spans = run.item_windows()
    return (run.window.profile, spans) if spans else None


def launches(run, kind: str):
    t = _traced(run, kind)
    if t is None:
        return None
    prof, spans = t
    return prof.device_count(spans) / len(spans)


def device_busy_ms(run, kind: str):
    t = _traced(run, kind)
    if t is None:
        return None
    prof, spans = t
    busy, _ = device_share(prof.device_intervals(), spans)
    return busy / 1e3 / len(spans)


def device_idle(run, kind: str):
    """The share of in-service time in which the device ran nothing (%):
    the device's busy time an item in the traced slice, against the mean
    service time (call to results on the host) of the items outside it.
    The profiler lengthens the host's side of a traced item (each graph
    launch is instrumented), so the traced items' own spans would read
    the idle share high."""
    t = _traced(run, kind)
    if t is None:
        return None
    prof, spans = t
    busy, _ = device_share(prof.device_intervals(), spans)
    w = run.window
    service_us = 1e6 * mean(w.done[j] - w.start[j] for j in run.untraced())
    return 100.0 * (1.0 - busy / len(spans) / service_us)


def kernel_roofline(run, kind: str):
    """The least time of the kernels' logical work in the traced slice
    (the reference's record of each call) over the device time of the
    port's own kernels there, in %."""
    t = _traced(run, kind)
    if t is None or not run.kernel_calls:
        return None
    prof, spans = t
    dev_us = prof.kernel_us(roofline.PORT_KERNELS, spans)
    if dev_us <= 0:
        return None
    least = sum(roofline.least_us(k, info) for k, info in run.kernel_calls)
    return 100.0 * least / dev_us
