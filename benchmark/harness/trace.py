"""Reading a torch.profiler window: device intervals, their union, the
in-service share, and what the host did in the device's gaps.

Intervals are (start, end) pairs in microseconds on the profiler's clock,
which the host spans (`torch.profiler.record_function`) and the device
records share. Busy time is the length of the union of the device
intervals, never their summed durations: copies and kernels of two
streams overlap.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

SPAN_PREFIX = "bench."     # the harness's own host spans
ITEM = "bench.scan"        # a traced scan or request, call to results
MARGIN = "bench.margin"    # an item just outside the traced slice


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def intersect(a, b) -> list:
    """The intersection of two unions (each sorted and disjoint)."""
    a, b = union(a), union(b)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def inside(t: float, w) -> bool:
    """Whether t lies in one of the sorted disjoint intervals w."""
    i = bisect.bisect_right(w, (t, float("inf"))) - 1
    return i >= 0 and w[i][0] <= t < w[i][1]


def gaps(busy, within) -> list:
    """The parts of `within` that `busy` leaves uncovered."""
    return intersect(complement(busy), within)


def complement(intervals) -> list:
    """The gaps between and around a union, out to +-inf."""
    out, t = [], float("-inf")
    for s, e in union(intervals):
        out.append((t, s))
        t = e
    out.append((t, float("inf")))
    return out


def device_share(device, service) -> tuple:
    """(busy us inside the service spans, service us): the device's busy
    time where a request was in service, and the length of service."""
    svc = union(service)
    return length(intersect(device, svc)), length(svc)


def top_by_name(items, n: int = 10) -> list:
    """[[name, seconds], ...] of (name, us) items summed by name, the
    largest n first."""
    acc = defaultdict(float)
    for name, us in items:
        acc[name] += us
    return [[k, v / 1e6] for k, v in
            sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def label_gaps(gap_list, host_spans, n: int = 10) -> list:
    """Each gap named by the innermost host span that covers its middle
    ('idle' where none does), summed by name: [[name, seconds], ...]."""
    spans = sorted(host_spans, key=lambda x: x[1])
    items, active, k = [], [], 0
    for s, e in sorted(gap_list):
        mid = 0.5 * (s + e)
        while k < len(spans) and spans[k][1] <= mid:
            active.append(spans[k])
            k += 1
        active = [x for x in active if x[2] >= mid]
        best = min(active, key=lambda x: x[2] - x[1], default=None)
        items.append((best[0] if best else "idle", e - s))
    return top_by_name(items, n)


class Profile:
    """What a torch.profiler window recorded: device operations (name,
    start, end), host operations and spans (name, start, end)."""

    def __init__(self, device_ops, host_ops):
        self.device_ops = list(device_ops)
        self.host_ops = list(host_ops)

    @classmethod
    def of(cls, prof) -> "Profile":
        import torch
        dev, host = [], []
        for e in prof.events():
            tr = e.time_range
            item = (e.name, float(tr.start), float(tr.end))
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append(item)
            elif not (getattr(e, "is_user_annotation", False)
                      or e.name.startswith(SPAN_PREFIX)):
                # a host span's shadow on the device timeline is no work
                dev.append(item)
        return cls(dev, host)

    def spans(self, name: str) -> list:
        """(start, end) of every host span called `name`."""
        return sorted((s, e) for n, s, e in self.host_ops if n == name)

    def item_windows(self, name: str = ITEM, bound: str = MARGIN) -> list:
        """One window a traced item: from the middle of the gap before its
        span to the middle of the gap after it, the neighbours being the
        other items and the untraced items just outside the slice (spans
        `bound`). The device's clock, mapped onto the host's, can put an
        item's first operations before its host span starts; between two
        items the device runs nothing of either."""
        items = self.spans(name)
        every = sorted(items + self.spans(bound))
        out = []
        for s, e in items:
            k = every.index((s, e))
            lo = 0.5 * (every[k - 1][1] + s) if k > 0 else s
            hi = 0.5 * (e + every[k + 1][0]) if k + 1 < len(every) else e
            out.append((lo, hi))
        return out

    def device_intervals(self, within=None) -> list:
        iv = [(s, e) for _, s, e in self.device_ops]
        return iv if within is None else intersect(iv, within)

    def device_count(self, within) -> int:
        """Device operations that started inside the spans `within`."""
        w = union(within)
        return sum(inside(st, w) for _, st, _ in self.device_ops)

    def kernel_us(self, names, within) -> float:
        """Summed device time of the operations whose name holds one of
        `names`, started inside `within`."""
        w = union(within)
        return sum(en - st for n, st, en in self.device_ops
                   if any(k in n for k in names) and inside(st, w))

    def breakdown(self, within) -> dict:
        w = union(within)
        ops = [(n, en - st) for n, st, en in self.device_ops
               if inside(st, w)]
        g = gaps(self.device_intervals(), w)
        return {"device_ops": top_by_name(ops),
                "idle_gaps": label_gaps(g, self.host_ops)}
