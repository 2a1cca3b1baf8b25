"""The program's own stage marks and host spans in a traced run.

The port marks where each stage of a step or serving chunk begins with an
empty kernel, `cont2_mark_<stage>`, inside its CUDA graphs, and wraps its
host work in spans named `cont2.<name>` (its `tracing` module lists both).
A stage's device time in an item is the device's busy time (the union of
its operations' intervals) between the end of the stage's mark and the
start of the item's next mark, on the device's clock alone. The idle time
between the marks is left out: under the profiler the host takes ~10 ms
to launch a step's graph, the device waits on the launch inside the
replay, and the stage it waits in would read that wait, which an untraced
scan does not pay. An item's span time is the summed host time of its
spans of one name, and a run reads the median over its items: on a
shared host one item of eight now and then takes several times the
others' time (a late thread of a parallel host copy), which a mean
would carry.

Each reader returns None where the cell is of another kind, the run has no
trace, or the items lack the mark (or a mark after it) or any item lacks
the span: a program without marks or spans reads None.
"""

from __future__ import annotations

import re
import statistics
from collections import Counter

from harness.trace import intersect, length

MARK = re.compile(r"cont2_mark_([a-z0-9]+)")
SPAN_PREFIX = "cont2."


def marks(profile, window) -> list:
    """[(stage, start, end), ...] of the marks that started inside the
    (lo, hi) window, in the order the device ran them."""
    lo, hi = window
    out = []
    for name, s, e in profile.device_ops:
        m = lo <= s < hi and MARK.search(name)
        if m:
            out.append((m.group(1), s, e))
    return sorted(out, key=lambda x: x[1])


def stage_us(profile, window, item_marks, stage: str):
    """The device's busy time in `stage` over an item's window and marks
    (us), summed over the stage's occurrences (one a chunk); None where it
    has none, or where one has no mark after it."""
    lo, hi = window
    m = item_marks
    spans = [(m[k][2], m[k + 1][1] if k + 1 < len(m) else None)
             for k in range(len(m)) if m[k][0] == stage]
    if not spans or spans[-1][1] is None:
        return None
    ops = [(s, e) for n, s, e in profile.device_ops
           if s < hi and e > lo and not MARK.search(n)]
    return length(intersect(ops, spans))


def stage_ms(run, kind: str, stage: str):
    """The mean device time of `stage` a traced item (ms), over the items
    whose marks run in the order most items' do: the profiler may drop a
    record, and an item that lost a mark would read the missing stage into
    the one before it."""
    if run.kind != kind or run.window.profile is None:
        return None
    prof = run.window.profile
    items = [(w, marks(prof, w)) for w in run.item_windows()]
    if not items:
        return None
    order = [tuple(n for n, _, _ in m) for _, m in items]
    common = Counter(order).most_common(1)[0][0]
    per = [stage_us(prof, w, m, stage)
           for (w, m), o in zip(items, order) if o == common]
    if any(x is None for x in per):
        return None
    return sum(per) / len(per) / 1e3


def span_us(profile, window, name: str):
    """The summed host time of the spans `cont2.<name>` that started
    inside the window (us), or None where there is none."""
    lo, hi = window
    d = [e - s for n, s, e in profile.host_ops
         if n == SPAN_PREFIX + name and lo <= s < hi]
    return sum(d) if d else None


def span_ms(run, kind: str, name: str):
    """The median over the traced items of an item's host time in the
    spans `cont2.<name>` (ms)."""
    if run.kind != kind or run.window.profile is None:
        return None
    per = [span_us(run.window.profile, w, name)
           for w in run.item_windows()]
    if not per or any(x is None for x in per):
        return None
    return statistics.median(per) / 1e3
