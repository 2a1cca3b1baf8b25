"""Mean latency of all window scans, due time to record on the host (ms)."""

from harness import readers


def read(run):
    return readers.latency_ms(run, "stream", "mean")
