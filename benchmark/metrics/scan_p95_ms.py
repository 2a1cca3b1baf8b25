"""95th percentile of all window scans' latencies (ms)."""

from harness import readers


def read(run):
    return readers.latency_ms(run, "stream", "p95")
