"""95th percentile of all window requests' latencies, call to records on
the host (ms)."""

from harness import readers


def read(run):
    return readers.latency_ms(run, "serve", "p95")
