"""Host time of QueryHandle.record a scan, outside the profiled slice (ms)."""

from harness import readers


def read(run):
    return readers.host_ms(run, "stream", "wait")
