"""Host time of ContourDB.step_async a scan, outside the profiled slice
(ms)."""

from harness import readers


def read(run):
    return readers.host_ms(run, "stream", "call")
