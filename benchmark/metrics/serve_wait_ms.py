"""Host time of BlockHandle.get a request, outside the profiled slice (ms)."""

from harness import readers


def read(run):
    return readers.host_ms(run, "serve", "wait")
