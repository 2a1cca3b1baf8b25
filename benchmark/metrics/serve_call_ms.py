"""Host time of ContourDB.localize_block_async a request, outside the
profiled slice (ms)."""

from harness import readers


def read(run):
    return readers.host_ms(run, "serve", "call")
