"""Host time in the program's `cont2.upload` spans (a cloud's pin and
host-to-device enqueue) a traced scan, the median over the traced
scans (ms)."""

from harness import stages


def read(run):
    return stages.span_ms(run, "stream", "upload")
