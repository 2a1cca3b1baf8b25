"""Host time in the program's `cont2.upload` spans (the clouds' pin and
host-to-device enqueue) a traced request, the median over the traced
requests (ms)."""

from harness import stages


def read(run):
    return stages.span_ms(run, "serve", "upload")
