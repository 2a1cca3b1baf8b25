"""Device time of the chunked check cascade a traced scan: the device's busy
time between the program's `cascade` mark and its next mark (ms)."""

from harness import stages


def read(run):
    return stages.stage_ms(run, "stream", "cascade")
