"""Union of the device's operation intervals a traced scan (ms)."""

from harness import readers


def read(run):
    return readers.device_busy_ms(run, "stream")
