"""Union of the device's operation intervals a traced request (ms)."""

from harness import readers


def read(run):
    return readers.device_busy_ms(run, "serve")
