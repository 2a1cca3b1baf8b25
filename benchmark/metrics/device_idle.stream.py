"""Share of the traced scans' service time in which no device operation ran
(%)."""

from harness import readers


def read(run):
    return readers.device_idle(run, "stream")
