"""Device operations the profiler records a scan in the traced slice."""

from harness import readers


def read(run):
    return readers.launches(run, "stream")
