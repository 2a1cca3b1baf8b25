"""Device operations the profiler records a request in the traced slice."""

from harness import readers


def read(run):
    return readers.launches(run, "serve")
