"""Process start to the first timed scan or request (s)."""


def read(run):
    return run.setup_s
