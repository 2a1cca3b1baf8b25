"""Device time of the hint cap and the check-1 prefilter a traced scan: the
device's busy time between the program's `check1` mark and its next mark
(ms)."""

from harness import stages


def read(run):
    return stages.stage_ms(run, "stream", "check1")
