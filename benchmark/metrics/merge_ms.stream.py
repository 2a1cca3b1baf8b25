"""Device time of the proposal merge a traced scan: the device's busy time
between the program's `merge` mark and its next mark (ms)."""

from harness import stages


def read(run):
    return stages.stage_ms(run, "stream", "merge")
