"""Device time of the tidy screens and the GMM init correlation a traced scan:
the device's busy time between the program's `init` mark and its next mark
(ms)."""

from harness import stages


def read(run):
    return stages.stage_ms(run, "stream", "init")
