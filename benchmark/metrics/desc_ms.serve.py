"""Device time of the descriptor build a traced request: the device's busy time
between the program's `desc` mark and its next mark (ms)."""

from harness import stages


def read(run):
    return stages.stage_ms(run, "serve", "desc")
