"""Device time of the key search a traced request: the device's busy time
between the program's `search` mark and its next mark (ms)."""

from harness import stages


def read(run):
    return stages.stage_ms(run, "serve", "search")
