"""Device time of the LM refinement a traced request: the device's busy time
between the program's `lm` mark and its next mark (ms)."""

from harness import stages


def read(run):
    return stages.stage_ms(run, "serve", "lm")
