"""The port's kernels' least time over their device time in the traced
requests (%)."""

from harness import readers


def read(run):
    return readers.kernel_roofline(run, "serve")
