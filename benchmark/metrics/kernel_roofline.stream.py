"""The port's kernels' least time over their device time in the traced
scans (%)."""

from harness import readers


def read(run):
    return readers.kernel_roofline(run, "stream")
