"""Build slots replayed a served cloud in the traced requests: the sizes of
the program's `cont2.chunk.<size>` host spans (one around each chunk's
build and query replays), summed over the traced requests, over the clouds
those requests served. 1.0 where every request replays graphs of its own
size; more where a request is padded to a larger chunk. None where the
program opens no such span."""

import re

CHUNK = re.compile(r"cont2\.chunk\.(\d+)$")


def read(run):
    if run.kind != "serve" or run.window.profile is None:
        return None
    windows = run.item_windows()
    if not windows:
        return None
    host = run.window.profile.host_ops
    slots = 0
    for lo, hi in windows:
        sizes = [int(m.group(1)) for n, s, _ in host
                 if lo <= s < hi and (m := CHUNK.match(n))]
        if not sizes:
            return None
        slots += sum(sizes)
    clouds_per_request = run.window.clouds // run.window.items
    return slots / (len(windows) * clouds_per_request)
