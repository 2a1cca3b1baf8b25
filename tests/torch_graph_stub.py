"""A stand-in for the device's CUDA graph pool, so that the port's graphed
code paths run on the CPU. Torch and the port only (no jax): the spawned
ranks of test_torch_parallel.py import it too."""

import contextlib
import itertools

from contour_context_tpu_torch import graphs


class FakeGraph:
    """A capture runs the body once (the warm-up's work, which the real
    capture leaves as the call's own); a replay runs it again."""

    def __init__(self, body):
        self.body = body
        self.launches = {}
        self.capture_s = 0.0
        body()

    def replay(self):
        self.body()


@contextlib.contextmanager
def fake_pool():
    """Inside the block every DevicePool captures FakeGraphs and replays
    them, in a pool registry of its own; yields a list that gains one
    item a capture. Everything is put back after the block."""
    handles, captures = itertools.count(), []
    saved = graphs._POOLS, {k: graphs.DevicePool.__dict__[k]
                            for k in ("_new_pool", "_capture", "replay")}

    def capture(self, body):
        captures.append(1)
        return FakeGraph(body)

    graphs._POOLS = {}
    graphs.DevicePool._new_pool = lambda self: (next(handles),)
    graphs.DevicePool._capture = capture
    graphs.DevicePool.replay = lambda self, graph: graph.replay()
    try:
        yield captures
    finally:
        graphs._POOLS = saved[0]
        for k, v in saved[1].items():
            setattr(graphs.DevicePool, k, v)
