"""CUDA graphs of the port's eager code: a step, a block or a serving chunk
as one replay.

The JAX package runs each of its entry points as one dispatch of a jitted
program (`db._scan_step`, `_step_chain_dyn`, `_process_block`,
`_localize_block`), every data-dependent loop inside it a `lax.while_loop`
on the device. The port's counterpart: the same bodies, free of host syncs
(the CC labels and the proposal merge are kernels, the cascade runs every
chunk), captured once from the eager torch code into a CUDA graph and then
replayed. A replay runs no Python wrapper, so each graph keeps the kernel
launches its capture recorded and adds them to the wrappers' counts at
every replay (`kernels.add_launches`).
"""

from __future__ import annotations

import time
from typing import Callable, Hashable, Optional

import torch

from contour_context_tpu_torch.ops import kernels


class Graph:
    """One CUDA graph captured from `body` (no arguments; device work only:
    every tensor it reads or writes outlives the graph), on `stream` and
    the memory `pool`, with the launches of each kernel a replay makes."""

    __slots__ = ("graph", "launches", "capture_s")

    def __init__(self, body: Callable[[], None], pool, stream) -> None:
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the online spinner steps its DB from its own thread
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            body()
        self.capture_s = time.perf_counter() - t0
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        # the capture recorded those launches and ran none of them
        kernels.add_launches({k: -n for k, n in self.launches.items()})
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)


class GraphSet:
    """A DB's graphs, keyed by what they run, sharing one memory pool and
    one capture stream. They replay in order on the caller's stream, and no
    graph keeps an output in the pool (each writes into tensors allocated
    outside it), so the pool is scratch for all of them. `tag` names the
    tensors the graphs read (their addresses): when it changes (a grow, a
    load) every graph is dropped and captured again at its next use."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.graphs: dict = {}
        self.capture_s: dict = {}
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.tag = None

    def drop(self) -> None:
        self.graphs.clear()
        self.capture_s.clear()
        self.pool = None

    def run(self, key: Hashable, body: Callable[[], None], tag) -> None:
        """body() as one replay of its graph. The first call of a key runs
        body eagerly on the capture stream (the warm-up, whose work is this
        call's own: lazy builds, cached constants, library workspaces), then
        captures it; a failed capture raises."""
        if tag != self.tag:
            self.drop()
            self.tag = tag
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            body()
        cur.wait_stream(self.stream)
        graph = Graph(body, self.pool, self.stream)
        self.graphs[key] = graph
        self.capture_s[key] = graph.capture_s

    def launches(self, key: Hashable) -> dict:
        """The kernel launches one replay of the graph under `key` makes."""
        return dict(self.graphs[key].launches)

    def pool_bytes(self) -> int:
        """Bytes of device memory the graphs' pool holds (its segments)."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)
