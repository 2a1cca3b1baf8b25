"""CUDA graphs of the port's eager code: a step, a block, a serving chunk or
one stage of the unfused API as one replay.

The JAX package runs each of its entry points as one dispatch of a jitted
program (`db._scan_step`, `_step_chain_dyn`, `_process_block`,
`_localize_block`, `build_descriptor`, `_query_step`, `_append`,
`_update_window`), every data-dependent loop inside it a `lax.while_loop`
or `lax.scan` on the device. The port's counterpart: the same bodies, free
of host syncs (the CC labels, the proposal merge and the two dynamic
threshold scans are kernels, the cascade runs every chunk), captured once
from the eager torch code into a CUDA graph and then replayed. A replay
runs no Python wrapper, so each graph keeps the kernel launches its capture
recorded and adds them to the wrappers' counts at every replay
(`kernels.add_launches`).

Memory: one graph pool a device, shared by every DB of the process
(`DevicePool`, from `device_pool(device)`). No graph keeps an output in the
pool: every input and output of a graph is a static tensor its DB holds
outside it, so the pool is scratch for all of them. Scratch shared by
graphs is safe only while no two of their replays overlap on the device,
so every replay of a device runs on that device's one replay stream: it
waits for the caller's current stream, replays, and the caller's stream
waits for it. Replays from any thread or stream (the online spinner steps
its DB from its own thread while the main thread replays another DB's
graphs) thus run one after another on the card. Captures run on the
device's one capture stream, one at a time (a lock). The pool's memory
goes back to the card when the last graph that uses it is gone (and the
allocator's cache is emptied); the next capture then opens a new pool.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Callable, Hashable, Optional

import torch

from contour_context_tpu_torch.ops import kernels
from contour_context_tpu_torch.tracing import span


class Graph:
    """One CUDA graph captured from `body` (no arguments; device work only:
    every tensor it reads or writes outlives the graph), on `stream` and
    the memory `pool`, with the launches of each kernel a replay makes."""

    __slots__ = ("graph", "launches", "capture_s", "__weakref__")

    def __init__(self, body: Callable[[], None], pool, stream) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the online spinner captures from its own thread
        # while other threads run eager work and replays
        with kernels.recording_launches() as rec, \
                torch.cuda.graph(graph, pool=pool, stream=stream,
                                 capture_error_mode="thread_local"):
            body()
        self.capture_s = time.perf_counter() - t0
        self.launches = {k: rec.get(k, 0) for k in kernels.launch_counts()}
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)


class DevicePool:
    """The graph pool, capture stream and replay stream of one device,
    shared by every GraphSet on it. `live` holds the graphs captured into
    the current pool; when none is left the pool handle is dropped, so the
    next capture opens a new pool (a pool whose last graph is gone cannot
    take a capture again)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.live: "weakref.WeakSet[Graph]" = weakref.WeakSet()
        self.handle = None
        self.capture_stream: Optional[torch.cuda.Stream] = None
        self.replay_stream: Optional[torch.cuda.Stream] = None
        self.lock = threading.Lock()

    def capture(self, body: Callable[[], None]) -> Graph:
        """body() run eagerly on the capture stream (the warm-up, whose work
        is this call's own: lazy builds, cached constants, library
        workspaces), then captured into the device's pool, one capture at
        a time."""
        with self.lock:
            # the pool's graphs, held through the capture: a pool whose
            # last graph went mid-capture could not take this one
            held = list(self.live)
            if not held:
                self.handle = self._new_pool()
            graph = self._capture(body)
            self.live.add(graph)
            del held
            return graph

    def _new_pool(self):
        return torch.cuda.graph_pool_handle()

    def _capture(self, body: Callable[[], None]) -> Graph:
        if self.capture_stream is None:
            self.capture_stream = torch.cuda.Stream(self.device)
        s = self.capture_stream
        cur = torch.cuda.current_stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            body()
        cur.wait_stream(s)
        return Graph(body, self.handle, s)

    def replay(self, graph: Graph) -> None:
        """One replay on the device's replay stream, ordered after the
        caller's current stream and before its later work."""
        if self.replay_stream is None:
            with self.lock:
                if self.replay_stream is None:
                    self.replay_stream = torch.cuda.Stream(self.device)
        s = self.replay_stream
        cur = torch.cuda.current_stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            graph.replay()
        cur.wait_stream(s)

    def pool_bytes(self) -> int:
        """Bytes of device memory the pool holds (its segments): every graph
        of every DB on the device shares them."""
        if self.handle is None or not len(self.live) \
                or self.device.type != "cuda":
            return 0
        pool = tuple(self.handle)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)


_POOLS: dict = {}
_POOLS_LOCK = threading.Lock()


def device_pool(device) -> DevicePool:
    """The process's one DevicePool of `device`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _POOLS_LOCK:
        pool = _POOLS.get(device)
        if pool is None:
            pool = _POOLS[device] = DevicePool(device)
        return pool


def tensor_tag(*xs) -> tuple:
    """What a graph bakes in of the tensors it reads or writes: each one's
    address, shape, strides and dtype. A graph whose tag equals a call's
    reads and writes exactly the memory that call's eager body would."""
    return tuple((x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)
                 for x in xs)


class GraphSet:
    """A holder's graphs (a DB's, a mesh's), keyed by what they run, each
    with the tag it was captured under (`tensor_tag` of the holder's
    tensors it reads, and any number the capture bakes in; None for a
    graph that reads only its static buffers, such as a build); the static
    tensors they read their inputs from and write their outputs to
    (`static`); and the switch between replays and the eager bodies
    (`enabled`, `eager()`). A run whose tag differs from its graph's drops
    that graph and captures it again. The pool and the streams are the
    device's (`device_pool`). `reason` says why a set is not graphed: the
    device type off a card, or the holder's own ("gloo")."""

    def __init__(self, device: torch.device,
                 reason: Optional[str] = None) -> None:
        self.device = device
        self.reason = reason or (None if device.type == "cuda"
                                 else device.type)
        self.enabled = self.reason is None
        self.graphs: dict = {}
        self.capture_s: dict = {}
        self.bufs: dict = {}
        self._tags: dict = {}
        self._pool: Optional[DevicePool] = None

    @property
    def pool(self) -> DevicePool:
        if self._pool is None:
            self._pool = device_pool(self.device)
        return self._pool

    def static(self, key, shape, dtype) -> torch.Tensor:
        """The static tensor under `key`, kept for the set's lifetime: a
        graph's input or output buffer (the graph reads and writes it at
        its capture address)."""
        t = self.bufs.get(key)
        if t is None:
            t = self.bufs[key] = torch.zeros(shape, dtype=dtype,
                                             device=self.device)
        return t

    @contextlib.contextmanager
    def eager(self):
        """Inside the block the holder runs its eager bodies (the card's
        comparisons of a replay with the body it captured)."""
        prev, self.enabled = self.enabled, False
        try:
            yield self
        finally:
            self.enabled = prev

    def drop(self) -> None:
        """Drop this set's graphs (another holder's stay)."""
        self.graphs.clear()
        self.capture_s.clear()
        self._tags.clear()

    def run(self, key: Hashable, body: Callable[[], None], tag=None,
            owner: Optional[torch.Tensor] = None) -> None:
        """body() as one replay of its graph. The first call of a key (or
        the first under a new tag) runs body eagerly and captures it; a
        failed capture raises. A graph captured with an `owner` (a tensor
        it reads) is dropped when the owner is freed: it lives as long as
        what it reads."""
        graph = self.graphs.get(key)
        if graph is not None and self._tags[key] == tag:
            with span("replay"):
                self.pool.replay(graph)
            return
        self.graphs.pop(key, None)
        with span("capture"):
            graph = self.pool.capture(body)
        self.graphs[key] = graph
        self._tags[key] = tag
        self.capture_s[key] = graph.capture_s
        if owner is not None:
            weakref.finalize(owner, self._forget, key, weakref.ref(graph))

    def _forget(self, key: Hashable, graph: "weakref.ref[Graph]") -> None:
        if key in self.graphs and self.graphs[key] is graph():
            del self.graphs[key], self._tags[key], self.capture_s[key]

    def launches(self, key: Hashable) -> dict:
        """The kernel launches one replay of the graph under `key` makes."""
        return dict(self.graphs[key].launches)

    def pool_bytes(self) -> int:
        """Bytes the device's shared pool holds (every holder's graphs)."""
        return self.pool.pool_bytes()

    def stats(self, name: Callable[[Hashable], str] = str) -> dict:
        """Whether the set is graphed (and if not, why), the capture
        seconds of each graph and the launches of each kernel one replay
        makes, under `name` of its key (#2.. for a name met again), and
        the bytes of the device's shared pool."""
        names, seen = {}, {}
        for k in self.graphs:
            n = name(k)
            seen[n] = seen.get(n, 0) + 1
            names[k] = n if seen[n] == 1 else f"{n}#{seen[n]}"
        return {"graphed": self.enabled, "reason": self.reason,
                "capture_s": {names[k]: v
                              for k, v in self.capture_s.items()},
                "launches": {names[k]: self.launches(k)
                             for k in self.graphs},
                "pool_bytes": self.pool_bytes(),
                "pool": "the device's, shared by every DB and mesh of the "
                        "process"}
