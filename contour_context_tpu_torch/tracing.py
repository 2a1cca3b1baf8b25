"""The port's tracing, for a `torch.profiler` trace: stage marks on the
device inside the CUDA graph replays, and host spans on the profiler's
clock. Without a profiler both cost next to nothing.

**Stage marks.** `mark(stage, device)` on a CUDA device launches
`cont2_mark_<stage>`, an empty one-thread kernel of `csrc/stage_mark.cu`,
on the current stream. A capture records it as a graph node, so every
replay carries the boundaries of its stages on the device's timeline,
captured once in the graph whether or not a profiler runs: a stage's
device time runs from the end of its mark to the start of the next mark.
Marks are not the port's kernels: `kernels.add_launches` does not count
them. On the CPU a mark is a zero-length host span `cont2.mark.<stage>`
while a profiler records, and nothing otherwise.

The marks, where each is launched, and the stage it begins:

- `desc`: `ops/descriptor.build_descriptors`; the descriptor build.
- `search`: `db.query_step` / `db.query_step_batch`; the key search.
- `check1`: `db.cascade_rows`; the hint cap and the check-1 prefilter.
- `cascade`: `db.stages_from_hits`, before `cascade_chunked`; the cascade
  (on a CUDA device one `cascade` kernel over every hint row) and the
  dynamic pass scan.
- `merge`: `db.stages_from_hits`, before `merge_proposals`; the merge.
- `init`: `db.refine_from_hits`, after `stages_from_hits`; the tidy
  screens, the GMM init correlation, the best F candidates.
- `lm`: `db.query_from_hits`, before `optimize_correlation`; the LM
  refinement (on a CUDA device one `gmm_lm` kernel and the wrapper's
  copies) and the record's packing.
- `tail`: the step's and the serving query's graph bodies, after the
  record; the ring write, append and window update (step), the copy into
  the static record buffer (serving).
- `end`: the end of the step's, the serving build's and the serving
  query's graph bodies.

A stream step carries the nine in this order; a serving chunk `desc, end`
in its build replay and `search` to `end` in its query replay.

**Host spans.** `span(name)` is `torch.profiler.record_function(
"cont2.<name>")` while a profiler records, and otherwise one shared null
context: an unguarded `record_function` costs 8-15 us to enter with no
profiler, a span ~0.4 us.

The spans, where each is opened, and what it holds. `upload` is timed by
the benchmark; the others name the program's host work in a trace (the
CLI's `--trace-dir`, or the benchmark's names of the device's idle gaps):

- `step`: `db.ContourDB.step_async`; one scan's call.
- `upload`: `db.upload`; a host payload's pin and host-to-device enqueue.
- `stage_in`: `step_async`, `process_block_async`, `_build_batch`,
  `_query_batch`; the copies into a graph's static buffers.
- `capture`: `graphs.GraphSet.run`; a graph's eager warm-up and capture.
- `replay`: `graphs.GraphSet.run`; one graph launch on the device's
  replay stream.
- `record`: `db.drain_handles`; QueryHandles' records to the host.
- `fetch`, `unpack`: `db.drain_handles` (in `record`) and
  `db.drain_block_handles`; the copy to the host, its wait included;
  unpacking and the counters.
- `stage_out`: `db.ContourDB.localize_block_async`; a chunk's records
  cloned out of the static buffer, and their concatenation.
- `chunk.<size>`: `db.ContourDB.localize_block_async`; one chunk of a
  request (`db.serve_chunks`), its upload, build and query replays and
  `stage_out`; `<size>` is the chunk's build slots, zero clouds of a
  padded tail included. The benchmark reads `slots_per_cloud.serve` from
  it; `serving_counters["build_slots"]` counts the same slots untraced.
"""

from __future__ import annotations

import contextlib

import torch

from contour_context_tpu_torch.ops import kernels

STAGES = ("desc", "search", "check1", "cascade", "merge", "init", "lm",
          "tail", "end")
SPANS = ("step", "upload", "stage_in", "capture", "replay", "record",
         "fetch", "unpack", "stage_out", "chunk")
_STAGE_ID = {s: i for i, s in enumerate(STAGES)}
_SPANS = frozenset(SPANS)
_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """The host span `cont2.<name>` (one of SPANS, `chunk` as
    `chunk.<size>`) while a profiler records; the shared null context
    otherwise."""
    if not _recording():
        return _NULL
    head, _, size = name.partition(".")
    if not (size.isdigit() if head == "chunk" else name in _SPANS):
        raise ValueError(f"span {name!r}: not one of {SPANS} (chunk as "
                         f"chunk.<size>)")
    return torch.profiler.record_function("cont2." + name)


def mark(stage: str, device: torch.device) -> None:
    """Mark the start of `stage` (one of STAGES) on `device`'s current
    stream (a CUDA device), or as a host span while a profiler records
    (the CPU)."""
    i = _STAGE_ID[stage]
    if device.type == "cuda":
        _launch(i, device)
    elif _recording():
        with torch.profiler.record_function("cont2.mark." + stage):
            pass


def _launch(i: int, device: torch.device) -> None:
    """Mark STAGES[i]'s kernel on `device`'s current stream."""
    rc = kernels.build().cc_stage_mark(i, kernels._stream(device))
    kernels._raise_on(rc, "cont2_mark_" + STAGES[i])
