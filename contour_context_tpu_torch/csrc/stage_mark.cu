// Stage marks: one named, empty kernel of one thread a stage of the port's
// step and serving chunk (`tracing.py` lists the stages and where each
// begins). A mark launched on the current stream while a CUDA graph is
// captured becomes a node of the graph, so every replay carries the
// boundaries of its stages on the device's timeline, under these names, for
// a profiler to read. A mark does no work; its cost is one graph node.
//
// The names hold no name of a kernel that computes (ring_key_divs_kernel,
// search_tilemin_kernel, ...), so a trace reader that picks the port's
// kernels out by name never takes a mark for one.

#include <cuda_runtime.h>

#define CONT2_MARK(stage) \
  extern "C" __global__ void cont2_mark_##stage() {}

CONT2_MARK(desc)
CONT2_MARK(search)
CONT2_MARK(check1)
CONT2_MARK(cascade)
CONT2_MARK(merge)
CONT2_MARK(init)
CONT2_MARK(lm)
CONT2_MARK(tail)
CONT2_MARK(end)

// Launches mark `stage` (its index in tracing.STAGES) on `stream`; returns
// 0 or the CUDA error.
extern "C" int cc_stage_mark(int stage, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: cont2_mark_desc<<<1, 1, 0, s>>>(); break;
    case 1: cont2_mark_search<<<1, 1, 0, s>>>(); break;
    case 2: cont2_mark_check1<<<1, 1, 0, s>>>(); break;
    case 3: cont2_mark_cascade<<<1, 1, 0, s>>>(); break;
    case 4: cont2_mark_merge<<<1, 1, 0, s>>>(); break;
    case 5: cont2_mark_init<<<1, 1, 0, s>>>(); break;
    case 6: cont2_mark_lm<<<1, 1, 0, s>>>(); break;
    case 7: cont2_mark_tail<<<1, 1, 0, s>>>(); break;
    case 8: cont2_mark_end<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
