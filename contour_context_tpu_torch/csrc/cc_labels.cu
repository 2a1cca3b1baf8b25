// 8-connected component labels of N binary masks, to their fixpoint in one
// launch.
//
// Replaces: contour_context_tpu/ops/descriptor.py, cc_labels (the
// lax.while_loop that propagates labels to their fixpoint, :280). There is
// no Pallas kernel behind it; the JAX package runs the loop on the device
// with no host round trip, and the port's plain version
// (ops/kernels.cc_labels_plain) checks its fixpoint on the host once a
// propagate. This kernel takes that check off the host.
//
//   labels[i, p] = min { q : q in the 8-connected component of pixel p of
//                        mask i }   for a foreground p,
//   labels[i, p] = S = nr * nc      for a background p.
//
// The answer is unique, so any correct algorithm is bit-equal to the plain
// version and to the JAX function.
//
// What bounds it on the card: it must read each mask byte once and write
// each int32 label once: 5 bytes a pixel, 10.8 MB for the 96 masks of a
// block of 16 scans (6 levels, 150 x 150), a bound of ~3.2 us by bytes; a
// scan's 6 masks are 0.68 MB (0.2 us), far under a launch's own cost. The
// work is a union-find whose depth follows the components' shapes, so the
// scan's real floor is latency: one CTA a mask, four barrier-separated
// phases.
//
// Design. One CTA of kThreads threads a mask, the mask's S labels as int32
// in shared memory (90,000 bytes at 150 x 150; S < 2^15, which the wrapper
// checks):
//   1. load: L[p] = p for a foreground pixel, S for the background
//      (coalesced 32-bit loads, all of a thread's in flight at once);
//   2. row runs: a warp a row, 32 columns at a time, points every pixel of
//      a foreground run at the run's first pixel (one ballot finds the
//      nearest background lane below each lane, a shuffle carries a run
//      across 32-column steps; no atomics; trees are a run deep after
//      this);
//   3. unions between rows: a foreground pixel of row r > 0 is united with
//      its upper neighbour, or, when that is background, with its upper-
//      left and upper-right ones (when the upper one is foreground the
//      other two, if foreground, lie in its run). The union links the
//      larger root under the smaller with atomicMin and retries from the
//      root it lost to (Playne and Hawick's union), so every parent is
//      smaller than its child and the root of a component is its minimum
//      pixel;
//   4. flatten: every foreground pixel's label is its root (path
//      compression with plain stores of an ancestor, safe once the unions
//      are done), written coalesced to the output.
// Background pixels keep S throughout and are never a union's operand.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
// S < 2^15 (ops/kernels.cc_labels checks it): the most shared memory a CTA
// asks for
constexpr int kMaxSmem = (1 << 15) * 4;

__device__ __forceinline__ int find_root(volatile int* L, int p) {
  int q = L[p];
  while (q != p) {
    p = q;
    q = L[p];
  }
  return p;
}

__device__ __forceinline__ void unite(int* L, int a, int b) {
  while (true) {
    a = find_root(L, a);
    b = find_root(L, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // b is the larger root: hang it under a, unless another thread gave it
    // a parent first; then unite a with that parent
    const int old = atomicMin(&L[b], a);
    if (old == b) return;
    b = old;
  }
}

// Phase 1: L[p] = p for a foreground pixel, S for the background. With
// Vec the mask is read as 32-bit words (S % 4 == 0 and a 4-byte aligned
// base, which the launcher checks), every word of a thread issued before
// any is used, so the loads' latencies overlap.
template <bool Vec>
__device__ __forceinline__ void load_labels(const unsigned char* m, int* L,
                                            int S) {
  if (Vec) {
    constexpr int kWords = (kMaxSmem / 4 / 4 + kThreads - 1) / kThreads;
    const unsigned* mw = reinterpret_cast<const unsigned*>(m);
    const int nw = S / 4;
    unsigned v[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = threadIdx.x + k * kThreads;
      v[k] = w < nw ? __ldg(mw + w) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = threadIdx.x + k * kThreads;
      if (w < nw) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = 4 * w + i;
          L[p] = ((v[k] >> (8 * i)) & 0xffu) ? p : S;
        }
      }
    }
  } else {
    for (int p = threadIdx.x; p < S; p += kThreads) L[p] = m[p] ? p : S;
  }
}

template <bool Vec>
__global__ void __launch_bounds__(kThreads)
    cc_labels_kernel(const unsigned char* __restrict__ masks,
                     int* __restrict__ labels, int nr, int nc) {
  extern __shared__ int L[];
  const int S = nr * nc;
  const unsigned char* m = masks + static_cast<size_t>(blockIdx.x) * S;
  int* out = labels + static_cast<size_t>(blockIdx.x) * S;

  load_labels<Vec>(m, L, S);
  __syncthreads();

  // Phase 2: row runs, a warp a row, 32 columns at a time: a foreground
  // lane's run starts after the nearest background lane below it (one
  // ballot), else where the previous 32 columns' last run started
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nr; r += kThreads / 32) {
    int carry = r * nc;
    for (int c0 = 0; c0 < nc; c0 += 32) {
      const int p = r * nc + c0 + lane;
      const bool fg = c0 + lane < nc && L[p] != S;
      const unsigned bg = __ballot_sync(0xffffffffu, !fg);
      const unsigned below = bg & ((1u << lane) - 1u);
      const int start = below ? r * nc + c0 + (32 - __clz(below)) : carry;
      if (fg) L[p] = start;
      carry = __shfl_sync(0xffffffffu, fg ? start : r * nc + c0 + 32, 31);
    }
  }
  __syncthreads();

  // Phase 3: unions between rows
  for (int p = nc + threadIdx.x; p < S; p += kThreads) {
    if (L[p] == S) continue;
    const int r = p / nc;
    const int c = p - r * nc;
    const int up = p - nc;
    if (L[up] != S) {
      unite(L, p, up);
    } else {
      if (c > 0 && L[up - 1] != S) unite(L, p, up - 1);
      if (c + 1 < nc && L[up + 1] != S) unite(L, p, up + 1);
    }
  }
  __syncthreads();

  // Phase 4: flatten and write
  for (int p = threadIdx.x; p < S; p += kThreads) {
    int lab = S;
    if (L[p] != S) {
      lab = find_root(L, p);
      L[p] = lab;
    }
    out[p] = lab;
  }
}

}  // namespace

extern "C" int cc_cc_labels(const void* masks, void* labels, int n_masks,
                            int nr, int nc, void* stream) {
  if (n_masks < 0 || nr <= 0 || nc <= 0 ||
      static_cast<long long>(nr) * nc >= (1 << 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_masks == 0) return 0;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        cc_labels_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(cc_labels_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int S = nr * nc;
  const int smem = S * static_cast<int>(sizeof(int));
  const bool vec = S % 4 == 0 && reinterpret_cast<size_t>(masks) % 4 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const unsigned char*>(masks);
  int* out = static_cast<int*>(labels);
  if (vec)
    cc_labels_kernel<true><<<n_masks, kThreads, smem, st>>>(in, out, nr, nc);
  else
    cc_labels_kernel<false><<<n_masks, kThreads, smem, st>>>(in, out, nr, nc);
  return static_cast<int>(cudaGetLastError());
}
