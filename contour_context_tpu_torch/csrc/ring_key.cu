// Ring-key Gaussian contraction for the retrieval keys (make_keys).
//
// Replaces: contour_context_tpu/ops/pallas_kernels.py, _ring_kernel (called
// through ring_key_divs_pallas). For anchor a and division d:
//   divs[a, d] = sum_p w[a, p] * exp(-0.5 (c_d - dist[a, p])^2) / sqrt(2 pi)
// where a pool pixel p counts (w = its `higher` weight) iff it lies in the
// anchor's RoI box, dist < roi_radius - 0.01 and its ok flag is set;
// counts[a] is the number of pixels that count.
//
// What bounds it on the card: at the main-path shape (36 anchors x 4096 pool
// pixels x 35 divisions) it is about 5 M expf per scan, a few microseconds
// of SFU throughput, so launch latency dominates. Design: one block per
// anchor (36 blocks), 256 threads striding over the pool; every thread keeps
// the 35 division sums and its count in registers, so the only memory
// traffic is one pass over the 128 KB pool per block (L2-resident after the
// first block). A warp-shuffle reduction then a shared-memory pass over the
// 8 warps combines the partial sums. Anchors whose box is empty (padded or
// invalid anchors) contribute 0. No fast-math: expf and the division sums
// stay within float32 summation-order error of the plain torch version.

#include <cuda_runtime.h>

namespace {

constexpr int kDiv = 35;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__global__ void ring_key_divs_kernel(const float* __restrict__ anchors,
                                     const float* __restrict__ pool,
                                     const float* __restrict__ centers,
                                     float* __restrict__ divs,
                                     float* __restrict__ counts, int P,
                                     float roi_radius) {
  const int a = blockIdx.x;
  const float* an = anchors + a * 8;
  const float v0 = an[0], v1 = an[1];
  const float r_min = an[2], r_max = an[3], c_min = an[4], c_max = an[5];
  __shared__ float s_cen[kDiv];
  __shared__ float s_part[kWarps][kDiv + 1];
  for (int d = threadIdx.x; d < kDiv; d += kThreads) s_cen[d] = centers[d];
  __syncthreads();

  float acc[kDiv + 1];
#pragma unroll
  for (int d = 0; d <= kDiv; ++d) acc[d] = 0.f;

  const float lim = roi_radius - 1e-2f;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float* px = pool + p * 8;
    const float p_r = px[0], p_c = px[1];
    const bool in_box = p_r >= r_min && p_r <= r_max && p_c >= c_min &&
                        p_c <= c_max;
    const float dr = px[2] - v0, dc = px[3] - v1;
    // no FMA contraction: dist must round like the plain version's, or a
    // pixel on the RoI radius could count in one and not the other
    const float dist = sqrtf(__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dc, dc)));
    if (in_box && dist < lim && px[5] > 0.f) {
      const float w = px[4];
#pragma unroll
      for (int d = 0; d < kDiv; ++d) {
        const float x = s_cen[d] - dist;
        acc[d] += w * (expf(-0.5f * (x * x)) * kInvSqrt2Pi);
      }
      acc[kDiv] += 1.f;
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 0; d <= kDiv; ++d) {
    float v = acc[d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_part[warp][d] = v;
  }
  __syncthreads();
  for (int d = threadIdx.x; d <= kDiv; d += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_part[w][d];
    if (d < kDiv)
      divs[a * kDiv + d] = v;
    else
      counts[a] = v;
  }
}

}  // namespace

extern "C" int cc_ring_key_divs(const void* anchors, const void* pool,
                                const void* centers, void* divs, void* counts,
                                int n_anchors, int n_pool, float roi_radius,
                                void* stream) {
  if (n_anchors <= 0) return 0;
  ring_key_divs_kernel<<<n_anchors, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(anchors), static_cast<const float*>(pool),
      static_cast<const float*>(centers), static_cast<float*>(divs),
      static_cast<float*>(counts), n_pool, roi_radius);
  return static_cast<int>(cudaGetLastError());
}
