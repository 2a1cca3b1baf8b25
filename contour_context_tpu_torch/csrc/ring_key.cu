// Ring-key Gaussian contraction for the retrieval keys (make_keys), for one
// scan or a batch of B scans in one launch.
//
// Replaces: contour_context_tpu/ops/pallas_kernels.py, _ring_kernel (called
// through ring_key_divs_pallas; under jax.vmap(build_descriptor) in block
// mode and map serving, one batched pallas_call). For scan b, anchor a and
// division d:
//   divs[b, a, d] = sum_p w[b, a, p] * exp(-0.5 (c_d - dist[b, a, p])^2)
//                   / sqrt(2 pi)
// where a pool pixel p of scan b counts (w = its `higher` weight) iff it
// lies in the anchor's RoI box, dist < roi_radius - 0.01 and its ok flag is
// set; counts[b, a] is the number of pixels that count. The centres are
// shared by the batch.
//
// What bounds it on the card: at the main path's shape (36 anchors x 4096
// pool pixels x 35 divisions a scan) the function must read 137.5 KB a scan
// and take one expf per (counted pixel, division): under 0.4 M at most, 24 K
// in the smoke stream's first scan. Either is a fraction of a microsecond,
// far under a launch's own device-side cost, so no launch for one scan can
// reach half its bound: the goal is the launch floor, and the batch entry
// (gridDim.z = B) pays that floor once for a block of scans instead of once
// a scan.
//
// Design. What the work costs here is the box-test sweep: every anchor
// reads its scan's whole 128 KB pool (from L2 after the first reader). A
// cluster of kCluster CTAs takes one anchor, each CTA a contiguous slice of
// the pool, so 4 x 36 = 144 CTAs a scan share the sweep instead of 36 SMs.
// Each thread loads its pixel's 32-byte row as two float4s (neighbouring
// threads on neighbouring rows) and four pixels at a time, so four rows are
// in flight. Box, radius (FMA-free: dist must round like the plain
// version's, or a pixel on the RoI radius could count in one and not the
// other) and ok are tested for each pixel; the few that count (~20 of 4096
// for an average anchor) are compacted as (dist, w) into shared memory, in
// pixel order, by a warp ballot and a block scan of the warp counts. Then
// the (pixel, division) pairs of the compacted list are swept on full
// warps: thread t owns division t mod 35 for the pixels j = t / 35 (mod 7),
// on 245 of 256 threads, with one accumulator each and no divergent 35-exp
// branch. Each division's 7 partials are summed in a fixed order, and CTA
// rank 0 of the cluster adds the CTAs' partial sums over distributed shared
// memory in rank order. No float atomics and no fast-math, and every sub,
// mul and add of the sweep and the sums is rounded on its own (__f*_rn: no
// FMA contraction): the order is fixed, so ring_key_divs_batch_plain
// (ops/kernels.py) repeats it op for op and equals the kernel bit for bit.
// Scan b is blockIdx.z: its anchors, pool and outputs start at row b, so a
// row of a batched launch is bit-equal to a launch of that scan alone. The
// wrapper checks that `pool` is 16-byte aligned (every scan's rows then are).
//
// Measured on the H100 (PERF.md, kernel_times.py; warm, the smoke's first
// scan): one CTA per anchor 8.3 us, a cluster of 2 5.5 us, of 4 4.3 us
// (the one-CTA-per-anchor kernel this replaces: 6.8 us). With an empty pool
// the kernel still takes 2.5-2.7 us (the launch, the anchor loads, the
// barriers and the cluster's reduction) against 1.0 us for a one-element
// fill: that, not the sweep, is what is left for one scan.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDiv = 35;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPhases = kThreads / kDiv;       // 7: pixels j = t / 35 mod 7
constexpr int kUnroll = 4;                     // pixels in flight a thread
constexpr int kRound = kUnroll * kThreads;     // 1024 pixels a round
constexpr int kChunk = 4 * kRound;             // pixels compacted at once
constexpr int kCluster = 4;                    // CTAs per anchor
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__global__ void __launch_bounds__(kThreads)
ring_key_divs_kernel(const float* __restrict__ anchors,
                     const float4* __restrict__ pool,
                     const float* __restrict__ centers,
                     float* __restrict__ divs, float* __restrict__ counts,
                     int P, float roi_radius) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // (scan, anchor) row of this cluster; the scan's pool starts at row b * P
  const long long row =
      static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  pool += 2 * static_cast<long long>(blockIdx.z) * P;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* an = anchors + row * 8;
  const float v0 = an[0], v1 = an[1];
  const float r_min = an[2], r_max = an[3], c_min = an[4], c_max = an[5];
  const float lim = roi_radius - 1e-2f;

  __shared__ float2 s_list[kChunk];            // (dist, w) of counted pixels
  __shared__ int s_warp_n[kUnroll * kWarps];
  __shared__ int s_warp_off[kUnroll * kWarps];
  __shared__ int s_round_n;
  __shared__ float s_cen[kDiv];
  __shared__ float s_phase[kPhases][kDiv];
  __shared__ float s_part[kDiv + 1];           // read by rank 0 over DSMEM
  if (t < kDiv) s_cen[t] = centers[t];

  // this CTA's slice of the pool: contiguous, in rank order, a multiple of
  // the block so that neighbouring threads read neighbouring rows
  const int per =
      (P + kCluster * kThreads - 1) / (kCluster * kThreads) * kThreads;
  const int lo = rank * per;
  const int hi = min(P, lo + per);
  const int d = t % kDiv, ph = t / kDiv;
  const bool sweeper = t < kPhases * kDiv;
  const unsigned lt_mask = (1u << lane) - 1u;
  float acc = 0.f;
  int n_counted = 0;

  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int c1 = min(hi, c0 + kChunk);
    int n = 0;                                 // entries in s_list
    for (int r0 = c0; r0 < c1; r0 += kRound) {
      float2 e[kUnroll];
      bool hit[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int p = r0 + j * kThreads + t;
        hit[j] = false;
        if (p < c1) {
          const float4 x0 = pool[2 * p];       // p_r, p_c, rowf, colf
          const float4 x1 = pool[2 * p + 1];   // higher, ok, -, -
          const bool in_box = x0.x >= r_min && x0.x <= r_max &&
                              x0.y >= c_min && x0.y <= c_max;
          const float dr = x0.z - v0, dc = x0.w - v1;
          const float dist =
              sqrtf(__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dc, dc)));
          hit[j] = in_box && dist < lim && x1.y > 0.f;
          e[j] = make_float2(dist, x1.x);
        }
      }
      unsigned ballot[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        ballot[j] = __ballot_sync(0xffffffffu, hit[j]);
        if (lane == 0) s_warp_n[j * kWarps + warp] = __popc(ballot[j]);
      }
      __syncthreads();
      if (warp == 0) {                         // scan of the 32 warp counts,
        const int v = s_warp_n[lane];          // ordered (j, warp): pixel order
        int incl = v;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += u;
        }
        s_warp_off[lane] = n + incl - v;
        if (lane == 31) s_round_n = incl;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (hit[j])
          s_list[s_warp_off[j * kWarps + warp] + __popc(ballot[j] & lt_mask)] =
              e[j];
      n += s_round_n;
    }
    __syncthreads();                           // s_list complete
    n_counted += n;
    if (sweeper) {
      const float cd = s_cen[d];
      for (int j = ph; j < n; j += kPhases) {
        const float2 e = s_list[j];
        const float x = __fsub_rn(cd, e.x);
        const float g = __fmul_rn(expf(__fmul_rn(-0.5f, __fmul_rn(x, x))),
                                  kInvSqrt2Pi);
        acc = __fadd_rn(acc, __fmul_rn(e.y, g));
      }
    }
    __syncthreads();                           // before s_list is refilled
  }

  if (sweeper) s_phase[ph][d] = acc;
  __syncthreads();
  if (t < kDiv) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kPhases; ++i) v = __fadd_rn(v, s_phase[i][t]);
    s_part[t] = v;
  } else if (t == kDiv) {
    s_part[kDiv] = static_cast<float>(n_counted);
  }
  cluster.sync();
  if (rank == 0 && t <= kDiv) {
    float v = 0.f;
    for (int r = 0; r < kCluster; ++r)
      v = __fadd_rn(v, cluster.map_shared_rank(s_part, r)[t]);
    if (t < kDiv)
      divs[row * kDiv + t] = v;
    else
      counts[row] = v;
  }
  cluster.sync();                              // keep s_part alive for rank 0
}

}  // namespace

// B scans in one launch: anchors (B, n_anchors, 8), pool (B, n_pool, 8),
// divs (B, n_anchors, 35), counts (B, n_anchors); the centres are shared.
// One scan is the launch at B = 1.
extern "C" int cc_ring_key_divs_batch(const void* anchors, const void* pool,
                                      const void* centers, void* divs,
                                      void* counts, int n_scans,
                                      int n_anchors, int n_pool,
                                      float roi_radius, void* stream) {
  if (n_scans <= 0 || n_anchors <= 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, n_anchors, n_scans);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, ring_key_divs_kernel, static_cast<const float*>(anchors),
      static_cast<const float4*>(pool), static_cast<const float*>(centers),
      static_cast<float*>(divs), static_cast<float*>(counts), n_pool,
      roi_radius);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
