// Ring-key Gaussian contraction for the retrieval keys (make_keys), for one
// scan or a batch of B scans in one launch.
//
// Replaces: contour_context_tpu/ops/pallas_kernels.py, _ring_kernel (called
// through ring_key_divs_pallas; under jax.vmap(build_descriptor) in block
// mode and map serving, one batched pallas_call). For scan b, anchor a and
// division d:
//   divs[b, a, d] = sum_p w[b, p] * exp(-0.5 (c_d - dist[b, a, p])^2)
//                   / sqrt(2 pi)
// where a pool pixel p of scan b counts (w = its `higher` weight) iff it
// lies in the anchor's RoI box, dist < roi_radius - 0.01 and its ok flag is
// set; counts[b, a] is the number of pixels that count. The centres are
// shared by the batch.
//
// What bounds it on the card: at the main path's shape (36 anchors x 4096
// pool pixels x 35 divisions a scan) the function must read 137.5 KB a scan
// and take one expf per (counted pixel, division): 2.2 MB and 0.45 M expf
// for a block of 16, a bound of 0.66 us by bytes. One scan's bound (0.04
// us) is far under a launch's own device-side cost (~1 us), so one scan can
// only aim at the launch floor; a block of scans can aim at its bytes.
//
// Design. One cluster of kCluster = 8 CTAs of 512 threads
// takes one scan: grid (kCluster, B), 128 CTAs for a block of 16, two CTAs
// an SM at most (64 registers, 18.8 KB of shared memory), so the 16
// clusters land in one wave. The pool is cut into stripes of kStripe = 8
// rows and stripe s goes to CTA s mod kCluster, so each row leaves device
// memory once, read by one thread, and the pool's ok pixels
// (select_topk_stable puts them first: 110-210 of 4096 in the smoke's
// scans) spread over all 8 CTAs instead of landing in one slice. A thread
// loads its row of each 4096-row chunk (two float4s; the first chunk is in
// flight while the anchors load), and the CTA compacts the ok rows into
// shared memory in pixel order (one ballot a warp, a shuffle scan of the
// 16 warp counts in every warp, two barriers). Warp w then owns anchors w,
// w + 16, ... of a pass of kGroup = 48: it tests them all against 32 ok
// rows at a time (lane r, row r; in the box, FMA-free distance, radius)
// and adds each anchor's hits in row order, lane d holding divisions d and
// 32 + d: the hits' distances and weights come over shuffles, kHitGroup =
// 4 at a time, so their expfs overlap while the adds stay in order. No hit
// list, no term buffer and no barrier inside the pass; a pool longer than
// 4096 rows is taken chunk by chunk with the sums carried in registers.
// Last, each warp pushes its sums and counts straight into the shared
// memory of the rank that owns them (value i = a * 36 + e to rank
// i / kOwn, in the row of the sending rank) with st.async, which counts
// the bytes on the owner's mbarrier; the owner waits on its own barrier
// for the pass's bytes, not on the whole cluster, and adds the 8 rows in
// rank order. A cluster barrier is left only at the start (every CTA has
// started and armed its barrier before anyone pushes) and between passes
// of more than kGroup anchors (the last pass is read before the next
// overwrites it). No float atomics and no fast-math,
// every sub, mul and add is rounded on its own (__f*_rn: no FMA
// contraction), so
//   divs[b, a, d] = (((0 + S_0) + S_1) + ...) + S_7, where S_r is the sum,
//   from 0 in pixel order, of the terms of the pixels of rank r's stripes,
// which ring_key_divs_batch_plain (ops/kernels.py) repeats op for op: the
// kernel equals it bit for bit. Scan b's anchors, pool and outputs start at
// row b, so a row of a batched launch is bit-equal to a launch of that scan
// alone. The wrapper checks that `pool` is 16-byte aligned (every scan's
// rows then are); the plain version's split (CLUSTER, RING_STRIPE) is held
// to kCluster and kStripe by a CPU test that reads them from this file.
//
// Measured on the H100 (PERF.md, kernel_times.py; warm / cold, the smoke's
// first block of 16 and its first scan). The previous design gave each
// (scan, anchor) a 4-CTA cluster that swept the scan's whole 128 KB pool:
// one scan 4.3 / 5.5 us (one CTA per anchor 8.3 warm, a cluster of 2 5.5;
// the one-CTA-per-anchor kernel before it 6.8), an empty pool 2.5-2.8; at B
// = 16 (the scan as gridDim.z) 17.8 / 18.8 us, growing with anchors x B (9,
// 18, 36 anchors: 6.6, 10.6, 17.9 warm; B = 64: 60): 2304 CTAs in three
// waves, each anchor re-reading its scan's pool, 75 MB through L2 to read
// 2.2 MB. The designs tried since, in order: a hit list in shared memory
// (ballot masks, a block scan, a fill), swept by 256 threads a pair (anchor,
// division) each, 10.6 / 12.3 at B = 16 and 8.7 / 9.6 for one scan; the
// terms computed at once into a buffer and summed a pair a thread, 512
// threads, 10.4 / 11.1 and 6.8 / 7.2 (clock64 stamps: five
// barrier-separated, latency-bound phases took 6000 of 11000 cycles); a warp
// an anchor as above, 7.6 / 8.5 and 5.1 / 5.5, and with the tests of a
// warp's anchors overlapped and 64 registers (two CTAs an SM: at 80
// registers one CTA an SM fits and the 16 clusters need two waves, 10.1 us)
// 7.0 / 7.8 and 4.7 / 5.2; one scan was then ~0.3 us slower warm than the
// previous design (5.31 against 4.76 us a launch inside the stream), the
// cluster barrier after the partials ~0.8 us of it (clock64). The push on
// mbarriers in its place (kept): a block of 16 6.5 / 7.3, one scan 4.25 /
// 4.66, an empty pool 2.6 / 3.1, 4.80 us a launch inside the stream. What
// is left for one scan: ~0.9 us of first loads and the anchor loop.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDiv = 35;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;                    // CTAs a scan
constexpr int kStripe = 8;                     // rows a stripe
constexpr int kRows = 512;                     // rows a CTA a chunk, 1 a thread
constexpr int kChunk = kCluster * kRows;       // 4096 pool rows a chunk
constexpr int kWords = kRows / 32;             // 32-row words of a chunk
constexpr int kGroup = 48;                     // anchors a pass
constexpr int kSlots = (kGroup + kWarps - 1) / kWarps;  // anchors a warp
constexpr int kVals = kGroup * (kDiv + 1);     // sums and counts a pass
constexpr int kOwn = (kVals + kCluster - 1) / kCluster;  // a rank's share
constexpr int kHitGroup = 4;                   // hits whose terms overlap
constexpr float kInvSqrt2Pi = 0.3989422804014327f;
static_assert(kRows <= kThreads && kRows % 32 == 0, "whole row words");
static_assert(kWords <= 32, "one warp scans the row words");
static_assert(kRows % kStripe == 0, "whole stripes a CTA");
static_assert(kDiv <= 64, "two divisions a lane");

// dist of pool row x (p_r, p_c, rowf, colf) from the anchor centre: every
// op rounded on its own, as the plain version computes it
__device__ __forceinline__ float pixel_dist(const float4 x, const float* an) {
  const float dr = x.z - an[0], dc = x.w - an[1];
  return sqrtf(__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dc, dc)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the same shared address in the CTA of cluster rank r
__device__ __forceinline__ unsigned map_rank(unsigned addr, int r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(r));
  return out;
}

// one thread: this pass expects `bytes` of partials on the barrier
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// v into rank-mapped address dst, counted on the rank's barrier rbar
__device__ __forceinline__ void push(unsigned dst, float v, unsigned rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" :: "r"(dst), "r"(__float_as_uint(v)), "r"(rbar) : "memory");
}

// until the barrier's phase of this parity completes: the pass's pushes
// into this CTA are then visible to it
__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// bytes of partials rank r receives in a pass of ng anchors
__device__ __forceinline__ unsigned pass_bytes(int ng, int r) {
  const int n = min(max(ng * (kDiv + 1) - r * kOwn, 0), kOwn);
  return static_cast<unsigned>(n * kCluster * 4);
}

// w * exp(-(c - dist)^2 / 2) / sqrt(2 pi), every op rounded on its own
__device__ __forceinline__ float ring_term(float c, float dist, float w) {
  const float x = __fsub_rn(c, dist);
  return __fmul_rn(
      w, __fmul_rn(expf(__fmul_rn(-0.5f, __fmul_rn(x, x))), kInvSqrt2Pi));
}

__global__ void __launch_bounds__(kThreads, 2)
ring_key_divs_kernel(const float* __restrict__ anchors,
                     const float4* __restrict__ pool,
                     const float* __restrict__ centers,
                     float* __restrict__ divs, float* __restrict__ counts,
                     int A8, int P, float roi_radius) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const float lim = roi_radius - 1e-2f;
  pool += 2 * b * P;
  anchors += 8 * b * A8;

  __shared__ float4 s_pa[kRows];               // ok rows: p_r, p_c, rowf, colf
  __shared__ float s_pw[kRows];                // and their weights
  __shared__ float s_an[kGroup][8];
  __shared__ float s_recv[kCluster][kOwn];     // partials, written by ranks
  __shared__ int s_row_n[kWords];
  __shared__ alignas(8) unsigned long long s_bar;  // a pass's partials in
  const unsigned bar = smem_addr(&s_bar);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
                 : "memory");
    expect_bytes(bar, pass_bytes(min(kGroup, A8), rank));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster must have started, and armed its barrier,
  // before another stores into its shared memory: arrive now, wait before
  // the first store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // lane d's divisions d and 32 + d (the second for d < 3 only)
  const float cen0 = centers[lane];
  const float cen1 = lane + 32 < kDiv ? centers[lane + 32] : 0.f;

  const int n_chunks = (P + kChunk - 1) / kChunk;
  // local row t of chunk c is pool row
  // c * kChunk + ((t / kStripe) * kCluster + rank) * kStripe + t % kStripe
  const long long row0 = ((t / kStripe) * kCluster + rank) * kStripe +
                         t % kStripe;
  float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f);
  float w = 0.f;
  bool ok = false;
  if (t < kRows && row0 < P) {                 // chunk 0, in flight
    x0 = pool[2 * row0];                       // p_r, p_c, rowf, colf
    const float4 x1 = pool[2 * row0 + 1];      // higher, ok, -, -
    w = x1.x;
    ok = x1.y > 0.f;
  }
  int n_ok = 0;
  bool waited = false;
  unsigned parity = 0;
  for (int g0 = 0; g0 < A8; g0 += kGroup) {
    const int ng = min(kGroup, A8 - g0);
    for (int i = t; i < ng * 8; i += kThreads)
      s_an[i >> 3][i & 7] = anchors[static_cast<long long>(g0) * 8 + i];
    // slot s of this warp is anchor warp + kWarps * s of the pass; lane d
    // holds its sums of divisions d and 32 + d, and its count
    float acc0[kSlots], acc1[kSlots];
    int cnt[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      acc0[k] = acc1[k] = 0.f;
      cnt[k] = 0;
    }

    for (int c = 0; c < n_chunks; ++c) {
      if (g0 == 0 || n_chunks > 1) {
        if (c > 0 || g0 > 0) {
          const long long p = static_cast<long long>(c) * kChunk + row0;
          ok = false;
          if (t < kRows && p < P) {
            x0 = pool[2 * p];
            const float4 x1 = pool[2 * p + 1];
            w = x1.x;
            ok = x1.y > 0.f;
          }
        }
        // the chunk's ok rows, compacted in local row (= pixel) order
        const unsigned bal = __ballot_sync(0xffffffffu, ok);
        if (lane == 0 && warp < kWords) s_row_n[warp] = __popc(bal);
        __syncthreads();                       // s_row_n (and s_an)
        int v = lane < kWords ? s_row_n[lane] : 0;
        const int own = v;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        n_ok = __shfl_sync(0xffffffffu, v, 31);
        const int base = __shfl_sync(0xffffffffu, v - own, warp & 31);
        if (ok) {
          const int k = base + __popc(bal & lt_mask);
          s_pa[k] = x0;
          s_pw[k] = w;
        }
        __syncthreads();                       // s_pa, s_pw
      } else {
        __syncthreads();                       // s_an
      }

      // a warp tests its anchors against 32 ok rows at once (lane r, row
      // r), then adds each anchor's hits in row order, kHitGroup at a time
      // (their exps overlap, the adds stay in order)
      for (int w0 = 0; w0 < n_ok; w0 += 32) {
        const int r = w0 + lane;
        const bool in_chunk = r < n_ok;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        float wr = 0.f;
        if (in_chunk) {
          x = s_pa[r];
          wr = s_pw[r];
        }
        float dist[kSlots];
        unsigned m[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const int a = warp + kWarps * k;     // the same on the warp
          bool hit = false;
          dist[k] = 0.f;
          if (a < ng && in_chunk) {
            const float* an = s_an[a];
            const bool in_box = x.x >= an[2] && x.x <= an[3] &&
                                x.y >= an[4] && x.y <= an[5];
            dist[k] = pixel_dist(x, an);
            hit = in_box && dist[k] < lim;
          }
          m[k] = __ballot_sync(0xffffffffu, hit);
        }
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          cnt[k] += __popc(m[k]);
          while (m[k]) {
            float dh[kHitGroup], wh[kHitGroup];
            int nh = 0;
#pragma unroll
            for (int i = 0; i < kHitGroup; ++i) {
              const int h = m[k] ? __ffs(m[k]) - 1 : 0;
              nh += m[k] != 0;
              m[k] &= m[k] - 1;
              dh[i] = __shfl_sync(0xffffffffu, dist[k], h);
              wh[i] = __shfl_sync(0xffffffffu, wr, h);
            }
            float t0[kHitGroup], t1[kHitGroup];
#pragma unroll
            for (int i = 0; i < kHitGroup; ++i) {
              t0[i] = ring_term(cen0, dh[i], wh[i]);
              t1[i] = ring_term(cen1, dh[i], wh[i]);
            }
#pragma unroll
            for (int i = 0; i < kHitGroup; ++i)
              if (i < nh) {
                acc0[k] = __fadd_rn(acc0[k], t0[i]);
                acc1[k] = __fadd_rn(acc1[k], t1[i]);
              }
          }
        }
      }
      __syncthreads();                         // before s_pa is refilled
    }

    // value i = a * 36 + e (e < 35: division e, e = 35: the count) is
    // summed by rank i / kOwn: each CTA pushes its partial there, in the
    // row of its own rank, counted on the owner's barrier; once its bytes
    // are in, the owner adds the rows in rank order
    if (waited) {
      cluster.sync();                          // the last pass is read
      if (t == 0) expect_bytes(bar, pass_bytes(ng, rank));
    } else {
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      waited = true;
    }
    const unsigned recv = smem_addr(&s_recv[rank][0]);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int a = warp + kWarps * k;
      if (a < ng) {
        const int v0 = a * (kDiv + 1) + lane;
        push(map_rank(recv + 4 * (v0 % kOwn), v0 / kOwn), acc0[k],
             map_rank(bar, v0 / kOwn));
        if (lane + 32 <= kDiv) {               // divisions 32.. and the count
          const int v1 = v0 + 32;
          push(map_rank(recv + 4 * (v1 % kOwn), v1 / kOwn),
               lane + 32 < kDiv ? acc1[k] : static_cast<float>(cnt[k]),
               map_rank(bar, v1 / kOwn));
        }
      }
    }
    wait_parity(bar, parity);
    parity ^= 1u;
    const int n_val = ng * (kDiv + 1);
    for (int j = t; j < kOwn && rank * kOwn + j < n_val; j += kThreads) {
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) v = __fadd_rn(v, s_recv[r][j]);
      const int i = rank * kOwn + j;
      const int a = i / (kDiv + 1), e = i - a * (kDiv + 1);
      const long long row = b * A8 + g0 + a;
      if (e < kDiv)
        divs[row * kDiv + e] = v;
      else
        counts[row] = v;
    }
  }
  if (!waited)                                 // A8 == 0 never launches
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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
  if (n_scans > 65535 || n_pool < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_scans <= 0 || n_anchors <= 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, n_scans);
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
      static_cast<float*>(divs), static_cast<float*>(counts), n_anchors,
      n_pool, roi_radius);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
