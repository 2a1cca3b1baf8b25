// Stage 1 of the tile-min-cover key search: masked squared key distance +
// per-128-column tile minimum over the search-layout key store.
//
// Replaces: contour_context_tpu/ops/pallas_kernels.py,
// _search_tilemin_kernel (called through search_tilemin_pallas), under the
// contract of the shipping JAX search db._search_cover2: distances are
// differenced directly and accumulated over d = 0..9 in order, and the tile
// is TOPK_TILE = 128 columns. For query level q (one of the Q q_levels),
// anchor a and tile t it writes
//   out[q, a, t] = min over columns c in t of d2(q, a, c)
// where d2 = sum_d (key[lv_q, d, c] - query[q, a, d])^2, or MAX_DIST_SQ when
// the key column is all zero, its scan c / A is not below searchable_n
// (read from state[1] on the device, so the host never syncs), c >= NA, or
// the query anchor is all zero.
//
// What bounds it on the card: memory, and only the searchable columns. A
// column at or past searchable_n * A is MAX_DIST_SQ whatever its keys hold,
// so the least the kernel must read is Q x 10 keys of each searchable column
// (60 B in bf16): 2.5 MB at searchable_n 7000 of capacity 8192, 0.09 MB in
// the smoke stream's last scans (3% of capacity searchable). At ~9 flops per
// byte read it sits under the card's fp32 ridge (~20 flops a byte: 67
// TFLOP/s over 3.35 TB/s). Tensor cores do not apply: the norm-cross form
// |q|^2 + |r|^2 - 2 q.r rounds differently, and the tile minima must
// bit-match the plain torch recompute of stage 2 (search_tilemin_plain), or
// the cover proof's tile ranking could break at near-ties. So every sub, mul
// and add is rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn: no FMA
// contraction) in the order d = 0..9.
//
// Design. A block of 128 threads covers 4 tiles (512 columns) of one query
// level, one warp a tile; grid (ceil(NA / 512), Q), 288 blocks at capacity
// 8192. Each thread holds 4 contiguous columns: on the vector path one
// 8-byte load per key dimension (one 16-byte load for f32 keys), so its 10
// loads are in flight together and a warp reads 256 (512) contiguous bytes
// per load. Each thread writes its 4-column minimum per anchor to shared
// memory, and lane a of the warp reduces anchor a's 32 minima to the tile
// minimum (no serial shuffle chain per anchor). A block whose first column
// lies at or past searchable_n * A writes MAX_DIST_SQ to its tiles and
// returns without touching keys_q (the condition is uniform across the
// block); in the block that holds the boundary, a thread whose columns all
// lie past it loads and computes nothing, and the others mask per column.
// So the bytes read follow the history that is searchable, not the capacity
// reserved. The query is read while state[1] is in flight.
//
// Measured on the H100 (PERF.md, kernel_times.py): 8 columns a thread with
// one 16-byte load each (a 16-lane shuffle min) was 0.4-0.5 us slower at
// searchable_n 246 and 7000 than 4 columns: a busy block's time is the
// chain state -> keys -> the thread's unfused arithmetic (30 instructions
// per anchor and column), not the load width, so halving the per-thread
// arithmetic paid and the wider load did not. The loads are kept in flight
// from registers; staging the slab in shared memory (cp.async or a TMA bulk
// copy) would not shorten that chain, so it is not used.
//
// The vector path needs NA % 8 == 0 and a 16-byte-aligned store, so that
// every (level, dim) row starts aligned. ContourDB sizes the store as
// capacity * A columns and _grow changes the capacity, so NA need not be a
// multiple of 8: the launcher then takes the scalar path (the same tiling,
// one 2- or 4-byte load per column). The choice is made from the shapes
// (cc_search_tilemin_vector), never by retrying.
//
// The batched entry (search_tilemin_batch_kernel) answers B queries against
// the same store in one launch, each with its own searchable_n (block mode:
// query b of a block sees the window before scan b's push; map serving: all
// B at the map's state). It takes the place of the fused reduction that
// jax.vmap of the query makes of this kernel's Pallas original. For query b
//   out[b, q, a, t] = the single-query out[q, a, t] at searchable_b[b],
// bit for bit: both entries share load_keys and the op order of min_cols.
// What bounds it: at B = 16 the unfusable arithmetic, not the bytes (16 x
// 22.7 MFLOP over 67 TFLOP/s fp32 = 2.7 us against 2.5 MB + 0.9 MB of
// output over 3.35 TB/s = 1.0 us at the capacity-8192 fixture); and since
// no sub, mul or add may fuse, every flop is an instruction of its own, so
// the instruction rate (half the FMA peak: 5.4 us) is the practical limit.
//
// Design. The work is the list of live (level, tile, query)
// items, in that order, tile t of a level live for query b iff t < L_b =
// ceil(min(searchable_b[b] * A, NA) / 128): N = Q * sum_b L_b items, all
// read on the device. A grid of kBlocksPerSM = 4 blocks of 4 warps an SM
// (fewer when there are fewer items than warps) splits them evenly: warp w
// takes a contiguous run of N / W, found by a 32-way search over the tiles
// (each lane sums min(t, L_b) over the queries for its candidate t). A
// warp keeps its tile's 10 x 4 keys a lane in registers while the run stays
// on that tile (one load of 10 x 8 bytes a lane in bf16), the query's 6 x
// 10 floats in shared memory, and the next item's query already in flight
// in two registers. For the main path's A = 6 the three anchor pairs are
// unrolled without a branch, 8 independent sums a lane each, and each
// pair's tile minimum is a 2-value transposed warp reduction (lanes 0-15
// anchor a, 16-31 anchor a + 1) that the compiler overlaps with the next
// pair's sums; another A takes the same sums 8 anchors at a time with an
// 8-value transposed reduction. Every tile past its query's limit is
// written MAX_DIST_SQ, a row a warp. The store leaves device memory once a
// launch; a tile shared by two warps' runs is read again from L2.
//
// Measured on the H100 (PERF.md, kernel_times.py; warm / cold, the fixture:
// B = 16, searchable_b 0..7000, capacity 8192). The previous design, a block
// of 4 warps x 4 tiles sweeping kBatchGroup = 4 queries (1152 blocks), took
// 16.7 / 17.8 us and 176-181 on a capacity-65536 map with all 16 queries at
// 60000 (2813 live tiles each). The designs tried since, in order: the
// balanced list with two anchors a pass and a 5-shuffle reduction an anchor,
// 17.1 / 18.6 (clock64 stamps: 4300 cycles of prologue, its three 64-bit
// divisions and a non-unrolled search, and 1870 for the first keys, before
// any work); the 8-value transposed reduction and the next query prefetched,
// 16.4 / 18.0; the first keys loaded with the first query, 16.0 / 17.3; 3
// anchors a pass no better, 4 spilled (18.4); 3, 5 or 6 blocks an SM slower
// (17.0, 18.6, 20.3); the A = 6 pairs unrolled 15.0 / 16.1 (the map:
// 156-162); the 32-bit split and the unrolled search 14.3 / 15.7 (the map:
// 161). A pure stream of the same sums reaches 0.85 fp32 instructions a
// cycle a scheduler at 16 warps an SM; the items reach ~0.7, and a warp's
// first ~3000 cycles (the limits, the search, the first keys from device
// memory) are not hidden at 3.8 items a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 10;
constexpr int kMaxA = 16;
constexpr int kTile = 128;
constexpr int kCols = 4;                       // columns per thread
constexpr int kThreads = 128;
constexpr int kTilesPerBlock = kThreads / 32;  // one warp per tile
constexpr int kBlockCols = kTilesPerBlock * kTile;  // 512
constexpr float kMaxDistSq = 1e6f;
constexpr int kBatchThreads = 128;             // the batched entry's block
constexpr int kBatchWarps = kBatchThreads / 32;
constexpr int kBlocksPerSM = 4;               // the batched entry's grid
constexpr int kPass = 2;                      // anchors a pass over the keys
static_assert(kMaxA * kD <= 2 * kThreads, "the query is staged 2 a thread");

// Load the thread's 4 columns of one (level, dim) row into k[0..3].
template <typename T, bool kVec>
__device__ __forceinline__ void load4(const T* __restrict__ row, int c0,
                                      int NA, float* k);

template <>
__device__ __forceinline__ void load4<__nv_bfloat16, true>(
    const __nv_bfloat16* __restrict__ row, int c0, int NA, float* k) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + c0));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 f0 = __bfloat1622float2(h[0]);
  const float2 f1 = __bfloat1622float2(h[1]);
  k[0] = f0.x; k[1] = f0.y; k[2] = f1.x; k[3] = f1.y;
}

template <>
__device__ __forceinline__ void load4<float, true>(
    const float* __restrict__ row, int c0, int NA, float* k) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(row + c0));
  k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16, false>(
    const __nv_bfloat16* __restrict__ row, int c0, int NA, float* k) {
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    k[j] = c0 + j < NA ? __bfloat162float(row[c0 + j]) : 0.f;
}

template <>
__device__ __forceinline__ void load4<float, false>(
    const float* __restrict__ row, int c0, int NA, float* k) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) k[j] = c0 + j < NA ? row[c0 + j] : 0.f;
}

// Load the thread's kCols columns at c0 of all kD dims of level lv into k;
// rv[j] says that column j's key is not all zero.
template <typename T, bool kVec>
__device__ __forceinline__ void load_keys(const T* __restrict__ keys_q, int lv,
                                          int c0, int NA,
                                          float (&k)[kD][kCols],
                                          bool (&rv)[kCols]) {
  const T* base = keys_q + static_cast<size_t>(lv) * kD * NA;
#pragma unroll
  for (int d = 0; d < kD; ++d)
    load4<T, kVec>(base + static_cast<size_t>(d) * NA, c0, NA, k[d]);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    bool v = false;
#pragma unroll
    for (int d = 0; d < kD; ++d) v |= k[d][j] != 0.f;
    rv[j] = v;
  }
}

// The thread's minimum over its kCols columns of the masked squared distance
// to the query anchor qa (kD floats): every sub, mul and add rounded on its
// own, d = 0..9 in order.
__device__ __forceinline__ float min_cols(const float (&k)[kD][kCols],
                                          const bool (&ok)[kCols],
                                          const float* __restrict__ qa) {
  float m = kMaxDistSq;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    float d2 = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const float diff = __fsub_rn(k[d][j], qa[d]);
      d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
    }
    m = fminf(m, ok[j] ? d2 : kMaxDistSq);
  }
  return m;
}

// Anchor `lane`'s minimum over the 32 threads of `warp` (its tile), from the
// per-thread minima in s_min.
__device__ __forceinline__ float warp_tile_min(
    float (*s_min)[kMaxA + 1], int warp, int lane) {
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = s_min[warp * 32 + i][lane];
#pragma unroll
  for (int i = 4; i < 32; ++i)
    m[i % 4] = fminf(m[i % 4], s_min[warp * 32 + i][lane]);
  return fminf(fminf(m[0], m[1]), fminf(m[2], m[3]));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
search_tilemin_kernel(const T* __restrict__ keys_q,
                      const float* __restrict__ q,
                      const int* __restrict__ state,
                      float* __restrict__ out, int A, int NA,
                      unsigned lv_packed, int n_tiles) {
  const int qi = blockIdx.y;
  const int lv = (lv_packed >> (8 * qi)) & 0xff;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x * kTilesPerBlock + warp;
  // lane a < A of each warp writes anchor a's minimum of the warp's tile
  const bool writer = lane < A && tile < n_tiles;
  float* out_q = out + static_cast<size_t>(qi) * A * n_tiles;

  // the query is read while state[1] is in flight, not after it
  const float* qq = q + qi * A * kD;
  const float q0 = t < A * kD ? qq[t] : 0.f;
  const float q1 = t + kThreads < A * kD ? qq[t + kThreads] : 0.f;
  // columns [0, lim) can be searchable; every other column is MAX_DIST_SQ
  const long long sn_cols = static_cast<long long>(state[1]) * A;
  const int lim = sn_cols < NA ? static_cast<int>(sn_cols) : NA;
  const int block_c0 = blockIdx.x * kBlockCols;
  if (block_c0 >= lim) {               // uniform across the block
    if (writer) out_q[lane * n_tiles + tile] = kMaxDistSq;
    return;
  }

  __shared__ float s_q[kMaxA * kD];
  __shared__ bool s_qv[kMaxA];
  __shared__ float s_min[kThreads][kMaxA + 1];  // odd stride: no conflicts
  if (t < A * kD) s_q[t] = q0;
  if (t + kThreads < A * kD) s_q[t + kThreads] = q1;
  __syncthreads();
  if (t < A) {
    bool v = false;
#pragma unroll
    for (int d = 0; d < kD; ++d) v |= s_q[t * kD + d] != 0.f;
    s_qv[t] = v;
  }

  const int c0 = block_c0 + t * kCols;
  float k[kD][kCols];
  bool ok[kCols] = {false, false, false, false};
  bool any_ok = false;
  if (c0 < lim) {
    load_keys<T, kVec>(keys_q, lv, c0, NA, k, ok);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      ok[j] = ok[j] && c0 + j < lim;
      any_ok |= ok[j];
    }
  }
  __syncthreads();                     // s_qv

#pragma unroll 2
  for (int a = 0; a < A; ++a)
    s_min[t][a] = any_ok && s_qv[a] ? min_cols(k, ok, s_q + a * kD)
                                    : kMaxDistSq;
  __syncwarp();
  if (writer)                          // min over the warp's 32 threads
    out_q[lane * n_tiles + tile] = warp_tile_min(s_min, warp, lane);
}

// Query b's searchable columns: [0, lim), lim = clamp(sn_b[b] * A, 0, NA).
__device__ __forceinline__ int query_lim(const int* __restrict__ sn_b, int b,
                                         int A, int NA) {
  const long long c = static_cast<long long>(sn_b[b]) * A;
  return c < NA ? (c > 0 ? static_cast<int>(c) : 0) : NA;
}

// Query b's live tiles L_b = ceil(lim_b / kTile); 0 for b >= B.
__device__ __forceinline__ int live_tiles(const int* __restrict__ sn_b, int b,
                                          int B, int A, int NA) {
  return b < B ? (query_lim(sn_b, b, A, NA) + kTile - 1) / kTile : 0;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The minimum over the warp of each of v[0..7], transposed: each exchange
// sends the half of the values that the partner keeps, so lane l ends with
// the minimum of value 4 * bit4(l) + 2 * bit3(l) + bit2(l) (min is exact:
// any order gives the same bits).
__device__ __forceinline__ float warp_min8(float (&v)[8], int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool up = lane & 16;
    const float send = up ? v[i] : v[i + 4];
    v[i] = fminf(up ? v[i + 4] : v[i],
                 __shfl_xor_sync(0xffffffffu, send, 16));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool up = lane & 8;
    const float send = up ? v[i] : v[i + 2];
    v[i] = fminf(up ? v[i + 2] : v[i], __shfl_xor_sync(0xffffffffu, send, 8));
  }
  const bool up = lane & 4;
  float m = fminf(up ? v[1] : v[0],
                  __shfl_xor_sync(0xffffffffu, up ? v[0] : v[1], 4));
  m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  return fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
}

// The live (level, tile, query) items [i0, i1) of one warp (see
// search_tilemin_batch_kernel): tot = sum_b L_b, max_L = max_b L_b, L0 the
// lane's L_b of b = lane.
template <typename T, bool kVec, int kA>
__device__ __forceinline__ void tilemin_items(
    const T* __restrict__ keys_q, const float* __restrict__ q,
    const int* __restrict__ sn_b, float* __restrict__ out, int B, int Q,
    int A, int NA, unsigned lv_packed, int n_tiles, int i0, int i1, int L0,
    int tot, int max_L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int n_words = (B + 31) >> 5;
  auto live = [&](int w) {
    return live_tiles(sn_b, (w << 5) + lane, B, A, NA);
  };
  auto live_of = [&](int b) {                  // L_b, the same on all lanes
    return b < 32 ? __shfl_sync(0xffffffffu, L0, b)
                  : live_tiles(sn_b, b, B, A, NA);
  };
  // the items of a level before tile tt (each lane its own tt)
  auto items_before = [&](int tt) {
    int s = 0;
#pragma unroll 8
    for (int b = 0; b < B; ++b) s += min(tt, live_of(b));
    return s;
  };
  auto live_count = [&](int tt) {
    int n = 0;
    for (int w = 0; w < n_words; ++w)
      n += __popc(__ballot_sync(0xffffffffu, (w ? live(w) : L0) > tt));
    return n;
  };
  int qi = i0 / tot;
  const int r = i0 - qi * tot;
  // the last tile with items_before(tile) <= r, 32 candidates a round
  int tile = 0, f_tile = 0;
  for (int span = max_L; span > 1;) {
    const int step = (span + 31) >> 5;
    const int tt = tile + lane * step;
    const int f_tt = items_before(min(tt, tile + span - 1));  // every lane
    const int f = tt < tile + span ? f_tt : 0x7fffffff;
    const int last = 31 - __clz(__ballot_sync(0xffffffffu, f <= r));
    f_tile = __shfl_sync(0xffffffffu, f, last);
    tile += last * step;
    span = min(step, span - last * step);
  }
  int j = r - f_tile, n_live = live_count(tile);
  const int max_lim = min(NA, max_L * kTile);

  // query b of the item (qi, tile, jj): the jj-th query for which the tile
  // is live
  auto query_of = [&](int tt, int jj) {
    int bq = 0;
    for (int w = 0; w < n_words; ++w) {
      const unsigned m = __ballot_sync(0xffffffffu, (w ? live(w) : L0) > tt);
      const int n = __popc(m);
      if (jj < n) {
        const unsigned sel = __ballot_sync(
            0xffffffffu, ((m >> lane) & 1u) && __popc(m & lt_mask) == jj);
        bq = (w << 5) + __ffs(sel) - 1;
        break;
      }
      jj -= n;
    }
    return bq;
  };
  // the query keys of item (b, qi) a lane holds: entries lane, lane + 32
  auto load_query = [&](int bq, int qq, float& x0, float& x1) {
    const float* qb = q + (static_cast<size_t>(bq) * Q + qq) * A * kD;
    x0 = lane < A * kD ? qb[lane] : 0.f;
    x1 = lane + 32 < A * kD ? qb[lane + 32] : 0.f;
  };

  __shared__ float s_q[kBatchWarps][kMaxA * kD];
  float* sq = s_q[warp];
  float k[kD][kCols];
  bool rv[kCols];
  int keys_of = -1;                            // (level, tile) held in k
  // lane l holds lim_b of b = l (word 0); a query's limit is a shuffle
  const int lim0 = lane < B ? query_lim(sn_b, lane, A, NA) : 0;
  auto lim_of = [&](int bq) {
    return bq < 32 ? __shfl_sync(0xffffffffu, lim0, bq)
                   : query_lim(sn_b, bq, A, NA);
  };
  // the query's anchors that are not all zero: from the registers that
  // hold it (A * kD <= 64), else from its staged copy
  auto valid_anchors = [&](float x0, float x1) {
    if (A * kD <= 64) {
      const unsigned long long nz =
          __ballot_sync(0xffffffffu, x0 != 0.f) |
          static_cast<unsigned long long>(
              __ballot_sync(0xffffffffu, x1 != 0.f)) << 32;
      return __ballot_sync(0xffffffffu,
                           lane < A && ((nz >> (lane * kD)) & 0x3ffull));
    }
    bool v = false;
    if (lane < A) {
#pragma unroll
      for (int d = 0; d < kD; ++d) v |= sq[lane * kD + d] != 0.f;
    }
    return __ballot_sync(0xffffffffu, v);
  };
  auto stage_query = [&](int bq, int qq, float x0, float x1) {
    if (A * kD <= 64) {
      if (lane < A * kD) sq[lane] = x0;
      if (lane + 32 < A * kD) sq[lane + 32] = x1;
    } else {
      for (int e = lane; e < A * kD; e += 32)
        sq[e] = q[(static_cast<size_t>(bq) * Q + qq) * A * kD + e];
    }
  };
  int b = query_of(tile, j);
  float qc0 = 0.f, qc1 = 0.f;                  // this item's query
  if (A * kD <= 64) load_query(b, qi, qc0, qc1);
  {                                            // the first keys, loaded
    keys_of = qi * n_tiles + tile;             // with the query in flight
    const int c0 = tile * kTile + lane * kCols;
#pragma unroll
    for (int jc = 0; jc < kCols; ++jc) rv[jc] = false;
    if (c0 < max_lim)
      load_keys<T, kVec>(keys_q, (lv_packed >> (8 * qi)) & 0xff, c0, NA, k,
                         rv);
  }
  stage_query(b, qi, qc0, qc1);
  for (int it = i0; it < i1; ++it) {
    // the next item, and its query's keys in flight while this one runs
    int qn = qi, tn = tile, jn = j + 1, nn = n_live;
    if (jn == nn) {
      jn = 0;
      nn = live_count(++tn);
      if (nn == 0) {
        tn = 0;
        ++qn;
        nn = live_count(0);
      }
    }
    const bool more = it + 1 < i1;
    const int bn = more ? query_of(tn, jn) : 0;
    float qx0 = 0.f, qx1 = 0.f;
    if (more && A * kD <= 64) load_query(bn, qn, qx0, qx1);

    const int lim = lim_of(b);
    const int c0 = tile * kTile + lane * kCols;
    if (qi * n_tiles + tile != keys_of) {      // the warp's next tile
      keys_of = qi * n_tiles + tile;
#pragma unroll
      for (int jc = 0; jc < kCols; ++jc) rv[jc] = false;
      if (c0 < max_lim)
        load_keys<T, kVec>(keys_q, (lv_packed >> (8 * qi)) & 0xff, c0, NA,
                           k, rv);
    }
    __syncwarp();                              // sq
    const unsigned qv = valid_anchors(qc0, qc1);
    bool ok[kCols];
#pragma unroll
    for (int jc = 0; jc < kCols; ++jc) ok[jc] = rv[jc] && c0 + jc < lim;

    float* ob = out + (static_cast<size_t>(b) * Q + qi) * A * n_tiles + tile;
    if (kA > 0) {                              // the pairs unrolled: each
#pragma unroll                                 // pair's reduction overlaps
      for (int a = 0; a < kA; a += 2) {        // the next pair's sums
        const float* qa0 = sq + a * kD;
        const float* qa1 = sq + min(a + 1, kA - 1) * kD;
        float m0 = __int_as_float(0x7f800000), m1 = m0;   // +inf
#pragma unroll
        for (int jc = 0; jc < kCols; ++jc) {
          const float f0 = __fsub_rn(k[0][jc], qa0[0]);
          const float f1 = __fsub_rn(k[0][jc], qa1[0]);
          float d0 = __fmul_rn(f0, f0), d1 = __fmul_rn(f1, f1);
#pragma unroll
          for (int d = 1; d < kD; ++d) {
            const float e0 = __fsub_rn(k[d][jc], qa0[d]);
            const float e1 = __fsub_rn(k[d][jc], qa1[d]);
            d0 = __fadd_rn(d0, __fmul_rn(e0, e0));
            d1 = __fadd_rn(d1, __fmul_rn(e1, e1));
          }
          m0 = fminf(m0, ok[jc] ? d0 : kMaxDistSq);
          m1 = fminf(m1, ok[jc] ? d1 : kMaxDistSq);
        }
        // lanes 0-15 end with anchor a's tile minimum, 16-31 with a + 1's
        const bool up = lane & 16;
        float m = fminf(up ? m1 : m0,
                        __shfl_xor_sync(0xffffffffu, up ? m0 : m1, 16));
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
        const int aa = a + (up ? 1 : 0);
        if ((lane & 15) == 0 && aa < kA)
          ob[aa * n_tiles] = (qv >> aa) & 1u ? m : kMaxDistSq;
      }
    } else {
      for (int a0 = 0; a0 < A; a0 += 8) {        // 8 anchors a reduction
        float v[8];
#pragma unroll
        for (int p = 0; p < 8; p += kPass) {   // 4 kPass chains
          const int a = a0 + p;
#pragma unroll
          for (int i = 0; i < kPass; ++i)
            if (p + i < 8) v[p + i] = __int_as_float(0x7f800000);   // +inf
          if (a < A) {
            const float* qa[kPass];
#pragma unroll
            for (int i = 0; i < kPass; ++i)
              qa[i] = sq + min(a + i, A - 1) * kD;
#pragma unroll
            for (int jc = 0; jc < kCols; ++jc) {
              // 0 + x == x for the square x >= +0: the sum starts at d = 0's
              float dd[kPass];
#pragma unroll
              for (int i = 0; i < kPass; ++i) {
                const float f = __fsub_rn(k[0][jc], qa[i][0]);
                dd[i] = __fmul_rn(f, f);
              }
#pragma unroll
              for (int d = 1; d < kD; ++d)
#pragma unroll
                for (int i = 0; i < kPass; ++i) {
                  const float e = __fsub_rn(k[d][jc], qa[i][d]);
                  dd[i] = __fadd_rn(dd[i], __fmul_rn(e, e));
                }
#pragma unroll
              for (int i = 0; i < kPass; ++i)
                if (p + i < 8) v[p + i] = fminf(v[p + i],
                                                ok[jc] ? dd[i] : kMaxDistSq);
            }
          }
        }
        // lane l ends with the tile minimum of anchor a0 + vi
        const float m = warp_min8(v, lane);
        const int vi = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                       ((lane >> 2) & 1);
        if ((lane & 3) == 0 && a0 + vi < A)
          ob[(a0 + vi) * n_tiles] =
              (qv >> (a0 + vi)) & 1u ? m : kMaxDistSq;
      }
    }

    __syncwarp();                              // this item's reads of sq
    if (more) stage_query(bn, qn, qx0, qx1);
    qi = qn; tile = tn; j = jn; n_live = nn; b = bn;
    qc0 = qx0; qc1 = qx1;
  }
}

// B queries in one launch: q (B, Q, A, kD), sn_b (B,) searchable_n of each
// query, out (B, Q, A, n_tiles). The work items are the live (level, tile,
// query) triples, in that order: tile t of a level is live for query b iff
// t < L_b = ceil(lim_b / kTile). Warp w of the grid's W takes items
// [w * N / W, (w + 1) * N / W), N = Q * sum_b L_b, all read on the device.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kBatchThreads, kBlocksPerSM)
search_tilemin_batch_kernel(const T* __restrict__ keys_q,
                            const float* __restrict__ q,
                            const int* __restrict__ sn_b,
                            float* __restrict__ out, int B, int Q, int A,
                            int NA, unsigned lv_packed, int n_tiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = gridDim.x * kBatchWarps;
  const int gw = blockIdx.x * kBatchWarps + warp;

  // live tiles of the queries: lane l holds L_b of b = 32 w + l in word w;
  // word 0 stays in a register, the others are read again (B > 32)
  const int n_words = (B + 31) >> 5;
  auto live = [&](int w) {
    return live_tiles(sn_b, (w << 5) + lane, B, A, NA);
  };
  const int L0 = live(0);
  int tot = 0, max_L = 0;
  for (int w = 0; w < n_words; ++w) {
    const int L = w ? live(w) : L0;
    tot += L;
    max_L = max(max_L, L);
  }
  tot = warp_sum(tot);
  max_L = warp_max(max_L);
  // a balanced split in 32-bit arithmetic (the launcher bounds
  // B * Q * n_tiles, so every item index fits): the first n_items %
  // n_warps warps take one item more
  const int n_items = Q * tot;
  const int share = n_items / n_warps, extra = n_items - share * n_warps;
  const int i0 = gw * share + min(gw, extra);
  const int i1 = i0 + share + (gw < extra ? 1 : 0);
  if (i0 < i1)
  {
    if (A == 6)
      tilemin_items<T, kVec, 6>(keys_q, q, sn_b, out, B, Q, A, NA, lv_packed,
                                n_tiles, i0, i1, L0, tot, max_L);
    else
      tilemin_items<T, kVec, 0>(keys_q, q, sn_b, out, B, Q, A, NA, lv_packed,
                                n_tiles, i0, i1, L0, tot, max_L);
  }

  // every tile past its query's limit is MAX_DIST_SQ: row (b, q, a) from
  // tile L_b on, a warp a row
  for (int row = gw; row < B * Q * A; row += n_warps) {
    const int b = row / (Q * A);
    const int L = live_tiles(sn_b, b, B, A, NA);
    for (int tt = L + lane; tt < n_tiles; tt += 32)
      out[static_cast<size_t>(row) * n_tiles + tt] = kMaxDistSq;
  }
}

template <typename T>
void launch(const void* keys_q, const void* q, const void* state, void* out,
            int Q, int A, int NA, unsigned lv_packed, bool vec,
            cudaStream_t s) {
  const int n_tiles = (NA + kTile - 1) / kTile;
  const dim3 grid((NA + kBlockCols - 1) / kBlockCols, Q);
  const T* k = static_cast<const T*>(keys_q);
  const float* qf = static_cast<const float*>(q);
  const int* st = static_cast<const int*>(state);
  float* o = static_cast<float*>(out);
  if (vec)
    search_tilemin_kernel<T, true><<<grid, kThreads, 0, s>>>(
        k, qf, st, o, A, NA, lv_packed, n_tiles);
  else
    search_tilemin_kernel<T, false><<<grid, kThreads, 0, s>>>(
        k, qf, st, o, A, NA, lv_packed, n_tiles);
}

template <typename T>
void launch_batch(const void* keys_q, const void* q, const void* sn_b,
                  void* out, int B, int Q, int A, int NA, unsigned lv_packed,
                  bool vec, int n_blocks, cudaStream_t s) {
  const int n_tiles = (NA + kTile - 1) / kTile;
  const T* k = static_cast<const T*>(keys_q);
  const float* qf = static_cast<const float*>(q);
  const int* sn = static_cast<const int*>(sn_b);
  float* o = static_cast<float*>(out);
  if (vec)
    search_tilemin_batch_kernel<T, true><<<n_blocks, kBatchThreads, 0, s>>>(
        k, qf, sn, o, B, Q, A, NA, lv_packed, n_tiles);
  else
    search_tilemin_batch_kernel<T, false><<<n_blocks, kBatchThreads, 0, s>>>(
        k, qf, sn, o, B, Q, A, NA, lv_packed, n_tiles);
}

}  // namespace

// 1 when the launcher takes the vector path for this store: NA a multiple
// of 8 and the base 16-byte aligned, so every (level, dim) row is aligned.
extern "C" int cc_search_tilemin_vector(const void* keys_q, int NA) {
  return NA % 8 == 0 &&
         reinterpret_cast<uintptr_t>(keys_q) % 16 == 0;
}

extern "C" int cc_search_tilemin(const void* keys_q, const void* q,
                                 const void* state, void* out, int Q, int A,
                                 int NA, int keys_bf16, unsigned lv_packed,
                                 int n_levels, void* stream) {
  if (A <= 0 || A > kMaxA || Q <= 0 || NA <= 0 || n_levels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = cc_search_tilemin_vector(keys_q, NA) != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keys_bf16)
    launch<__nv_bfloat16>(keys_q, q, state, out, Q, A, NA, lv_packed, vec, s);
  else
    launch<float>(keys_q, q, state, out, Q, A, NA, lv_packed, vec, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_search_tilemin_batch(const void* keys_q, const void* q,
                                       const void* sn_b, void* out, int B,
                                       int Q, int A, int NA, int keys_bf16,
                                       unsigned lv_packed, int n_levels,
                                       void* stream) {
  const long long n_tiles = (NA + kTile - 1) / kTile;
  if (A <= 0 || A > kMaxA || Q <= 0 || NA <= 0 || n_levels <= 0 || B <= 0 ||
      static_cast<long long>(B) * Q * A * n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // the grid: kBlocksPerSM blocks on each SM, fewer when there are fewer
  // (level, tile, query) items than warps
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long items = static_cast<long long>(B) * Q * n_tiles;
  const long long want = (items + kBatchWarps - 1) / kBatchWarps;
  const int n_blocks = static_cast<int>(
      want < static_cast<long long>(sms) * kBlocksPerSM
          ? want : static_cast<long long>(sms) * kBlocksPerSM);
  const bool vec = cc_search_tilemin_vector(keys_q, NA) != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keys_bf16)
    launch_batch<__nv_bfloat16>(keys_q, q, sn_b, out, B, Q, A, NA, lv_packed,
                                vec, n_blocks, s);
  else
    launch_batch<float>(keys_q, q, sn_b, out, B, Q, A, NA, lv_packed, vec,
                        n_blocks, s);
  return static_cast<int>(cudaGetLastError());
}
