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
  bool ok[kCols];
  bool any_ok = false;
  if (c0 < lim) {
    const T* base = keys_q + static_cast<size_t>(lv) * kD * NA;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      load4<T, kVec>(base + static_cast<size_t>(d) * NA, c0, NA, k[d]);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      bool row_valid = false;
#pragma unroll
      for (int d = 0; d < kD; ++d) row_valid |= k[d][j] != 0.f;
      ok[j] = row_valid && c0 + j < lim;
      any_ok |= ok[j];
    }
  }
  __syncthreads();                     // s_qv

#pragma unroll 2
  for (int a = 0; a < A; ++a) {
    const float* qa = s_q + a * kD;
    float m = kMaxDistSq;
    if (any_ok && s_qv[a]) {
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
    }
    s_min[t][a] = m;
  }
  __syncwarp();
  if (writer) {                        // min over the warp's 32 threads
    float m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = s_min[warp * 32 + i][lane];
#pragma unroll
    for (int i = 4; i < 32; ++i) m[i % 4] = fminf(m[i % 4], s_min[warp * 32 + i][lane]);
    out_q[lane * n_tiles + tile] = fminf(fminf(m[0], m[1]), fminf(m[2], m[3]));
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
