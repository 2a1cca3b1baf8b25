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
// What bounds it on the card: memory. Each query reads the Q = 3 searched
// levels of the store once: 3 x 10 x NA bf16 values, about 3 MB at
// capacity 8192 (NA = 49152), against 3 x 6 x NA x 30 flops. Design: one
// block of 128 threads per (query level, tile), one thread per column; the
// thread's 10 bf16 loads are coalesced because columns are contiguous in the
// (L, D, NA) layout. Values are upcast in registers and every sub, mul and
// add is rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn) so nvcc cannot
// contract them into FMAs: the tile minima must bit-match the plain torch
// recompute of stage 2, or the cover proof's tile ranking could break at
// near-ties. A warp-shuffle min and a shared-memory pass over the 4 warps
// reduce each anchor's distances to the tile minimum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 10;
constexpr int kMaxA = 16;
constexpr int kTile = 128;
constexpr int kWarps = kTile / 32;
constexpr float kMaxDistSq = 1e6f;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void search_tilemin_kernel(const T* __restrict__ keys_q,
                                      const float* __restrict__ q,
                                      const int* __restrict__ state,
                                      float* __restrict__ out, int A, int NA,
                                      unsigned lv_packed, int n_tiles) {
  const int qi = blockIdx.y;
  const int tile = blockIdx.x;
  const int lv = (lv_packed >> (8 * qi)) & 0xff;
  const int col = tile * kTile + threadIdx.x;

  __shared__ float s_q[kMaxA * kD];
  __shared__ float s_min[kWarps][kMaxA];
  for (int i = threadIdx.x; i < A * kD; i += kTile)
    s_q[i] = q[qi * A * kD + i];
  __syncthreads();

  const int searchable_n = state[1];
  float k[kD];
  bool row_valid = false;
  const bool in_range = col < NA;
  const T* base = keys_q + static_cast<size_t>(lv) * kD * NA + col;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    k[d] = in_range ? to_f32(base[static_cast<size_t>(d) * NA]) : 0.f;
    row_valid |= k[d] != 0.f;
  }
  const bool col_ok = row_valid && in_range && (col / A) < searchable_n;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int a = 0; a < A; ++a) {
    const float* qa = s_q + a * kD;
    float d2 = 0.f;
    bool q_valid = false;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const float diff = __fsub_rn(k[d], qa[d]);
      d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
      q_valid |= qa[d] != 0.f;
    }
    float v = (col_ok && q_valid) ? d2 : kMaxDistSq;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) s_min[warp][a] = v;
  }
  __syncthreads();
  if (threadIdx.x < A) {
    const int a = threadIdx.x;
    float v = s_min[0][a];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = fminf(v, s_min[w][a]);
    out[(static_cast<size_t>(qi) * A + a) * n_tiles + tile] = v;
  }
}

}  // namespace

extern "C" int cc_search_tilemin(const void* keys_q, const void* q,
                                 const void* state, void* out, int Q, int A,
                                 int NA, int keys_bf16, unsigned lv_packed,
                                 int n_levels, void* stream) {
  if (A <= 0 || A > kMaxA || Q <= 0 || NA <= 0 || n_levels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (NA + kTile - 1) / kTile;
  const dim3 grid(n_tiles, Q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keys_bf16) {
    search_tilemin_kernel<__nv_bfloat16><<<grid, kTile, 0, s>>>(
        static_cast<const __nv_bfloat16*>(keys_q),
        static_cast<const float*>(q), static_cast<const int*>(state),
        static_cast<float*>(out), A, NA, lv_packed, n_tiles);
  } else {
    search_tilemin_kernel<float><<<grid, kTile, 0, s>>>(
        static_cast<const float*>(keys_q), static_cast<const float*>(q),
        static_cast<const int*>(state), static_cast<float*>(out), A, NA,
        lv_packed, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
