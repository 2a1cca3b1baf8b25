// The two DYNAMIC_THRES recurrences of the query, for B queries in one
// launch each: the re-gating of the check cascade with rising count bars
// (dyn_pass_scan) and the post-processing screens with rising float bars
// (dyn_post_scan).
//
// Replaces: contour_context_tpu/ops/candidate.py, dynamic_pass_scan (the
// lax.scan of :290-319) and dynamic_post_scan (the lax.scan of :322-344),
// the recurrences of contour_db.h:439-458 and :532-574. There is no Pallas
// kernel behind them; the JAX package scans on the device inside its one
// dispatch. The port's plain versions (ops/kernels.dyn_pass_scan_plain,
// dyn_post_scan_plain) walk the last axis in torch.where ops.
//
// dyn_pass_scan. Inputs, for query row r: pass1 (R, H) bool and ovlp_sum,
// ovlp_max1, in_ang, indiv, orie (R, H) int32, the cascade's pass-1 flag
// and pair counts of each hint in check order; five lower bars lb and five
// upper bars ub (the working bars start at lb). Hint t passes check 2 iff
// pass1 and its first three counts reach bars 0-2, check 3 iff it passed
// check 2 and its last two reach bars 3-4; on a check-3 pass every bar
// rises to min(max(bar, orie_t), ub). Outputs pass2, pass3 (R, H) bool.
//
// dyn_post_scan. Inputs: in_use (R, C) bool and area, neg_d, corr0 (R, C)
// f32 of each candidate row in first-seen order; three lower and three
// upper float bars. Row t is kept iff in use and its three scores reach
// the bars; a kept row raises bar i to fminf(fmaxf(bar_i, score_i), ub_i).
// Output keep (R, C) bool. Comparisons, fminf and fmaxf round nothing, and
// a kept score is never NaN (a NaN fails >=), so the kernel equals the
// plain version and JAX's scan bit for bit.
//
// What bounds it on the card: the serial chain. Each row's recurrence is
// sequential, one dependent step a hint (H = 256 at the default caps) or a
// candidate (C = 64); the bytes are a few KB a row (0.002 us at 3.35
// TB/s). Design: a CTA a row; the CTA stages a chunk of the row's columns
// in shared memory with coalesced loads, one thread walks the chunk with
// the state in registers, and the CTA writes the chunk's outputs back
// coalesced. Rows run in parallel on the SMs.
//
// The pass scan's walk is cut to a compare, a max and a select a step.
// Every raise sets all five bars to min(max(bar, orie_t), ub), so once a
// hint has passed, bar i is f_i(M) = min(max(lb_i, M), ub_i) with M the
// running max of orie over the passing hints (and lb before the first
// pass, which f_i(M) is not when lb_i > ub_i). Count c meets f_i(M) iff
// c >= ub_i, or lb_i <= c and M <= c: a threshold th_i(c) on M (+inf,
// c, or -inf for never) that every thread computes for its own columns
// before the walk. A hint then passes check 2 after the first pass iff
// pass1 and M <= min(th_0..2), check 3 iff pass1 and M <= min(th_0..4);
// before it, iff its counts reach lb. The thresholds are 64-bit so that
// -inf lies below every int32 M. Integer compares only: the kernel equals
// the plain version bit for bit. The post scan raises each float bar to
// its own score, so it keeps its three bars and walks them.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kThreads = 128;

struct PassBars {
  int lb[5], ub[5];
};

struct PostBars {
  float lb[3], ub[3];
};

// th_i of count c: M <= th_i iff c >= min(max(lb, M), ub)
__device__ __forceinline__ long long bar_threshold(int c, int lb, int ub) {
  if (c >= ub) return LLONG_MAX;
  return lb <= c ? static_cast<long long>(c) : LLONG_MIN;
}

__global__ void dyn_pass_scan_kernel(const uint8_t* __restrict__ pass1,
                                     const int* __restrict__ ovlp_sum,
                                     const int* __restrict__ ovlp_max1,
                                     const int* __restrict__ in_ang,
                                     const int* __restrict__ indiv,
                                     const int* __restrict__ orie,
                                     uint8_t* __restrict__ pass2,
                                     uint8_t* __restrict__ pass3, int H,
                                     PassBars bars) {
  // a column's thresholds of checks 2 and 3 after the first pass, its
  // orie, and bit 0/1: checks 2/3 at the lower bars (pass1 included)
  __shared__ long long s_th2[kChunk], s_th3[kChunk];
  __shared__ int s_orie[kChunk];
  __shared__ uint8_t s_lb[kChunk], s_p2[kChunk], s_p3[kChunk];
  const size_t row = static_cast<size_t>(blockIdx.x) * H;
  const int* lb = bars.lb;
  const int* ub = bars.ub;
  bool raised = false;
  long long M = 0;
  for (int c0 = 0; c0 < H; c0 += kChunk) {
    const int n = H - c0 < kChunk ? H - c0 : kChunk;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const size_t at = row + c0 + i;
      const bool p1 = pass1[at] != 0;
      const int c[5] = {ovlp_sum[at], ovlp_max1[at], in_ang[at], indiv[at],
                        orie[at]};
      long long th2 = p1 ? LLONG_MAX : LLONG_MIN;
      bool lb2 = p1;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const long long th = bar_threshold(c[k], lb[k], ub[k]);
        th2 = th < th2 ? th : th2;
        lb2 = lb2 && c[k] >= lb[k];
      }
      long long th3 = th2;
      bool lb3 = lb2;
#pragma unroll
      for (int k = 3; k < 5; ++k) {
        const long long th = bar_threshold(c[k], lb[k], ub[k]);
        th3 = th < th3 ? th : th3;
        lb3 = lb3 && c[k] >= lb[k];
      }
      s_th2[i] = th2;
      s_th3[i] = th3;
      s_orie[i] = c[4];
      s_lb[i] = static_cast<uint8_t>(lb2) | (static_cast<uint8_t>(lb3) << 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // unrolled: the shared-memory loads of eight steps issue ahead of
      // their dependent chain
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const bool p2 = raised ? M <= s_th2[t] : (s_lb[t] & 1) != 0;
        const bool p3 = raised ? M <= s_th3[t] : (s_lb[t] & 2) != 0;
        if (p3) {
          const long long o = s_orie[t];
          M = raised && M > o ? M : o;
          raised = true;
        }
        s_p2[t] = p2;
        s_p3[t] = p3;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      pass2[row + c0 + i] = s_p2[i];
      pass3[row + c0 + i] = s_p3[i];
    }
    __syncthreads();
  }
}

__global__ void dyn_post_scan_kernel(const uint8_t* __restrict__ in_use,
                                     const float* __restrict__ area,
                                     const float* __restrict__ neg_d,
                                     const float* __restrict__ corr0,
                                     uint8_t* __restrict__ keep, int C,
                                     PostBars bars) {
  __shared__ float s_v[3][kChunk];
  __shared__ uint8_t s_use[kChunk], s_keep[kChunk];
  const size_t row = static_cast<size_t>(blockIdx.x) * C;
  float b0 = bars.lb[0], b1 = bars.lb[1], b2 = bars.lb[2];
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int n = C - c0 < kChunk ? C - c0 : kChunk;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const size_t at = row + c0 + i;
      s_use[i] = in_use[at];
      s_v[0][i] = area[at];
      s_v[1][i] = neg_d[at];
      s_v[2][i] = corr0[at];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const float a = s_v[0][t], d = s_v[1][t], c = s_v[2][t];
        const bool k = s_use[t] != 0 && a >= b0 && d >= b1 && c >= b2;
        if (k) {
          b0 = fminf(fmaxf(b0, a), bars.ub[0]);
          b1 = fminf(fmaxf(b1, d), bars.ub[1]);
          b2 = fminf(fmaxf(b2, c), bars.ub[2]);
        }
        s_keep[t] = k;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      keep[row + c0 + i] = s_keep[i];
    __syncthreads();
  }
}

}  // namespace

extern "C" int cc_dyn_pass_scan(const void* pass1, const void* ovlp_sum,
                                const void* ovlp_max1, const void* in_ang,
                                const void* indiv, const void* orie,
                                void* pass2, void* pass3, int rows, int H,
                                int lb0, int lb1, int lb2, int lb3, int lb4,
                                int ub0, int ub1, int ub2, int ub3, int ub4,
                                void* stream) {
  if (rows < 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || H == 0) return 0;
  const PassBars bars{{lb0, lb1, lb2, lb3, lb4}, {ub0, ub1, ub2, ub3, ub4}};
  dyn_pass_scan_kernel<<<rows, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pass1), static_cast<const int*>(ovlp_sum),
      static_cast<const int*>(ovlp_max1), static_cast<const int*>(in_ang),
      static_cast<const int*>(indiv), static_cast<const int*>(orie),
      static_cast<uint8_t*>(pass2), static_cast<uint8_t*>(pass3), H, bars);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_dyn_post_scan(const void* in_use, const void* area,
                                const void* neg_d, const void* corr0,
                                void* keep, int rows, int C, float lb0,
                                float lb1, float lb2, float ub0, float ub1,
                                float ub2, void* stream) {
  if (rows < 0 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || C == 0) return 0;
  const PostBars bars{{lb0, lb1, lb2}, {ub0, ub1, ub2}};
  dyn_post_scan_kernel<<<rows, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in_use), static_cast<const float*>(area),
      static_cast<const float*>(neg_d), static_cast<const float*>(corr0),
      static_cast<uint8_t*>(keep), C, bars);
  return static_cast<int>(cudaGetLastError());
}
