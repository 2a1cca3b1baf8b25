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
// the bars; a kept row raises bar i to min(max(bar_i, score_i), ub_i) as
// torch.minimum / torch.maximum do: a NaN upper bar gives a NaN bar (and
// nothing is kept after it). Output keep (R, C) bool.
//
// What bounds it on the card: the serial chain of each row, one dependent
// step a hint (H = 256 at the default caps) or a candidate (C = 64); the
// bytes are a few KB a row (0.002 us at 3.35 TB/s). Design: most steps
// change nothing, and the ones that do are found in parallel.
//
// - The pass scan's state is bounded. Every raise sets all five bars to
//   min(max(bar, orie_t), ub), so once a hint has passed, bar i is
//   f_i(M) = min(max(lb_i, M), ub_i) with M the running max of orie over
//   the passing hints (lb before the first pass, which f_i(M) is not when
//   lb_i > ub_i). Once M >= U = max_i ub_i every bar is ub_i, so M is
//   clamped to U: at the default bars (lb 3,3,3,3,4, ub 6) M takes at
//   most the values 4, 5 and 6. Count c meets f_i(M) iff c >= ub_i, or
//   lb_i <= c and M <= c: a threshold th_i(c) on M (INT_MAX: always; c;
//   or a "never" bit), so a hint passes check 2 after the first pass iff
//   M <= min(th_0..2) and none is never, check 3 the same over th_0..4;
//   before it, iff its counts reach lb.
// - Only a rise changes the state: a hint that passes check 3 before the
//   first pass, or after it with min(orie, U) > M (the pass scan); a kept
//   row whose raised bars differ in value from the old ones (the post
//   scan; -0.0 and +0.0 are one value, as the >= compares take them). A
//   kept row's scores reach the bars, so it raises them to min(score, ub)
//   by value whatever they were: each row's raised bars are computed
//   before the walk, and a rise hands them on.
//   Between two rises every step's output depends only on the state in
//   force, so it is computed in parallel.
//
// So a row is one warp, each lane holding K = 8 consecutive steps of a
// window of 256 in registers, loaded with 16-byte loads where the rows are
// aligned (scalar loads otherwise: rows of H = 2500 start unaligned).
// After a rise at a lane's step j0 the state is that step's own (its
// clamped orie, or its raised bars), whatever came before: so before the
// walk each lane walks its own steps after each of its j0 (the K chains
// side by side) and keeps their outputs and the state after its last step
// in tables. The walk starts at position -1 and repeats: each lane takes
// its steps after the position that would raise the state in force, its
// first such step j0 and its outputs (up to j0 under the state in force,
// after it from the table); a ballot of the lanes with a rise; none: every
// lane's outputs are right, stop; else the lanes up to the first with a
// rise keep theirs, that lane's final state is shuffled to every lane, and
// the position moves to its last step. Each lane then stores its 8 output
// bytes in one store, and the state carries to the next window. A walk
// takes one ballot round for each lane whose steps hold a rise, plus one,
// a window: at most 4 at the default bars; 33 for a row of 256 where
// every step is a rise.
//
// Why the tables: a design with one ballot round a rise, measured on the
// H100, spent ~300 clocks a round in the pass scan and ~175 in the post
// scan, and took 43.7 us on 256 rising hints and 6.9 us on 64 rising
// candidates, over the old serial kernels' 11.9 and 3.6; walking a lane's
// steps one by one in each round cost ~300 and ~490 clocks a round. The
// post scan takes 8 rows a lane too, so 64 candidates fill 8 lanes: 9
// rounds at most, where 2 a lane would take 33. Compares, fminf and fmaxf
// round nothing, so both kernels equal their plain versions (and JAX's
// scans) bit for bit.
//
// A warp a CTA: the rows share nothing, and at the main path's B <= 17
// each row's latency-bound walk gets an SM of its own; several rows a CTA
// would only help past 32 CTAs an SM (132 x 32 rows).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kLaneSteps = 8;     // hints or candidate rows a lane
constexpr int kStampSlots = 16;   // clock64 slots a row of a *_phases entry
constexpr int kRoundSlot = 15;    // ... of which this one holds the rounds

struct PassBars {
  int lb[5], ub[5];
};

struct PostBars {
  float lb[3], ub[3];
};

// the lane's steps j > lo of K (lo relative to its first step)
template <int K>
__device__ __forceinline__ unsigned after(int lo) {
  const int s = lo + 1 < 0 ? 0 : (lo + 1 > K ? K : lo + 1);
  return ((1u << K) - 1) & ~((1u << s) - 1);
}

template <int B>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};

// a lane's K values at p, n of them in the row (n <= 0: none; fill stands
// in for the missing ones). Vec: n is K or <= 0, and p is aligned to the
// load, at most 16 bytes a load.
template <int K, bool Vec, typename T>
__device__ __forceinline__ void load_lane(const T* __restrict__ p, int n,
                                          T (&v)[K], T fill) {
  constexpr int kB = sizeof(T) * K > 16 ? 16 : sizeof(T) * K;
  if (Vec) {
    if (n >= K) {
#pragma unroll
      for (int i = 0; i < K; i += kB / sizeof(T)) {
        const typename Word<kB>::type w =
            *reinterpret_cast<const typename Word<kB>::type*>(p + i);
        memcpy(v + i, &w, kB);
      }
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = fill;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = j < n ? p[j] : fill;
  }
}

// bits 0..K-1 of m as K bytes 0/1 at p, n of them in the row
template <int K, bool Vec>
__device__ __forceinline__ void store_bits(uint8_t* __restrict__ p, int n,
                                           unsigned m) {
  uint8_t v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = static_cast<uint8_t>((m >> j) & 1u);
  if (Vec) {
    if (n >= K) {
      typename Word<K>::type w;
      memcpy(&w, v, K);
      *reinterpret_cast<typename Word<K>::type*>(p) = w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < n) p[j] = v[j];
  }
}

// v[i] for 0 <= i < K, as a tree of selects on the bits of i (a register
// array indexed at run time would go to local memory)
template <int K, typename T>
__device__ __forceinline__ T pick(const T (&v)[K], int i) {
  T t[K];
#pragma unroll
  for (int j = 0; j < K; ++j) t[j] = v[j];
#pragma unroll
  for (int w = 1; w < K; w *= 2)
#pragma unroll
    for (int j = 0; j < K; j += 2 * w) t[j] = (i & w) ? t[j + w] : t[j];
  return t[0];
}

// the K bits of packed at j0, K bits for each j0
template <int K>
__device__ __forceinline__ unsigned bits_at(unsigned long long packed,
                                            int j0) {
  return static_cast<unsigned>(packed >> (K * j0)) & ((1u << K) - 1);
}

// M <= th (and not never) iff c >= min(max(lb, M), ub), for every int32 M
__device__ __forceinline__ void bar_threshold(int c, int lb, int ub, int& th,
                                              bool& never) {
  th = c >= ub ? INT_MAX : c;
  never = c < ub && c < lb;
}

template <bool Stamp>
struct Clock {
  long long t = 0;
  __device__ __forceinline__ void start() {
    if (Stamp) t = clock64();
  }
  // cycles since the last mark, added to acc
  __device__ __forceinline__ void mark(long long& acc) {
    if (Stamp) {
      const long long now = clock64();
      acc += now - t;
      t = now;
    }
  }
};

// lane 0 writes the row's cumulative phase boundaries and its rounds
template <bool Stamp>
__device__ __forceinline__ void write_stamps(long long* stamps, long long t0,
                                             const long long (&ph)[3],
                                             int rounds) {
  if (Stamp && threadIdx.x == 0) {
    long long* s = stamps + static_cast<size_t>(blockIdx.x) * kStampSlots;
    s[0] = t0;
    s[1] = t0 + ph[0];
    s[2] = s[1] + ph[1];
    s[3] = s[2] + ph[2];
    s[kRoundSlot] = rounds;
  }
}

template <bool Vec, bool Stamp>
__global__ void __launch_bounds__(32)
    dyn_pass_scan_kernel(const uint8_t* __restrict__ pass1,
                         const int* __restrict__ ovlp_sum,
                         const int* __restrict__ ovlp_max1,
                         const int* __restrict__ in_ang,
                         const int* __restrict__ indiv,
                         const int* __restrict__ orie,
                         uint8_t* __restrict__ pass2,
                         uint8_t* __restrict__ pass3, int H, PassBars bars,
                         long long* stamps) {
  constexpr int K = kLaneSteps;
  const int lane = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * H;
  int U = bars.ub[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) U = bars.ub[k] > U ? bars.ub[k] : U;
  Clock<Stamp> clk;
  clk.start();
  const long long t0 = clk.t;
  long long ph[3] = {0, 0, 0};
  int rounds = 0;
  bool raised = false;
  int M = 0;   // the clamped running max, once raised
  for (int w0 = 0; w0 < H; w0 += 32 * K) {
    const int first = w0 + K * lane;
    const int n = H - first;
    const size_t at = row + first;
    uint8_t p1[K];
    int c[5][K];
    load_lane<K, Vec>(pass1 + at, n, p1, static_cast<uint8_t>(0));
    load_lane<K, Vec>(ovlp_sum + at, n, c[0], 0);
    load_lane<K, Vec>(ovlp_max1 + at, n, c[1], 0);
    load_lane<K, Vec>(in_ang + at, n, c[2], 0);
    load_lane<K, Vec>(indiv + at, n, c[3], 0);
    load_lane<K, Vec>(orie + at, n, c[4], 0);
    // per hint: the thresholds of checks 2 and 3 after the first pass and
    // their never bits, checks 2 and 3 at the lower bars, the clamped orie
    int th2[K], th3[K], op[K];
    unsigned never2 = 0, never3 = 0, lb2m = 0, lb3m = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bool nv2 = p1[j] == 0, ok2 = p1[j] != 0;
      int t2 = INT_MAX;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        int th;
        bool nv;
        bar_threshold(c[k][j], bars.lb[k], bars.ub[k], th, nv);
        t2 = th < t2 ? th : t2;
        nv2 = nv2 || nv;
        ok2 = ok2 && c[k][j] >= bars.lb[k];
      }
      bool nv3 = nv2, ok3 = ok2;
      int t3 = t2;
#pragma unroll
      for (int k = 3; k < 5; ++k) {
        int th;
        bool nv;
        bar_threshold(c[k][j], bars.lb[k], bars.ub[k], th, nv);
        t3 = th < t3 ? th : t3;
        nv3 = nv3 || nv;
        ok3 = ok3 && c[k][j] >= bars.lb[k];
      }
      th2[j] = t2;
      th3[j] = t3;
      op[j] = c[4][j] < U ? c[4][j] : U;
      never2 |= static_cast<unsigned>(nv2) << j;
      never3 |= static_cast<unsigned>(nv3) << j;
      lb2m |= static_cast<unsigned>(ok2) << j;
      lb3m |= static_cast<unsigned>(ok3) << j;
    }
    // after a rise at its step j0 the state is op[j0], whatever came
    // before: each lane walks its own steps after each j0 (checks 2 and 3,
    // and the state after its last step), the chains side by side
    unsigned long long tail2 = 0, tail3 = 0;
    int fin[K];
#pragma unroll
    for (int j0 = 0; j0 < K; ++j0) {
      int m = op[j0];
      unsigned t2 = 0, t3 = 0;
#pragma unroll
      for (int j = j0 + 1; j < K; ++j) {
        const bool p3 = m <= th3[j] && !((never3 >> j) & 1u);
        t2 |= static_cast<unsigned>(m <= th2[j] && !((never2 >> j) & 1u))
              << j;
        t3 |= static_cast<unsigned>(p3) << j;
        m = p3 && m < op[j] ? op[j] : m;
      }
      tail2 |= static_cast<unsigned long long>(t2) << (K * j0);
      tail3 |= static_cast<unsigned long long>(t3) << (K * j0);
      fin[j0] = m;
    }
    clk.mark(ph[0]);
    unsigned out2 = 0, out3 = 0;
    int pos = -1;   // the window's hints up to pos are final
    while (true) {
      // checks 2 and 3 under the state in force, and the hints after pos
      // that would raise it
      const unsigned span = after<K>(pos - K * lane);
      unsigned s2 = lb2m, s3 = lb3m, up = lb3m;
      if (raised) {
        s2 = s3 = up = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const bool p3 = M <= th3[j];
          s2 |= static_cast<unsigned>(M <= th2[j]) << j;
          s3 |= static_cast<unsigned>(p3) << j;
          up |= static_cast<unsigned>(p3 && M < op[j]) << j;
        }
        s2 &= ~never2;
        s3 &= ~never3;
        up &= ~never3;
      }
      up &= span;
      // the lane's outputs if no lane before it rose: up to its first
      // rise j0 under the state in force, after it from its own walk
      const int j0 = __ffs(up) - 1;
      const unsigned head = up != 0 ? span & ((2u << j0) - 1) : span;
      const unsigned o2 = (s2 & head) | (up != 0 ? bits_at<K>(tail2, j0) : 0);
      const unsigned o3 = (s3 & head) | (up != 0 ? bits_at<K>(tail3, j0) : 0);
      // the first lane that rose: the lanes up to it walked from the true
      // state; the state after it is its own
      const unsigned lanes = __ballot_sync(kAll, up != 0);
      ++rounds;
      const int src = lanes == 0 ? 32 : __ffs(lanes) - 1;
      if (lane <= src) {
        out2 |= o2;
        out3 |= o3;
      }
      if (lanes == 0) break;
      M = __shfl_sync(kAll, pick(fin, j0), src);
      raised = true;
      pos = K * src + K - 1;
    }
    clk.mark(ph[1]);
    store_bits<K, Vec>(pass2 + at, n, out2);
    store_bits<K, Vec>(pass3 + at, n, out3);
    clk.mark(ph[2]);
  }
  write_stamps<Stamp>(stamps, t0, ph, rounds);
}

// the bar that a kept score s raises any bar b <= s to, by value, as
// torch.minimum(torch.maximum(b, s), ub) does: b and s are never NaN there
// (a NaN fails >=), and a NaN ub gives NaN
__device__ __forceinline__ float raised_bar(float s, float ub) {
  return ub != ub ? ub : fminf(s, ub);
}

template <bool Vec, bool Stamp>
__global__ void __launch_bounds__(32)
    dyn_post_scan_kernel(const uint8_t* __restrict__ in_use,
                         const float* __restrict__ area,
                         const float* __restrict__ neg_d,
                         const float* __restrict__ corr0,
                         uint8_t* __restrict__ keep, int C, PostBars bars,
                         long long* stamps) {
  constexpr int K = kLaneSteps;
  const int lane = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * C;
  float b0 = bars.lb[0], b1 = bars.lb[1], b2 = bars.lb[2];
  Clock<Stamp> clk;
  clk.start();
  const long long t0 = clk.t;
  long long ph[3] = {0, 0, 0};
  int rounds = 0;
  for (int w0 = 0; w0 < C; w0 += 32 * K) {
    const int first = w0 + K * lane;
    const int n = C - first;
    const size_t at = row + first;
    uint8_t use[K];
    float a[K], d[K], s[K];
    load_lane<K, Vec>(in_use + at, n, use, static_cast<uint8_t>(0));
    load_lane<K, Vec>(area + at, n, a, 0.0f);
    load_lane<K, Vec>(neg_d + at, n, d, 0.0f);
    load_lane<K, Vec>(corr0 + at, n, s, 0.0f);
    // per row: in use, and the bars its keep would raise the bars to
    unsigned used = 0;
    float na[K], nd[K], ns[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      used |= static_cast<unsigned>(use[j] != 0) << j;
      na[j] = raised_bar(a[j], bars.ub[0]);
      nd[j] = raised_bar(d[j], bars.ub[1]);
      ns[j] = raised_bar(s[j], bars.ub[2]);
    }
    // after a keep that moves the bars at its row j0 they are the row's
    // raised bars, whatever came before: each lane walks its own rows
    // after each j0 (kept or not, and the bars after its last row; a keep
    // that moves nothing sets equal bars), the chains side by side
    unsigned long long tail = 0;
    float f0[K], f1[K], f2[K];
#pragma unroll
    for (int j0 = 0; j0 < K; ++j0) {
      float c0 = na[j0], c1 = nd[j0], c2 = ns[j0];
      unsigned t = 0;
#pragma unroll
      for (int j = j0 + 1; j < K; ++j) {
        const bool k = ((used >> j) & 1u) && a[j] >= c0 && d[j] >= c1 &&
                       s[j] >= c2;
        t |= static_cast<unsigned>(k) << j;
        c0 = k ? na[j] : c0;
        c1 = k ? nd[j] : c1;
        c2 = k ? ns[j] : c2;
      }
      tail |= static_cast<unsigned long long>(t) << (K * j0);
      f0[j0] = c0;
      f1[j0] = c1;
      f2[j0] = c2;
    }
    clk.mark(ph[0]);
    unsigned out = 0;
    int pos = -1;
    while (true) {
      // kept under the bars in force, and the rows after pos that would
      // move them
      const unsigned live = used & after<K>(pos - K * lane);
      unsigned kept = 0, up = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool k = a[j] >= b0 && d[j] >= b1 && s[j] >= b2;
        const bool moves = na[j] != b0 || nd[j] != b1 || ns[j] != b2;
        kept |= static_cast<unsigned>(k) << j;
        up |= static_cast<unsigned>(k && moves) << j;
      }
      kept &= live;
      up &= live;
      const int j0 = __ffs(up) - 1;
      const unsigned head = up != 0 ? (2u << j0) - 1 : ~0u;
      const unsigned o = (kept & head) | (up != 0 ? bits_at<K>(tail, j0) : 0);
      const unsigned lanes = __ballot_sync(kAll, up != 0);
      ++rounds;
      const int src = lanes == 0 ? 32 : __ffs(lanes) - 1;
      if (lane <= src) out |= o;
      if (lanes == 0) break;
      b0 = __shfl_sync(kAll, pick(f0, j0), src);
      b1 = __shfl_sync(kAll, pick(f1, j0), src);
      b2 = __shfl_sync(kAll, pick(f2, j0), src);
      pos = K * src + K - 1;
    }
    clk.mark(ph[1]);
    store_bits<K, Vec>(keep + at, n, out);
    clk.mark(ph[2]);
  }
  write_stamps<Stamp>(stamps, t0, ph, rounds);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool Stamp>
int launch_pass(const void* pass1, const void* ovlp_sum,
                const void* ovlp_max1, const void* in_ang, const void* indiv,
                const void* orie, void* pass2, void* pass3, int rows, int H,
                const PassBars& bars, long long* stamps, void* stream) {
  if (rows < 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || H == 0) return 0;
  const bool vec = H % kLaneSteps == 0 && aligned16(pass1) &&
                   aligned16(ovlp_sum) && aligned16(ovlp_max1) &&
                   aligned16(in_ang) && aligned16(indiv) &&
                   aligned16(orie) && aligned16(pass2) && aligned16(pass3);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* p1 = static_cast<const uint8_t*>(pass1);
  const auto* c0 = static_cast<const int*>(ovlp_sum);
  const auto* c1 = static_cast<const int*>(ovlp_max1);
  const auto* c2 = static_cast<const int*>(in_ang);
  const auto* c3 = static_cast<const int*>(indiv);
  const auto* c4 = static_cast<const int*>(orie);
  auto* p2 = static_cast<uint8_t*>(pass2);
  auto* p3 = static_cast<uint8_t*>(pass3);
  if (vec)
    dyn_pass_scan_kernel<true, Stamp><<<rows, 32, 0, st>>>(
        p1, c0, c1, c2, c3, c4, p2, p3, H, bars, stamps);
  else
    dyn_pass_scan_kernel<false, Stamp><<<rows, 32, 0, st>>>(
        p1, c0, c1, c2, c3, c4, p2, p3, H, bars, stamps);
  return static_cast<int>(cudaGetLastError());
}

template <bool Stamp>
int launch_post(const void* in_use, const void* area, const void* neg_d,
                const void* corr0, void* keep, int rows, int C,
                const PostBars& bars, long long* stamps, void* stream) {
  if (rows < 0 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || C == 0) return 0;
  const bool vec = C % kLaneSteps == 0 && aligned16(in_use) &&
                   aligned16(area) && aligned16(neg_d) && aligned16(corr0) &&
                   aligned16(keep);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* u = static_cast<const uint8_t*>(in_use);
  const auto* a = static_cast<const float*>(area);
  const auto* d = static_cast<const float*>(neg_d);
  const auto* s = static_cast<const float*>(corr0);
  auto* k = static_cast<uint8_t*>(keep);
  if (vec)
    dyn_post_scan_kernel<true, Stamp><<<rows, 32, 0, st>>>(
        u, a, d, s, k, C, bars, stamps);
  else
    dyn_post_scan_kernel<false, Stamp><<<rows, 32, 0, st>>>(
        u, a, d, s, k, C, bars, stamps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cc_dyn_pass_scan(const void* pass1, const void* ovlp_sum,
                                const void* ovlp_max1, const void* in_ang,
                                const void* indiv, const void* orie,
                                void* pass2, void* pass3, int rows, int H,
                                int lb0, int lb1, int lb2, int lb3, int lb4,
                                int ub0, int ub1, int ub2, int ub3, int ub4,
                                void* stream) {
  const PassBars bars{{lb0, lb1, lb2, lb3, lb4}, {ub0, ub1, ub2, ub3, ub4}};
  return launch_pass<false>(pass1, ovlp_sum, ovlp_max1, in_ang, indiv, orie,
                            pass2, pass3, rows, H, bars, nullptr, stream);
}

extern "C" int cc_dyn_post_scan(const void* in_use, const void* area,
                                const void* neg_d, const void* corr0,
                                void* keep, int rows, int C, float lb0,
                                float lb1, float lb2, float ub0, float ub1,
                                float ub2, void* stream) {
  const PostBars bars{{lb0, lb1, lb2}, {ub0, ub1, ub2}};
  return launch_post<false>(in_use, area, neg_d, corr0, keep, rows, C, bars,
                            nullptr, stream);
}

// Measurement only (kernel_times.dyn_phase_split; the main path never
// calls them): the same kernels with lane 0 of each row's warp writing the
// row's phase boundaries (clock64, each phase summed over the windows)
// into stamps[row * 16 + i], i = 0 .. 3, and its ballot rounds into
// stamps[row * 16 + 15].
extern "C" int cc_dyn_pass_scan_phases(
    const void* pass1, const void* ovlp_sum, const void* ovlp_max1,
    const void* in_ang, const void* indiv, const void* orie, void* pass2,
    void* pass3, int rows, int H, int lb0, int lb1, int lb2, int lb3,
    int lb4, int ub0, int ub1, int ub2, int ub3, int ub4, void* stamps,
    void* stream) {
  const PassBars bars{{lb0, lb1, lb2, lb3, lb4}, {ub0, ub1, ub2, ub3, ub4}};
  return launch_pass<true>(pass1, ovlp_sum, ovlp_max1, in_ang, indiv, orie,
                           pass2, pass3, rows, H, bars,
                           static_cast<long long*>(stamps), stream);
}

extern "C" int cc_dyn_post_scan_phases(const void* in_use, const void* area,
                                       const void* neg_d, const void* corr0,
                                       void* keep, int rows, int C,
                                       float lb0, float lb1, float lb2,
                                       float ub0, float ub1, float ub2,
                                       void* stamps, void* stream) {
  const PostBars bars{{lb0, lb1, lb2}, {ub0, ub1, ub2}};
  return launch_post<true>(in_use, area, neg_d, corr0, keep, rows, C, bars,
                           static_cast<long long*>(stamps), stream);
}

extern "C" const char* cc_dyn_pass_scan_phase_names() {
  return "load and tables,walk,write";
}

extern "C" const char* cc_dyn_post_scan_phase_names() {
  return "load and tables,walk,write";
}

extern "C" int cc_dyn_round_slot() { return kRoundSlot; }
