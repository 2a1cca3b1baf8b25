// The proposal merge's sequential loop (addProposal, hint by hint), for B
// queries in one launch, its trip count read on the device.
//
// Replaces: contour_context_tpu/ops/candidate.py, merge_proposals' proposal
// loop (the lax.while_loop up to its trip count, :234). There is no Pallas
// kernel behind it; the JAX package runs the loop on the device with no
// host round trip, and the port's plain version
// (ops/kernels.merge_hints_plain) reads its trip count on the host.
//
// Inputs, for query b: hint_of[b, c, j] (B, C, MP) int32, the hint m that
// arrives j-th at candidate row c (-1 past the row's last hint), T[b, m]
// (B, MP, 3) f32 the hint's pose (x, y, theta) and votes[b, m] (B, MP) its
// pair count. Each row c runs addProposal over its hints in arrival order:
// a hint merges into the first of the row's P_PROP = 4 proposals within
// (trans_merge, ang_merge) of it (the vote-weighted mean pose), else opens a
// new proposal while fewer than 4 are in use, else is dropped. Outputs:
// prop_T (B, C, 4, 3), prop_votes (B, C, 4), prop_n (B, C) and key_of_m
// (B, MP), the proposal c * 4 + slot each hint went to (-1: none).
//
// What bounds it on the card: nothing the card is short of. At the default
// caps (C = 64 rows, MP = 128 hints) a block of 16 queries reads 16 x 64 x
// 128 hint slots and 16 x 128 poses and votes and writes the proposals
// (635 KB in all): 0.19 us by bytes. Each row's walk is sequential (one
// dependent step of a few dozen flops a hint, 10-20 hints in the smoke's
// busiest rows), so the floor is one thread's latency through its row.
//
// Design. Rows never interact (each hint belongs to one row, so no two
// threads write one key_of_m slot), so one thread takes one (query, row):
// a CTA a query, one thread a row, the row's proposals in registers. The
// CTA stages its query's poses and votes in shared memory (16 bytes a
// hint), and a thread reads its row's hint ids four at a time, the next
// four in flight, until the first -1 (a row's hints arrive with no gap),
// so a step of the walk waits on no device-memory load. The
// arithmetic repeats the plain loop's torch expressions on the card op for
// op, each op rounded on its own (__f*_rn: no FMA contraction, no
// fast-math): c*dx + s*dy is two rounded products and a rounded add; cosf,
// sinf, hypotf and floorf are the CUDA math library's, as torch's CUDA
// kernels call them for f32; a division by a host scalar is torch's
// product with the float reciprocal (inv_two_pi); the one-hot sums of the
// old proposal add +0.0, which turns -0.0 into +0.0 as the sum does; the
// first match is the lowest slot (argmax order). So the kernel equals the
// plain loop run on the card bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kProp = 4;

struct Consts {
  float pi, two_pi, inv_two_pi, trans_merge, ang_merge;
};

// cascade.clamp_ang: a - floor((a + pi) / (2 pi)) * (2 pi), the division
// by the host scalar 2 pi being a product with its float reciprocal
__device__ __forceinline__ float clamp_ang(float a, const Consts& k) {
  const float f = floorf(__fmul_rn(__fadd_rn(a, k.pi), k.inv_two_pi));
  return __fsub_rn(a, __fmul_rn(f, k.two_pi));
}

// Row c's j-th hint, j = 0, 1, ...: with Vec (MP % 4 == 0 and a 16-byte
// aligned base, which the launcher checks) four at a time in one 16-byte
// load, the next four loaded while the current ones are merged.
template <bool Vec>
struct HintRow {
  const int* h;
  int4 cur, next;
  __device__ HintRow(const int* row, int MP) : h(row) {
    if (Vec) {
      cur = reinterpret_cast<const int4*>(h)[0];
      next = MP > 4 ? reinterpret_cast<const int4*>(h)[1]
                    : make_int4(-1, -1, -1, -1);
    }
  }
  __device__ __forceinline__ int at(int j, int MP) {
    if (!Vec) return h[j];
    if ((j & 3) == 0 && j > 0) {
      cur = next;
      next = j + 4 < MP ? reinterpret_cast<const int4*>(h)[(j >> 2) + 1]
                        : make_int4(-1, -1, -1, -1);
    }
    switch (j & 3) {
      case 0: return cur.x;
      case 1: return cur.y;
      case 2: return cur.z;
      default: return cur.w;
    }
  }
};

template <bool Vec>
__global__ void merge_hints_kernel(const int* __restrict__ hint_of,
                                   const float* __restrict__ T,
                                   const int* __restrict__ votes,
                                   float* __restrict__ prop_T,
                                   int* __restrict__ prop_votes,
                                   int* __restrict__ prop_n,
                                   int* __restrict__ key_of_m, int C, int MP,
                                   Consts k) {
  // the query's hint poses and votes, staged in shared memory
  extern __shared__ float sT[];
  int* sv = reinterpret_cast<int*>(sT + 3 * MP);
  const int b = blockIdx.x;
  int* kb = key_of_m + static_cast<size_t>(b) * MP;
  for (int i = threadIdx.x; i < 3 * MP; i += blockDim.x)
    sT[i] = T[static_cast<size_t>(b) * MP * 3 + i];
  for (int m = threadIdx.x; m < MP; m += blockDim.x) {
    sv[m] = votes[static_cast<size_t>(b) * MP + m];
    kb[m] = -1;
  }
  __syncthreads();

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float px[kProp], py[kProp], pt[kProp];
    int pv[kProp];
#pragma unroll
    for (int s = 0; s < kProp; ++s) {
      px[s] = py[s] = pt[s] = 0.0f;
      pv[s] = 0;
    }
    int n = 0;
    // a row's hints arrive at j = 0, 1, ... with no gap: -1 ends the row
    HintRow<Vec> hints(hint_of + (static_cast<size_t>(b) * C + c) * MP, MP);
    for (int j = 0; j < MP; ++j) {
      const int m = hints.at(j, MP);
      if (m < 0) break;
      const float x = sT[m * 3 + 0], y = sT[m * 3 + 1], th = sT[m * 3 + 2];
      const int w2 = sv[m];
      const float cm = cosf(th), sm = sinf(th);
      int first = -1;
#pragma unroll
      for (int s = kProp - 1; s >= 0; --s) {
        const float dx = __fsub_rn(px[s], x);
        const float dy = __fsub_rn(py[s], y);
        const float tx = __fadd_rn(__fmul_rn(cm, dx), __fmul_rn(sm, dy));
        const float ty = __fadd_rn(__fmul_rn(-sm, dx), __fmul_rn(cm, dy));
        const float dth = clamp_ang(__fsub_rn(pt[s], th), k);
        if (s < n && hypotf(tx, ty) < k.trans_merge &&
            fabsf(dth) < k.ang_merge)
          first = s;
      }
      const bool has_match = first >= 0;
      if (!has_match && n >= kProp) continue;      // dropped: no write
      const int slot = has_match ? first : n;
      float ox = 0.0f, oy = 0.0f, ot = 0.0f;
      int w1 = 0;
#pragma unroll
      for (int s = 0; s < kProp; ++s) {
        if (s == slot) {
          ox = px[s];
          oy = py[s];
          ot = pt[s];
          w1 = pv[s];
        }
      }
      float nx = x, ny = y, nt = th;
      int nv = w2;
      if (has_match) {
        // the one-hot sums: +0.0 added to the old value
        ox = __fadd_rn(ox, 0.0f);
        oy = __fadd_rn(oy, 0.0f);
        ot = __fadd_rn(ot, 0.0f);
        const int ws = w1 + w2 > 1 ? w1 + w2 : 1;
        const float wsum = static_cast<float>(ws);
        const float f1 = static_cast<float>(w1), f2 = static_cast<float>(w2);
        nx = __fdiv_rn(__fadd_rn(__fmul_rn(ox, f1), __fmul_rn(x, f2)), wsum);
        ny = __fdiv_rn(__fadd_rn(__fmul_rn(oy, f1), __fmul_rn(y, f2)), wsum);
        float diff = __fsub_rn(th, ot);
        if (diff < 0.0f) diff = __fadd_rn(diff, k.two_pi);
        if (diff > k.pi) diff = __fsub_rn(diff, k.two_pi);
        nt = __fadd_rn(__fdiv_rn(__fmul_rn(diff, f2), wsum), ot);
        nv = w1 + w2;
      }
#pragma unroll
      for (int s = 0; s < kProp; ++s) {
        if (s == slot) {
          px[s] = nx;
          py[s] = ny;
          pt[s] = nt;
          pv[s] = nv;
        }
      }
      if (!has_match) ++n;
      kb[m] = c * kProp + slot;
    }
    const size_t row = static_cast<size_t>(b) * C + c;
#pragma unroll
    for (int s = 0; s < kProp; ++s) {
      prop_T[(row * kProp + s) * 3 + 0] = px[s];
      prop_T[(row * kProp + s) * 3 + 1] = py[s];
      prop_T[(row * kProp + s) * 3 + 2] = pt[s];
      prop_votes[row * kProp + s] = pv[s];
    }
    prop_n[row] = n;
  }
}

}  // namespace

extern "C" int cc_merge_hints(const void* hint_of, const void* T,
                              const void* votes, void* prop_T,
                              void* prop_votes, void* prop_n, void* key_of_m,
                              int n_queries, int n_rows, int n_hints,
                              float pi, float two_pi, float inv_two_pi,
                              float trans_merge, float ang_merge,
                              void* stream) {
  if (n_queries < 0 || n_rows < 0 || n_hints < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_queries == 0) return 0;
  if (n_hints > 2048) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((n_rows > n_hints ? n_rows : n_hints) + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const Consts k{pi, two_pi, inv_two_pi, trans_merge, ang_merge};
  const size_t smem = static_cast<size_t>(n_hints) * 16;   // 3 f32 + 1 i32
  const bool vec = n_hints % 4 == 0 && n_hints > 0 &&
                   reinterpret_cast<size_t>(hint_of) % 16 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const int*>(hint_of);
  const auto* t = static_cast<const float*>(T);
  const auto* v = static_cast<const int*>(votes);
  auto* pT = static_cast<float*>(prop_T);
  auto* pv = static_cast<int*>(prop_votes);
  auto* pn = static_cast<int*>(prop_n);
  auto* km = static_cast<int*>(key_of_m);
  if (vec)
    merge_hints_kernel<true><<<n_queries, threads, smem, st>>>(
        h, t, v, pT, pv, pn, km, n_rows, n_hints, k);
  else
    merge_hints_kernel<false><<<n_queries, threads, smem, st>>>(
        h, t, v, pT, pv, pn, km, n_rows, n_hints, k);
  return static_cast<int>(cudaGetLastError());
}
