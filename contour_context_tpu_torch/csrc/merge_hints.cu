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
// (635 KB in all): 0.19 us by bytes. Each row's walk is sequential, so the
// floor is the longest row's serial chain: its hints (10-20 in the smoke's
// busiest rows) times the dependent steps of one hint (26 as the source
// writes them, kernel_times.MERGE_CHAIN_STEPS), a few hundred clocks;
// whatever a step does that does not depend on the step before (the
// hint's own trigonometry, its loads) belongs off that chain.
//
// Design. Rows never interact (each hint belongs to one row, so no two
// threads write one key_of_m slot), so one thread takes one (query, row):
// a CTA a query, one thread a row, the row's proposals in registers. The
// CTA has max(C, MP) threads rounded up to a warp, at most 256, so at the
// default caps (64 rows) and at any C <= 256 every row has its own thread
// and all walks start at once: the limit of a longest-first order (the
// kernel's time is its longest row's walk whatever the order), which
// would only matter if a thread took two rows (C > 256).
//   - Prologue: each thread issues its row's first two 16-byte loads of
//     hint ids before staging, so their latency overlaps the staging and
//     its barrier.
//   - Staging: a thread a hint loads (x, y, theta) and votes and computes
//     cosf(theta) and sinf(theta) once, keeping (x, y, cos, sin) and
//     (theta, votes) in shared memory (24 bytes a hint): the hint-only
//     work is off every row's serial chain. These are the calls the walk
//     made before, on the same inputs, so the bits are the same.
//   - Walk: the next hint's id comes from registers (four a 16-byte load,
//     the next four in flight) and its staged values are loaded while the
//     current hint is merged. The four slots' tests run side by side with
//     no branch between them: the radius test hypotf(tx, ty) < trans_merge
//     is decided by the squared norm q = tx*tx + ty*ty (three roundings,
//     so within 2^-22 of the exact sum of squares) wherever q lies more
//     than 2^-16 of trans_merge^2 from it; there the exact norm is some
//     2^-17 of the radius (~60 ulp) away, and hypotf, whose error is a few
//     ulp, decides the same. Only when a slot's q falls in that band, or
//     is NaN, does the step call hypotf for the four slots. A step's
//     outcome (match, open or drop) is made with selects: the merged pose
//     is computed for every hint and chosen by has_match, the slot written
//     by a predicated select, so the lanes of a warp take one path and
//     differ only in trip count. The three divisions by the summed votes
//     share one reciprocal in double precision and round as IEEE division
//     rounds (divide3): one block where three __fdiv_rn had a slow-path
//     branch each. At most 256 threads a CTA leave the walk the registers
//     it needs (a 1024-thread bound caps them at 64 and spills).
// The arithmetic repeats the plain loop's torch expressions on the card op
// for op, each op rounded on its own (__f*_rn: no FMA contraction, no
// fast-math): c*dx + s*dy is two rounded products and a rounded add; cosf,
// sinf, hypotf and floorf are the CUDA math library's, as torch's CUDA
// kernels call them for f32; a division by a host scalar is torch's
// product with the float reciprocal (inv_two_pi); the one-hot sums of the
// old proposal add +0.0, which turns -0.0 into +0.0 as the sum does; the
// first match is the lowest slot (argmax order). So the kernel equals the
// plain loop run on the card bit for bit.
//
// Launch requirements: MP <= 2048 (24 * MP bytes of shared memory, within
// the 48 KB a CTA gets without an opt-in), at most 256 threads a CTA (rows
// and hints past 256 loop), B CTAs.

#include <cuda_runtime.h>

namespace {

constexpr int kProp = 4;
constexpr int kStampSlots = 16;

constexpr int kMaxThreads = 256;   // rows past 256 loop (not at the caps)

struct Consts {
  float pi, two_pi, inv_two_pi, trans_merge, ang_merge;
  // trans_merge^2 (1 -+ 2^-16): a squared norm below r2_lo passes the
  // radius test, one above r2_hi fails it, whatever hypotf rounds to
  float r2_lo, r2_hi;
};

Consts make_consts(float pi, float two_pi, float inv_two_pi,
                   float trans_merge, float ang_merge) {
  const double r2 = static_cast<double>(trans_merge) * trans_merge;
  return Consts{pi, two_pi, inv_two_pi, trans_merge, ang_merge,
                static_cast<float>(r2 * (1.0 - 1.0 / 65536)),
                static_cast<float>(r2 * (1.0 + 1.0 / 65536))};
}

template <bool Stamp>
__device__ __forceinline__ void stamp(long long* stamps, int i) {
  if (Stamp && threadIdx.x == 0)
    stamps[static_cast<size_t>(blockIdx.x) * kStampSlots + i] = clock64();
}

// cascade.clamp_ang: a - floor((a + pi) / (2 pi)) * (2 pi), the division
// by the host scalar 2 pi being a product with its float reciprocal
__device__ __forceinline__ float clamp_ang(float a, const Consts& k) {
  const float f = floorf(__fmul_rn(__fadd_rn(a, k.pi), k.inv_two_pi));
  return __fsub_rn(a, __fmul_rn(f, k.two_pi));
}

// a / d, b / d and c / d rounded as __fdiv_rn rounds them (correctly),
// for d a float holding a positive integer, with one reciprocal: in double,
// r = 1 / d and a * r are each rounded once, so a * r lies within 2^-51.9
// of a / d (relatively). A normal quotient a / d that is no float lies at
// least 2^-49 of its size from every midpoint between two floats (a
// midpoint has 25 significant bits, a a float's 24 and d's odd part at
// most 24, so a / d cannot be one, and a - m d is a multiple of a power of
// two that bounds it away), so rounding a * r to float gives the float
// nearest a / d. A quotient under 2^-126 (none on the main path) takes
// __fdiv_rn itself.
__device__ __forceinline__ void divide3(float a, float b, float c, float d,
                                        float& qa, float& qb, float& qc) {
  const double r = __drcp_rn(static_cast<double>(d));
  const double da = __dmul_rn(static_cast<double>(a), r);
  const double db = __dmul_rn(static_cast<double>(b), r);
  const double dc = __dmul_rn(static_cast<double>(c), r);
  const auto tiny = [](double q) { return q != 0.0 && fabs(q) < 0x1p-126; };
  if (tiny(da) | tiny(db) | tiny(dc)) {
    qa = __fdiv_rn(a, d);
    qb = __fdiv_rn(b, d);
    qc = __fdiv_rn(c, d);
  } else {
    qa = __double2float_rn(da);
    qb = __double2float_rn(db);
    qc = __double2float_rn(dc);
  }
}

// Row c's j-th hint, j = 0, 1, ...: with Vec (MP % 4 == 0 and a 16-byte
// aligned base, which the launcher checks) four at a time in one 16-byte
// load, the next four loaded while the current ones are merged; the
// constructor issues the first two loads.
template <bool Vec>
struct HintRow {
  const int* h;
  int4 cur, next;
  __device__ HintRow(const int* row, int MP) : h(row) {
    if (Vec && row != nullptr) {
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

// One row's walk: its proposals in registers, its hints in arrival order.
template <bool Vec>
__device__ __forceinline__ void walk_row(HintRow<Vec>& hints,
                                         const float4* __restrict__ sH,
                                         const float2* __restrict__ sA,
                                         int* kb, float* prop_T,
                                         int* prop_votes, int* prop_n,
                                         size_t row, int c, int MP,
                                         const Consts& k) {
  float px[kProp], py[kProp], pt[kProp];
  int pv[kProp];
#pragma unroll
  for (int s = 0; s < kProp; ++s) {
    px[s] = py[s] = pt[s] = 0.0f;
    pv[s] = 0;
  }
  int n = 0;
  // a row's hints arrive at j = 0, 1, ... with no gap: -1 ends the row
  int m = MP > 0 ? hints.at(0, MP) : -1;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  float2 a = make_float2(0.f, 0.f);
  if (m >= 0) {
    h = sH[m];
    a = sA[m];
  }
  for (int j = 1; m >= 0; ++j) {
    // the next hint's id and staged values, loaded while this one merges
    const int mn = j < MP ? hints.at(j, MP) : -1;
    float4 hn = h;
    float2 an = a;
    if (mn >= 0) {
      hn = sH[mn];
      an = sA[mn];
    }
    const float x = h.x, y = h.y, cm = h.z, sm = h.w, th = a.x;
    const int w2 = __float_as_int(a.y);
    // the four slots' tests side by side, with no branch between them: the
    // radius test is decided by the squared norm (three roundings: within
    // 2^-22 of tx^2 + ty^2) where that lies 2^-16 clear of the radius
    // squared, far beyond hypotf's few ulp, so hypotf would decide the
    // same; only a norm within that band (or a NaN) asks hypotf itself
    float tx[kProp], ty[kProp];
    bool near[kProp], ang[kProp], unsure = false;
#pragma unroll
    for (int s = 0; s < kProp; ++s) {
      const float dx = __fsub_rn(px[s], x);
      const float dy = __fsub_rn(py[s], y);
      tx[s] = __fadd_rn(__fmul_rn(cm, dx), __fmul_rn(sm, dy));
      ty[s] = __fadd_rn(__fmul_rn(-sm, dx), __fmul_rn(cm, dy));
      const float q = __fadd_rn(__fmul_rn(tx[s], tx[s]),
                                __fmul_rn(ty[s], ty[s]));
      near[s] = q < k.r2_lo;
      unsure |= !(q < k.r2_lo) && !(q > k.r2_hi);
      ang[s] = fabsf(clamp_ang(__fsub_rn(pt[s], th), k)) < k.ang_merge;
    }
    if (unsure) {
#pragma unroll
      for (int s = 0; s < kProp; ++s)
        near[s] = hypotf(tx[s], ty[s]) < k.trans_merge;
    }
    int first = kProp;
#pragma unroll
    for (int s = kProp - 1; s >= 0; --s)
      first = (s < n) & near[s] & ang[s] ? s : first;
    const bool has_match = first < kProp;
    const bool write = has_match || n < kProp;   // else dropped: no write
    const int slot = has_match ? first : n;
    float ox = 0.0f, oy = 0.0f, ot = 0.0f;
    int w1 = 0;
#pragma unroll
    for (int s = 0; s < kProp; ++s) {
      const bool at = s == slot;
      ox = at ? px[s] : ox;
      oy = at ? py[s] : oy;
      ot = at ? pt[s] : ot;
      w1 = at ? pv[s] : w1;
    }
    // the merged pose, computed for every hint and kept on a match; the
    // one-hot sums: +0.0 added to the old value
    ox = __fadd_rn(ox, 0.0f);
    oy = __fadd_rn(oy, 0.0f);
    ot = __fadd_rn(ot, 0.0f);
    const int ws = w1 + w2 > 1 ? w1 + w2 : 1;
    const float wsum = static_cast<float>(ws);
    const float f1 = static_cast<float>(w1), f2 = static_cast<float>(w2);
    const float nx_ = __fadd_rn(__fmul_rn(ox, f1), __fmul_rn(x, f2));
    const float ny_ = __fadd_rn(__fmul_rn(oy, f1), __fmul_rn(y, f2));
    float diff = __fsub_rn(th, ot);
    diff = diff < 0.0f ? __fadd_rn(diff, k.two_pi) : diff;
    diff = diff > k.pi ? __fsub_rn(diff, k.two_pi) : diff;
    const float nt_ = __fmul_rn(diff, f2);
    float qx, qy, qt;
    divide3(nx_, ny_, nt_, wsum, qx, qy, qt);
    const float mx = qx, my = qy;
    const float mt = __fadd_rn(qt, ot);
    const float nx = has_match ? mx : x, ny = has_match ? my : y;
    const float nt = has_match ? mt : th;
    const int nv = has_match ? w1 + w2 : w2;
#pragma unroll
    for (int s = 0; s < kProp; ++s) {
      const bool at = write && s == slot;
      px[s] = at ? nx : px[s];
      py[s] = at ? ny : py[s];
      pt[s] = at ? nt : pt[s];
      pv[s] = at ? nv : pv[s];
    }
    n += write && !has_match;
    if (write) kb[m] = c * kProp + slot;
    m = mn;
    h = hn;
    a = an;
  }
#pragma unroll
  for (int s = 0; s < kProp; ++s) {
    prop_T[(row * kProp + s) * 3 + 0] = px[s];
    prop_T[(row * kProp + s) * 3 + 1] = py[s];
    prop_T[(row * kProp + s) * 3 + 2] = pt[s];
    prop_votes[row * kProp + s] = pv[s];
  }
  prop_n[row] = n;
}

template <bool Vec, bool Stamp>
__global__ void __launch_bounds__(kMaxThreads)
    merge_hints_kernel(const int* __restrict__ hint_of,
                       const float* __restrict__ T,
                       const int* __restrict__ votes,
                       float* __restrict__ prop_T,
                       int* __restrict__ prop_votes, int* __restrict__ prop_n,
                       int* __restrict__ key_of_m, int C, int MP, Consts k,
                       long long* stamps) {
  stamp<Stamp>(stamps, 0);
  // the query's hints: (x, y, cos, sin) and (theta, votes as bits)
  extern __shared__ float4 sH[];
  float2* sA = reinterpret_cast<float2*>(sH + MP);
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int* rows = hint_of + static_cast<size_t>(b) * C * MP;
  int* kb = key_of_m + static_cast<size_t>(b) * MP;
  // the first row's first ids, in flight through the staging
  HintRow<Vec> hints(t < C ? rows + static_cast<size_t>(t) * MP : nullptr,
                     MP);
  for (int m = t; m < MP; m += blockDim.x) {
    const float* Tm = T + (static_cast<size_t>(b) * MP + m) * 3;
    const float x = Tm[0], y = Tm[1], th = Tm[2];
    const int v = votes[static_cast<size_t>(b) * MP + m];
    const float cm = cosf(th), sm = sinf(th);
    sH[m] = make_float4(x, y, cm, sm);
    sA[m] = make_float2(th, __int_as_float(v));
    kb[m] = -1;
  }
  __syncthreads();
  stamp<Stamp>(stamps, 1);

  for (int c = t; c < C; c += blockDim.x) {
    if (c != t) hints = HintRow<Vec>(rows + static_cast<size_t>(c) * MP, MP);
    walk_row<Vec>(hints, sH, sA, kb, prop_T, prop_votes, prop_n,
                  static_cast<size_t>(b) * C + c, c, MP, k);
  }
  if (Stamp) {
    __syncthreads();
    stamp<Stamp>(stamps, 2);
  }
}

template <bool Stamp>
int launch_merge(const void* hint_of, const void* T, const void* votes,
                 void* prop_T, void* prop_votes, void* prop_n,
                 void* key_of_m, int n_queries, int n_rows, int n_hints,
                 const Consts& k, long long* stamps, void* stream) {
  if (n_queries < 0 || n_rows < 0 || n_hints < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_queries == 0) return 0;
  if (n_hints > 2048) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((n_rows > n_hints ? n_rows : n_hints) + 31) / 32 * 32;
  threads = threads < 32 ? 32
                         : (threads > kMaxThreads ? kMaxThreads : threads);
  const size_t smem = static_cast<size_t>(n_hints) * 24;   // float4 + float2
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
    merge_hints_kernel<true, Stamp><<<n_queries, threads, smem, st>>>(
        h, t, v, pT, pv, pn, km, n_rows, n_hints, k, stamps);
  else
    merge_hints_kernel<false, Stamp><<<n_queries, threads, smem, st>>>(
        h, t, v, pT, pv, pn, km, n_rows, n_hints, k, stamps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cc_merge_hints(const void* hint_of, const void* T,
                              const void* votes, void* prop_T,
                              void* prop_votes, void* prop_n, void* key_of_m,
                              int n_queries, int n_rows, int n_hints,
                              float pi, float two_pi, float inv_two_pi,
                              float trans_merge, float ang_merge,
                              void* stream) {
  const Consts k = make_consts(pi, two_pi, inv_two_pi, trans_merge,
                               ang_merge);
  return launch_merge<false>(hint_of, T, votes, prop_T, prop_votes, prop_n,
                             key_of_m, n_queries, n_rows, n_hints, k, nullptr,
                             stream);
}

// Measurement only (kernel_times.merge_phase_split; the main path never
// calls it): the same kernel with thread 0 of each CTA writing clock64() at
// each phase boundary into stamps[cta * 16 + i], i = 0 .. the number of
// phases.
extern "C" int cc_merge_hints_phases(const void* hint_of, const void* T,
                                     const void* votes, void* prop_T,
                                     void* prop_votes, void* prop_n,
                                     void* key_of_m, int n_queries,
                                     int n_rows, int n_hints, float pi,
                                     float two_pi, float inv_two_pi,
                                     float trans_merge, float ang_merge,
                                     void* stamps, void* stream) {
  const Consts k = make_consts(pi, two_pi, inv_two_pi, trans_merge,
                               ang_merge);
  return launch_merge<true>(hint_of, T, votes, prop_T, prop_votes, prop_n,
                            key_of_m, n_queries, n_rows, n_hints, k,
                            static_cast<long long*>(stamps), stream);
}

extern "C" const char* cc_merge_hints_phase_names() {
  return "staging,walk";
}
