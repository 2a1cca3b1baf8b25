// The check cascade: checks 1-3 and the Umeyama SE(2) fit of every hint row
// of every query of a call in one launch.
//
// Replaces: contour_context_tpu/ops/cascade.py, run_cascade (:98) and the
// per-hint gathers of contour_context_tpu/db.py's _gather_and_cascade_impl
// and _cascade_chunked. There is no Pallas kernel behind it; XLA fuses the
// JAX body on the device. The port's plain twin (ops/cascade.run_cascade,
// the CPU path) is the torch body that ran on the card before this kernel,
// ~800 small device operations a stream step, with its Umeyama sums written
// in this kernel's order.
//
// Inputs: the store's and the queries' neighbour tables (nei_valid, level,
// seq, bit, theta: (rows, L, A, M), M <= 40) and packed check-3 tables
// (tab12: (rows, L12, J, 12)); for each hint row its candidate gidx, level,
// seq_src, seq_tgt and hint_valid, and its query: tgt_q[r], or r / cols
// when the rows are a (B, cols) grid. With n_valid, row (b, c) of the grid
// at c >= ceil(n_valid[b] / W) * W is written as zeros and not computed
// (the columns JAX's chunk loop never reaches). Outputs: the 16 fields of
// CascadeResult for every row.
//
// What bounds it on the card: latency, not bytes or operations. A row reads
// ~4.5 KB once (two 40-slot neighbour rows, two tab12 rows for each of its
// 64 constellation slots) and does ~20k compares at most; the stream's 256
// rows are ~1 MB and a few MOPs, a few us by either. Each row is a chain of
// dependent stages (close pairs -> their sorted order -> the window counts
// -> the window's members -> check 3 -> the shaft -> the orientation
// screen -> two rounds of sums), and the rows are independent.
//
// Design. A CTA a row, kThreads = 128 threads, nothing in global memory
// between the stages:
//   - The row's two neighbour rows go to shared memory (a thread a slot);
//     check 1 reads the two anchor tab12 rows straight from global memory.
//   - The 256-bit BCI masks are eight 32-bit words a side; the three
//     overlaps are popcounts of the words, shifted by one bit for the
//     neighbouring bins.
//   - The close pairs (|bit_s - bit_t| <= 1, both valid) are compacted by
//     warp ballots into a list of 64-bit keys (orderable float bits of the
//     angle, then the flat index tgt * M + src); a pair's rank is the count
//     of smaller keys, which is its place in torch.sort(stable=True) of the
//     angles (values first, ties by flat index; the inf of the other pairs
//     and any NaN after every finite one). Only the first min(p_pot, M*M)
//     places are kept. With no finite pair, the window reads the first
//     sorted slot, the lowest flat index of a pair that is not close.
//   - The circular window counts: each kept pair binary-searches the sorted
//     angles for its window's end and for the wrapped end; the longest
//     window and its first start come from one shared atomicMax of
//     (count << 16 | 0xFFFF - start).
//   - The 64 constellation slots, a thread each: the window's members (63)
//     and the anchor pair, their tab12 rows, check 3, the compacted order
//     (a count of the slots before each), the shaft's candidates (the first
//     10 compacted slots, a pair a thread, the winner by atomicMax/Min of
//     the iteration rank), the orientation screen, and the Umeyama sums:
//     each sum over the 64 slots is x[p] + x[p + 32] in lane p of warp 0,
//     then a shuffle tree (16, 8, 4, 2, 1) and + 0.0, the order the twin's
//     `_slot_sum` adds in.
// The arithmetic repeats the twin's torch expressions op for op, each op
// rounded on its own (__f*_rn: no FMA contraction, no fast math): acosf,
// atan2f, cosf, sinf and floorf are the CUDA math library's, as torch's
// CUDA kernels call them for f32; torch.maximum and torch.clamp keep a NaN;
// a division by a host scalar is torch's product with the float
// reciprocal (clamp_ang's 2 pi); each scalar of a comparison is the float32
// rounding of the double torch takes it from. So the kernel equals the twin
// run on the card bit for bit.
//
// Launch requirements: M <= 40, 1 <= p_pot <= 512, rows < 2^31, kThreads
// threads a CTA, a CTA a row; ~24 KB of static shared memory.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxM = 40;                  // 4 bins x dist_firsts <= 10
constexpr int kMaxPairs = kMaxM * kMaxM;
constexpr int kPotMax = 512;               // cascade.P_POT
constexpr int kSlots = 64;                 // cascade.P_MAX
constexpr int kShaftTop = 10;              // cascade.SHAFT_TOP
constexpr int kTab = 12;                   // tab12 channels
constexpr int kBig = 1 << 20;
constexpr unsigned kFull = 0xffffffffu;

// the float32 roundings of the Python doubles the twin uses (math.pi,
// 2 * math.pi, ANG_RANGE = math.pi / 16, math.pi / 6)
constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kTwoPi = static_cast<float>(2 * kPiD);
constexpr float kAngRange = static_cast<float>(kPiD / 16);
constexpr float kPi6 = static_cast<float>(kPiD / 6);

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// torch.maximum: a NaN in either wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
// torch.clamp(x, lo, hi): a NaN stays NaN
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ int clamp_i(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}
__device__ __forceinline__ float norm2(float x, float y) {
  return __fsqrt_rn(add(mul(x, x), mul(y, y)));
}

// angle -> 32 bits that order as the floats do; NaN after everything
__device__ __forceinline__ unsigned order_bits(float v) {
  if (isnan(v)) return 0xffffffffu;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_order_bits(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct Thres {
  float ta_cell_cnt, tp_cell_cnt, tp_eigval, ta_h_bar, ta_rcom, tp_rcom;
};

struct Params {
  // store (N rows) and queries (Bq rows)
  const unsigned char* s_valid;
  const signed char* s_level;
  const signed char* s_seq;
  const short* s_bit;
  const float* s_theta;
  const float* s_tab;
  const unsigned char* q_valid;
  const signed char* q_level;
  const signed char* q_seq;
  const short* q_bit;
  const float* q_theta;
  const float* q_tab;
  // hint rows
  const int* gidx;
  const int* level;
  const int* seq_src;
  const int* seq_tgt;
  const unsigned char* hv;
  const long long* tgt_q;     // or null: row r is query r / cols's
  const int* n_valid;         // or null: no column is idle
  // outputs, CascadeResult's order
  unsigned char* pass1;
  unsigned char* pass2;
  unsigned char* pass3;
  int* ovlp_sum;
  int* ovlp_max_one;
  int* in_ang_rng;
  int* i_indiv_sim;
  int* i_orie_sim;
  unsigned char* pair_valid;
  int* pair_level;
  int* pair_seq_src;
  int* pair_seq_tgt;
  float* pair_area_perc;
  float* T_delta;
  unsigned char* pot_overflow;
  unsigned char* win_overflow;
  int N, Bq, Ln, An, M, L12, J, cols, W, pot;
  int th_ovlp_sum, th_ovlp_max_one, th_in_ang, th_indiv, th_orie;
  Thres th;
};

// ContourView::checkSim on two packed tab12 rows (cnt, eig0, eig1, h, comr)
__device__ bool check_sim(const float* s, const float* t, const Thres& th) {
  const auto diff_perc = [](float a, float b, float p) {
    return fabsf(__fdiv_rn(sub(a, b), nan_max(a, b))) > p;
  };
  const auto diff_delt = [](float a, float b, float d) {
    return fabsf(sub(a, b)) > d;
  };
  const float cs = s[0], ct = t[0];
  bool fail = diff_perc(cs, ct, th.tp_cell_cnt) &
              diff_delt(cs, ct, th.ta_cell_cnt);
  fail |= (nan_max(s[2], t[2]) > 2.0f) &
          diff_perc(__fsqrt_rn(s[2]), __fsqrt_rn(t[2]), th.tp_eigval);
  fail |= (nan_max(s[1], t[1]) > 2.0f) &
          diff_perc(__fsqrt_rn(s[1]), __fsqrt_rn(t[1]), th.tp_eigval);
  fail |= (nan_max(cs, ct) > 15.0f) & diff_delt(s[3], t[3], th.ta_h_bar);
  fail |= diff_delt(s[4], t[4], th.ta_rcom) &
          diff_perc(s[4], t[4], th.tp_rcom);
  return !fail;
}

struct Smem {
  unsigned long long keys[kMaxPairs];   // close pairs: angle bits, flat
  float sv[kPotMax];                    // the kept pairs' angles, sorted
  int sf[kPotMax];                      // and their flat indices
  float s_tab[kSlots][kTab];            // the slots' tab12 rows
  float t_tab[kSlots][kTab];
  float red[4][kSlots];                 // the Umeyama sums' terms
  float s_th[kMaxM], t_th[kMaxM];
  int s_bit[kMaxM], t_bit[kMaxM];
  int s_ls[kMaxM], t_seq[kMaxM];        // level * 64 + seq; tgt seq
  int rank0[kSlots], cpos[kSlots];
  int slot_at[kShaftTop];
  unsigned bits_s[8], bits_t[8];
  unsigned char s_ok[kMaxM], t_ok[kMaxM], cstl1[kSlots];
  int n_close, n_finite, first_open, best, best_gt1, best_gt0;
  int pass1, pass2, longest, best_beg, n_pot, shaft_nan;
  float sh[4], mu[4];
};

// a row past its query's own chunks: every field 0 / false / +0.0
__device__ void write_zero_row(const Params& p, int r) {
  const size_t o = static_cast<size_t>(r) * kSlots + threadIdx.x;
  if (threadIdx.x < kSlots) {
    p.pair_valid[o] = 0;
    p.pair_level[o] = 0;
    p.pair_seq_src[o] = 0;
    p.pair_seq_tgt[o] = 0;
    p.pair_area_perc[o] = 0.0f;
  }
  if (threadIdx.x < 3) p.T_delta[static_cast<size_t>(r) * 3 + threadIdx.x] =
      0.0f;
  if (threadIdx.x == 0) {
    p.pass1[r] = p.pass2[r] = p.pass3[r] = 0;
    p.ovlp_sum[r] = p.ovlp_max_one[r] = p.in_ang_rng[r] = 0;
    p.i_indiv_sim[r] = p.i_orie_sim[r] = 0;
    p.pot_overflow[r] = p.win_overflow[r] = 0;
  }
}

// sum of x[0 .. 63] in warp 0: x[l] + x[l + 32], then the shuffle tree,
// then + 0.0 (a sum of -0.0 terms is +0.0, as from a sum started at 0);
// every lane gets the sum
__device__ __forceinline__ float slot_sum(const float* x) {
  const int l = threadIdx.x;
  float v = add(x[l], x[l + 32]);
  for (int off = 16; off > 0; off >>= 1)
    v = add(v, __shfl_down_sync(kFull, v, off));
  return add(__shfl_sync(kFull, v, 0), 0.0f);
}

// #{m < n : sv[m] <= x} for sv ascending
__device__ __forceinline__ int upper_count(const float* sv, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sv[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    cascade_kernel(const Params p) {
  __shared__ Smem sm;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int M = p.M;
  int q;
  if (p.tgt_q) {
    q = static_cast<int>(p.tgt_q[r]);
  } else {
    q = r / p.cols;
    if (p.n_valid) {
      const int own = (p.n_valid[q] + p.W - 1) / p.W * p.W;
      if (r - q * p.cols >= own) {
        write_zero_row(p, r);
        return;
      }
    }
  }
  q = clamp_i(q, 0, p.Bq - 1);

  const bool hv = p.hv[r] != 0;
  const int lev = p.level[r], ss = p.seq_src[r], st = p.seq_tgt[r];
  const int gi = clamp_i(hv ? p.gidx[r] : 0, 0, p.N - 1);
  const int lvl = clamp_i(lev, 0, p.Ln - 1);
  const size_t s_row =
      ((static_cast<size_t>(gi) * p.Ln + lvl) * p.An +
       clamp_i(ss, 0, p.An - 1)) * M;
  const size_t t_row =
      ((static_cast<size_t>(q) * p.Ln + lvl) * p.An +
       clamp_i(st, 0, p.An - 1)) * M;
  const size_t s_tab0 = static_cast<size_t>(gi) * p.L12 * p.J;
  const size_t t_tab0 = static_cast<size_t>(q) * p.L12 * p.J;

  // ---- the neighbour rows; check 1 -----------------------------------
  if (tid < M) {
    sm.s_ok[tid] = p.s_valid[s_row + tid] != 0;
    sm.s_bit[tid] = p.s_bit[s_row + tid];
    sm.s_th[tid] = p.s_theta[s_row + tid];
    sm.s_ls[tid] = static_cast<int>(p.s_level[s_row + tid]) * 64 +
                   static_cast<int>(p.s_seq[s_row + tid]);
  } else if (tid >= 64 && tid - 64 < M) {
    const int i = tid - 64;
    sm.t_ok[i] = p.q_valid[t_row + i] != 0;
    sm.t_bit[i] = p.q_bit[t_row + i];
    sm.t_th[i] = p.q_theta[t_row + i];
    sm.t_seq[i] = p.q_seq[t_row + i];
  }
  if (tid == kThreads - 1) {
    const int li = clamp_i(lev - 1, 0, p.L12 - 1);
    const float* sa = p.s_tab + (s_tab0 + static_cast<size_t>(li) * p.J +
                                 clamp_i(ss, 0, p.J - 1)) * kTab;
    const float* ta = p.q_tab + (t_tab0 + static_cast<size_t>(li) * p.J +
                                 clamp_i(st, 0, p.J - 1)) * kTab;
    sm.pass1 = hv && check_sim(sa, ta, p.th);
    sm.n_close = 0;
    sm.n_finite = 0;
    sm.first_open = INT_MAX;
    sm.best = 0;
    sm.best_gt1 = -1;
    sm.best_gt0 = kBig;
  }
  __syncthreads();

  // ---- check 2: the BCI masks; the close pairs --------------------------
  if (tid < 16) {
    const bool src = tid < 8;
    const int w = tid & 7;
    unsigned m = 0;
    for (int i = 0; i < M; ++i) {
      const int bit = src ? sm.s_bit[i] : sm.t_bit[i];
      const bool ok = src ? sm.s_ok[i] : sm.t_ok[i];
      if (ok && bit >= 32 * w && bit < 32 * w + 32) m |= 1u << (bit - 32 * w);
    }
    (src ? sm.bits_s : sm.bits_t)[w] = m;
  }
  const int MM = M * M;
  int open = INT_MAX;
  for (int f0 = 0; f0 < MM; f0 += kThreads) {
    const int f = f0 + tid;
    const int j = f / M, i = f - j * M;
    const bool in = f < MM;
    const bool close = in && sm.s_ok[i] && sm.t_ok[j] &&
                       abs(sm.s_bit[i] - sm.t_bit[j]) <= 1;
    unsigned long long key = 0;
    bool fin = false;
    if (close) {
      // cascade.clamp_ang(theta_t - theta_s) + 0.0
      const float a = sub(sm.t_th[j], sm.s_th[i]);
      const float k = floorf(mul(add(a, kPi), __fdiv_rn(1.0f, kTwoPi)));
      const float o = add(sub(a, mul(k, kTwoPi)), 0.0f);
      fin = isfinite(o);
      key = (static_cast<unsigned long long>(order_bits(o)) << 32) |
            static_cast<unsigned>(f);
    } else if (in) {
      open = min(open, f);
    }
    const unsigned cm = __ballot_sync(kFull, close);
    const unsigned fm = __ballot_sync(kFull, fin);
    int base = 0;
    if (lane == 0 && cm) base = atomicAdd(&sm.n_close, __popc(cm));
    if (lane == 0 && fm) atomicAdd(&sm.n_finite, __popc(fm));
    base = __shfl_sync(kFull, base, 0);
    if (close) sm.keys[base + __popc(cm & ((1u << lane) - 1))] = key;
  }
  for (int off = 16; off > 0; off >>= 1)
    open = min(open, __shfl_down_sync(kFull, open, off));
  if (lane == 0 && open != INT_MAX) atomicMin(&sm.first_open, open);
  __syncthreads();

  // ---- the first min(p_pot, M*M) close pairs in stable sorted order -----
  const int nc = sm.n_close;
  const int n = min(sm.n_finite, min(p.pot, MM));
  for (int e = tid; e < nc; e += kThreads) {
    const unsigned long long k = sm.keys[e];
    int rank = 0;
    for (int e2 = 0; e2 < nc; ++e2) rank += sm.keys[e2] < k;
    if (rank < n) {
      sm.sv[rank] = from_order_bits(static_cast<unsigned>(k >> 32));
      sm.sf[rank] = static_cast<int>(k & 0xffffffffu);
    }
  }
  __syncthreads();

  // ---- the circular window counts ---------------------------------------
  for (int k = tid; k < n; k += kThreads) {
    const float hi = add(sm.sv[k], kAngRange);
    const int c_main = upper_count(sm.sv, n, hi);
    const int c_wrap = upper_count(sm.sv, n, sub(hi, kTwoPi));
    const int cnt = min(c_main, n) - k + min(c_wrap, n);
    atomicMax(&sm.best, (cnt << 16) | (0xffff - k));
  }
  __syncthreads();
  if (tid == 0) {
    const int best = sm.best;
    const int longest = max(best >> 16, 1);
    int a1 = 0, a2 = 0, a3 = 0;
    for (int w = 0; w < 8; ++w) {
      const unsigned s = sm.bits_s[w], t = sm.bits_t[w];
      const unsigned shl = (s << 1) | (w > 0 ? sm.bits_s[w - 1] >> 31 : 0u);
      const unsigned shr = (s >> 1) | (w < 7 ? sm.bits_s[w + 1] << 31 : 0u);
      a1 += __popc(s & t);
      a2 += __popc(shl & t);
      a3 += __popc(shr & t);
    }
    const int osum = a1 + a2 + a3, omax = max(a1, max(a2, a3));
    const int in_ang = n > 0 ? longest : 0;
    const bool pass2 = sm.pass1 && osum >= p.th_ovlp_sum &&
                       omax >= p.th_ovlp_max_one && n > 0 &&
                       in_ang >= p.th_in_ang;
    sm.pass2 = pass2;
    sm.longest = longest;
    sm.best_beg = n > 0 ? 0xffff - (best & 0xffff) : 0;
    sm.n_pot = n;
    p.pass1[r] = sm.pass1;
    p.pass2[r] = pass2;
    p.ovlp_sum[r] = osum;
    p.ovlp_max_one[r] = omax;
    p.in_ang_rng[r] = in_ang;
    p.pot_overflow[r] = nc > p.pot;
    p.win_overflow[r] = longest > kSlots - 1;
  }
  __syncthreads();

  // ---- the constellation: window members and the anchor; check 3 ---------
  const size_t o = static_cast<size_t>(r) * kSlots + tid;
  bool c1 = false;
  int rk = 0;
  if (tid < kSlots) {
    const int longest = sm.longest;
    int plev, pss, pst;
    bool v0;
    if (tid < kSlots - 1) {
      const int gf = n > 0 ? sm.sf[(sm.best_beg + tid) % n]
                           : (sm.first_open == INT_MAX ? 0 : sm.first_open);
      const int j = gf / M, i = gf - j * M;
      const int gls = sm.s_ls[i];
      plev = gls >> 6;            // floor division by 64
      pss = gls & 63;             // its non-negative remainder
      pst = sm.t_seq[j];
      v0 = tid < min(longest, kSlots - 1);
      rk = tid;
    } else {
      plev = lev;
      pss = ss;
      pst = st;
      v0 = true;
      rk = longest;
    }
    v0 = v0 && sm.pass2;
    const int li = clamp_i(plev - 1, 0, p.L12 - 1);
    const float* sr = p.s_tab + (s_tab0 + static_cast<size_t>(li) * p.J +
                                 clamp_i(pss, 0, p.J - 1)) * kTab;
    const float* tr = p.q_tab + (t_tab0 + static_cast<size_t>(li) * p.J +
                                 clamp_i(pst, 0, p.J - 1)) * kTab;
    for (int c = 0; c < kTab; ++c) {
      sm.s_tab[tid][c] = sr[c];
      sm.t_tab[tid][c] = tr[c];
    }
    c1 = v0 && check_sim(sr, tr, p.th) && sr[11] > 0.5f && tr[11] > 0.5f;
    sm.cstl1[tid] = c1;
    sm.rank0[tid] = rk;
    p.pair_level[o] = plev;
    p.pair_seq_src[o] = pss;
    p.pair_seq_tgt[o] = pst;
  }
  const int i_indiv = __syncthreads_count(c1);

  // each valid slot's place in the (rank0, slot) order of the valid slots
  if (tid < kSlots) {
    int cp = kBig;
    if (c1) {
      cp = 0;
      for (int s2 = 0; s2 < kSlots; ++s2) {
        const int r2 = sm.rank0[s2];
        cp += sm.cstl1[s2] && (r2 < rk || (r2 == rk && s2 < tid));
      }
      if (cp < kShaftTop) sm.slot_at[cp] = tid;
    }
    sm.cpos[tid] = cp;
  }
  __syncthreads();

  // ---- the shaft (contour_mng.h:1173-1184) -------------------------------
  const int n_top = min(i_indiv, kShaftTop);
  if (tid < kShaftTop * kShaftTop) {
    const int ci = tid / kShaftTop, cj = tid - ci * kShaftTop;
    if (cj < ci && ci < n_top) {
      const float* a = sm.s_tab[sm.slot_at[ci]];
      const float* b = sm.s_tab[sm.slot_at[cj]];
      const float span = norm2(sub(a[5], b[5]), sub(a[6], b[6]));
      const int it = ci * kShaftTop + cj;
      if (span > 1.0f) atomicMax(&sm.best_gt1, it);
      if (span > 0.0f) atomicMin(&sm.best_gt0, it);
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int use = sm.best_gt1 >= 0 ? sm.best_gt1 : sm.best_gt0;
    float sh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool nan_shaft = false;
    if (use < kBig) {
      const int i = sm.slot_at[use / kShaftTop];
      const int j = sm.slot_at[use % kShaftTop];
      const float s0 = sub(sm.s_tab[i][5], sm.s_tab[j][5]);
      const float s1 = sub(sm.s_tab[i][6], sm.s_tab[j][6]);
      const float t0 = sub(sm.t_tab[i][5], sm.t_tab[j][5]);
      const float t1 = sub(sm.t_tab[i][6], sm.t_tab[j][6]);
      const float ns = clamp_min(norm2(s0, s1), 1e-12f);
      const float nt = norm2(t0, t1);
      const float ntc = clamp_min(nt, 1e-12f);
      sh[0] = __fdiv_rn(s0, ns);
      sh[1] = __fdiv_rn(s1, ns);
      sh[2] = __fdiv_rn(t0, ntc);
      sh[3] = __fdiv_rn(t1, ntc);
      nan_shaft = nt <= 1e-12f;
    }
    for (int c = 0; c < 4; ++c) sm.sh[c] = sh[c];
    sm.shaft_nan = nan_shaft;
  }
  __syncthreads();

  // ---- the orientation screen (contour_mng.h:1186-1201) ------------------
  bool c2 = false;
  if (tid < kSlots) {
    const float* s = sm.s_tab[tid];
    const float* t = sm.t_tab[tid];
    const float th_s = acosf(clamp_f(
        add(mul(sm.sh[0], s[7]), mul(sm.sh[1], s[8])), -1.0f, 1.0f));
    const float th_t = acosf(clamp_f(
        add(mul(sm.sh[2], t[7]), mul(sm.sh[3], t[8])), -1.0f, 1.0f));
    const bool bad = s[9] > 0.5f && t[9] > 0.5f &&
                     fabsf(sub(th_s, th_t)) > kPi6 &&
                     fabsf(sub(sub(kPi, th_s), th_t)) > kPi6 && !sm.shaft_nan;
    c2 = c1 && !bad;
    p.pair_valid[o] = c2;
    p.pair_area_perc[o] = c2 ? mul(0.5f, add(s[10], t[10])) : 0.0f;
    const float w = c2 ? 1.0f : 0.0f;
    sm.red[0][tid] = mul(s[5], w);
    sm.red[1][tid] = mul(s[6], w);
    sm.red[2][tid] = mul(t[5], w);
    sm.red[3][tid] = mul(t[6], w);
  }
  const int i_orie = __syncthreads_count(c2);

  // ---- Umeyama SE(2) (contour_mng.h:1251-1277) ---------------------------
  if (tid < 32) {
    const float nf = static_cast<float>(max(i_orie, 1));
    float mu[4];
    for (int c = 0; c < 4; ++c) mu[c] = __fdiv_rn(slot_sum(sm.red[c]), nf);
    if (tid == 0)
      for (int c = 0; c < 4; ++c) sm.mu[c] = mu[c];
  }
  __syncthreads();
  if (tid < kSlots) {
    const float* s = sm.s_tab[tid];
    const float* t = sm.t_tab[tid];
    const float w = c2 ? 1.0f : 0.0f;
    const float dt0 = mul(sub(t[5], sm.mu[2]), w);
    const float dt1 = mul(sub(t[6], sm.mu[3]), w);
    const float ds0 = sub(s[5], sm.mu[0]), ds1 = sub(s[6], sm.mu[1]);
    sm.red[0][tid] = mul(dt0, ds0);
    sm.red[1][tid] = mul(dt0, ds1);
    sm.red[2][tid] = mul(dt1, ds0);
    sm.red[3][tid] = mul(dt1, ds1);
  }
  __syncthreads();
  if (tid < 32) {
    const float c00 = slot_sum(sm.red[0]), c01 = slot_sum(sm.red[1]);
    const float c10 = slot_sum(sm.red[2]), c11 = slot_sum(sm.red[3]);
    if (tid == 0) {
      const float th = atan2f(sub(c10, c01), add(c00, c11));
      const float cth = cosf(th), sth = sinf(th);
      const float ms0 = sm.mu[0], ms1 = sm.mu[1];
      float* T = p.T_delta + static_cast<size_t>(r) * 3;
      T[0] = sub(sm.mu[2], sub(mul(cth, ms0), mul(sth, ms1)));
      T[1] = sub(sm.mu[3], add(mul(sth, ms0), mul(cth, ms1)));
      T[2] = th;
      p.i_indiv_sim[r] = i_indiv;
      p.i_orie_sim[r] = i_orie;
      p.pass3[r] = sm.pass2 && i_indiv >= p.th_indiv &&
                   i_orie >= p.th_orie;
    }
  }
}

}  // namespace

// ptrs: the store's nei_valid, nei_level, nei_seq, nei_bit, nei_theta and
// tab12, the same six of the queries, the rows' gidx, level, seq_src,
// seq_tgt and hint_valid, tgt_q (int64, or null), n_valid (or null), then
// the 16 outputs in CascadeResult's order. dims: N, Bq, L, A, M, L12, J,
// rows, cols, W, p_pot and the five integer bars. th: cont_sim's six.
extern "C" int cc_cascade(void* const* ptrs, const int* dims,
                          const float* th, void* stream) {
  Params p;
  int i = 0;
  p.s_valid = static_cast<const unsigned char*>(ptrs[i++]);
  p.s_level = static_cast<const signed char*>(ptrs[i++]);
  p.s_seq = static_cast<const signed char*>(ptrs[i++]);
  p.s_bit = static_cast<const short*>(ptrs[i++]);
  p.s_theta = static_cast<const float*>(ptrs[i++]);
  p.s_tab = static_cast<const float*>(ptrs[i++]);
  p.q_valid = static_cast<const unsigned char*>(ptrs[i++]);
  p.q_level = static_cast<const signed char*>(ptrs[i++]);
  p.q_seq = static_cast<const signed char*>(ptrs[i++]);
  p.q_bit = static_cast<const short*>(ptrs[i++]);
  p.q_theta = static_cast<const float*>(ptrs[i++]);
  p.q_tab = static_cast<const float*>(ptrs[i++]);
  p.gidx = static_cast<const int*>(ptrs[i++]);
  p.level = static_cast<const int*>(ptrs[i++]);
  p.seq_src = static_cast<const int*>(ptrs[i++]);
  p.seq_tgt = static_cast<const int*>(ptrs[i++]);
  p.hv = static_cast<const unsigned char*>(ptrs[i++]);
  p.tgt_q = static_cast<const long long*>(ptrs[i++]);
  p.n_valid = static_cast<const int*>(ptrs[i++]);
  p.pass1 = static_cast<unsigned char*>(ptrs[i++]);
  p.pass2 = static_cast<unsigned char*>(ptrs[i++]);
  p.pass3 = static_cast<unsigned char*>(ptrs[i++]);
  p.ovlp_sum = static_cast<int*>(ptrs[i++]);
  p.ovlp_max_one = static_cast<int*>(ptrs[i++]);
  p.in_ang_rng = static_cast<int*>(ptrs[i++]);
  p.i_indiv_sim = static_cast<int*>(ptrs[i++]);
  p.i_orie_sim = static_cast<int*>(ptrs[i++]);
  p.pair_valid = static_cast<unsigned char*>(ptrs[i++]);
  p.pair_level = static_cast<int*>(ptrs[i++]);
  p.pair_seq_src = static_cast<int*>(ptrs[i++]);
  p.pair_seq_tgt = static_cast<int*>(ptrs[i++]);
  p.pair_area_perc = static_cast<float*>(ptrs[i++]);
  p.T_delta = static_cast<float*>(ptrs[i++]);
  p.pot_overflow = static_cast<unsigned char*>(ptrs[i++]);
  p.win_overflow = static_cast<unsigned char*>(ptrs[i++]);
  const int rows = dims[7];
  p.N = dims[0];
  p.Bq = dims[1];
  p.Ln = dims[2];
  p.An = dims[3];
  p.M = dims[4];
  p.L12 = dims[5];
  p.J = dims[6];
  p.cols = dims[8];
  p.W = dims[9];
  p.pot = dims[10];
  p.th_ovlp_sum = dims[11];
  p.th_ovlp_max_one = dims[12];
  p.th_in_ang = dims[13];
  p.th_indiv = dims[14];
  p.th_orie = dims[15];
  p.th = Thres{th[0], th[1], th[2], th[3], th[4], th[5]};
  if (rows < 0 || p.N < 1 || p.Bq < 1 || p.Ln < 1 || p.An < 1 || p.M < 1 ||
      p.M > kMaxM || p.L12 < 1 || p.J < 1 || p.pot < 1 || p.pot > kPotMax ||
      (!p.tgt_q && p.cols < 1) || (p.n_valid && p.W < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cascade_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
