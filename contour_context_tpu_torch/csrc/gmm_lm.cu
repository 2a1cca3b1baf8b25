// The GMM refinement's Levenberg-Marquardt iterations: every iteration of
// every (query, candidate) row in one launch.
//
// Replaces: contour_context_tpu/ops/gmm.py, optimize_correlation's
// lax.scan over the LM iterations (:287). There is no Pallas kernel
// behind it; XLA fuses the JAX loop on the device. The port's plain twin
// (ops/gmm.optimize_correlation_plain) is the same torch body that ran
// before this kernel, some 3,550 small device operations a call, with its
// sums over the pair grid written in this kernel's order.
//
// Inputs: R rows, each a source GMM (G levels x K ellipses: mus (2), covs
// (2 x 2, of which [0][0], [0][1] and [1][1] are read), weights), its pose
// T0 (x, y, theta) and its close-pair mask sel (G, K, K); n target GMMs,
// target i serving rows i R/n .. (i+1) R/n - 1; the auto-correlations of
// both. Each row runs `iters` LM steps on the negative L2 product of its
// source under the pose with its target: the gradient and Hessian summed
// over the G*K*K pairs, a damped 3x3 solve, the trial value summed over
// the pairs again, the step taken only if the value falls and the new pose
// is finite (lambda x 0.33 on a step, x 10 on a refusal). Outputs: the
// correlation -f / sqrt(max(ac_src ac_tgt, 1e-12)) (R,) and the pose (R,
// 3).
//
// What bounds it on the card: the latency of `iters` dependent iterations,
// not bytes. A row reads ~10 KB once (at G = 4, K = 32) and writes 16
// bytes; each iteration is ~200 flops a pair for the gradient and Hessian
// and ~60 for the trial value over 4,096 pairs: ~10 MFLOP for the stream's
// 10 rows, a few us at the fp32 rate spread over the card, but each
// iteration needs the whole row's two sums before the next can start, and
// the stream has 10 rows for 132 SMs.
//
// Design. A CTA a row, 512 threads (kThreads), nothing leaving the chip
// between iterations:
//   - The row's source and target GMMs, its sel mask and, for the current
//     and the trial pose, the per-source terms (the rotated covariance E,
//     the rotated mean u and u + (x, y), and the six theta derivatives of
//     S, which depend on the source ellipse alone) sit in shared memory;
//     the per-source terms are computed once a pose by G*K threads instead
//     of once a pair. The pose, f and lambda live in every thread's
//     registers: every thread runs the 3x3 solve and the accept test on
//     the same sums, so no broadcast and no barrier follows them.
//   - A pass: thread t takes pairs t, t + 512, ... (each warp one source
//     ellipse and 32 consecutive targets at K = 32: the source's loads are
//     broadcasts, the targets' conflict-free), summing its terms from 0;
//     then a shuffle tree in each warp and, for each of the 9 sums of the
//     gradient pass, one warp reducing the 16 warps' partials by another
//     shuffle tree. Two barriers a pass.
//   - The trial pose's per-source terms go to the second buffer; a taken
//     step swaps the buffers, so the next gradient pass starts with no
//     recomputation.
// The arithmetic repeats the twin's torch expressions op for op, each op
// rounded on its own (__f*_rn: no FMA contraction, no fast math): expf,
// rsqrtf, sinf and cosf are the CUDA math library's, as torch's CUDA
// kernels call them for f32; 1 / det is torch's reciprocal (an IEEE
// division); torch.clamp keeps a NaN; each scalar factor is the float32
// rounding of the double torch takes it from (-2 * scale on the host,
// static_cast<float>(1e-12) here). The twin sums in the order described
// above (gmm._kernel_sum), so the kernel equals it on the card bit for bit.
//
// Launch requirements: kThreads = 512 threads a CTA, R CTAs, G*K*K < 2^31;
// shared memory (38 G*K floats, G*K*K bytes and the partials: ~24 KB at
// G = 4, K = 32) beyond 48 KB is asked for with cudaFuncSetAttribute.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHessSums = 9;        // gradient x, y, t; Hessian xx .. tt

// shared arrays of G*K floats: the target's and the source's raw fields
enum TgtField { kTm0, kTm1, kTc00, kTc01, kTc11, kTw, kTgtFields };
enum SrcField { kSm0, kSm1, kSa, kSb, kSd, kSw, kSrcFields };
// the per-source terms of one pose
enum PoseField {
  kUx, kUy, kU0, kU1, kE00, kE01, kE11,
  kS00t, kS01t, kS11t, kS00tt, kS01tt, kS11tt, kPoseFields
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// torch.clamp(x, min=lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// n / d for n < 2^31 by a multiply and a shift (d >= 2: m = ceil(2^p / d),
// p = 31 + ceil(log2 d)); d = 1 returns n
struct FastDiv {
  unsigned d, m, shift;
};

FastDiv make_fastdiv(unsigned d) {
  if (d <= 1) return FastDiv{1u, 0u, 0u};
  unsigned l = 0;
  while ((1u << l) < d) ++l;
  const unsigned p = 31 + l;
  const unsigned long long m = ((1ull << p) + d - 1) / d;
  return FastDiv{d, static_cast<unsigned>(m), p - 32};
}

__device__ __forceinline__ unsigned fdiv(unsigned n, const FastDiv& f) {
  return f.d == 1 ? n : __umulhi(n, f.m) >> f.shift;
}

struct Params {
  const float* src_mus;
  const float* src_covs;
  const float* src_ws;
  const float* src_ac;
  const float* tgt_mus;
  const float* tgt_covs;
  const float* tgt_ws;
  const float* tgt_ac;
  const unsigned char* sel;
  const float* T0;
  float* corr;
  float* T;
  int rows_per_tgt, G, K, iters;
  float g2, m2g2, two_g2, m4g2;     // scale, -2 scale, 2 scale, -4 scale
  FastDiv by_k;
};

// The per-source terms of pose (x, y, c = cos theta, s = sin theta), the
// twin's _value_terms and _grad_hess_terms on a source ellipse.
__device__ void pose_terms(float* __restrict__ out,
                           const float* __restrict__ src, int GK, float x,
                           float y, float c, float s, const Params& p) {
  for (int i = threadIdx.x; i < GK; i += kThreads) {
    const float m0 = src[kSm0 * GK + i], m1 = src[kSm1 * GK + i];
    const float a = src[kSa * GK + i], b = src[kSb * GK + i];
    const float d = src[kSd * GK + i];
    const float u0 = sub(mul(c, m0), mul(s, m1));
    const float u1 = add(mul(s, m0), mul(c, m1));
    const float cc = mul(c, c), ss = mul(s, s);
    const float cs2 = mul(mul(2.0f, c), s);
    const float E00 = add(sub(mul(cc, a), mul(cs2, b)), mul(ss, d));
    const float E01 = add(mul(mul(c, s), sub(a, d)), mul(sub(cc, ss), b));
    const float E11 = add(add(mul(ss, a), mul(cs2, b)), mul(cc, d));
    const float dE = sub(E00, E11);
    out[kUx * GK + i] = add(u0, x);
    out[kUy * GK + i] = add(u1, y);
    out[kU0 * GK + i] = u0;
    out[kU1 * GK + i] = u1;
    out[kE00 * GK + i] = E00;
    out[kE01 * GK + i] = E01;
    out[kE11 * GK + i] = E11;
    out[kS00t * GK + i] = mul(p.m2g2, E01);
    out[kS01t * GK + i] = mul(p.g2, dE);
    out[kS11t * GK + i] = mul(p.two_g2, E01);
    out[kS00tt * GK + i] = mul(p.m2g2, dE);
    out[kS01tt * GK + i] = mul(p.m4g2, E01);
    out[kS11tt * GK + i] = mul(p.two_g2, dE);
  }
}

// One pair's value v and the inverse and offset terms the gradient pass
// needs (the twin's _value_terms): pair e = j K + k' of the row's flattened
// (G, K, K) grid, j = g K + (source ellipse) indexing the per-source
// arrays and k = g K + k' the target's.
struct Pair {
  float I00, I01, I11, al0, al1, v;
};

__device__ __forceinline__ Pair pair_value(const float* __restrict__ pose,
                                           const float* __restrict__ tgt,
                                           const float* __restrict__ src,
                                           const unsigned char* __restrict__ sel,
                                           int e, int j, int k, int GK,
                                           const Params& p) {
  const float S00 = mul(p.g2, add(pose[kE00 * GK + j], tgt[kTc00 * GK + k]));
  const float S01 = mul(p.g2, add(pose[kE01 * GK + j], tgt[kTc01 * GK + k]));
  const float S11 = mul(p.g2, add(pose[kE11 * GK + j], tgt[kTc11 * GK + k]));
  const float m0 = sub(pose[kUx * GK + j], tgt[kTm0 * GK + k]);
  const float m1 = sub(pose[kUy * GK + j], tgt[kTm1 * GK + k]);
  const float det = clamp_min(sub(mul(S00, S11), mul(S01, S01)),
                              static_cast<float>(1e-12));
  const float inv = __fdiv_rn(1.0f, det);
  Pair q;
  q.I00 = mul(S11, inv);
  q.I01 = mul(-S01, inv);
  q.I11 = mul(S00, inv);
  q.al0 = add(mul(q.I00, m0), mul(q.I01, m1));
  q.al1 = add(mul(q.I01, m0), mul(q.I11, m1));
  const float qf = add(mul(m0, q.al0), mul(m1, q.al1));
  const float w = sel[e] ? mul(src[kSw * GK + j], tgt[kTw * GK + k]) : 0.0f;
  q.v = mul(mul(w, rsqrtf(det)), expf(mul(-0.5f, qf)));
  return q;
}

// Sums acc[0..N) of every thread of the CTA into tot[0..N): a shuffle tree
// in each warp (lane i adds lane i + 16, 8, 4, 2, 1), then warp w < N
// adds the warps' partials of sum w by a shuffle tree over the warp index.
// Every thread reads tot after it returns.
template <int N>
__device__ __forceinline__ void block_sums(float (&acc)[N], float* part,
                                           float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      acc[i] = add(acc[i], __shfl_down_sync(0xffffffffu, acc[i], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) part[warp * N + i] = acc[i];
  }
  __syncthreads();
  if (warp < N) {
    float x = lane < kWarps ? part[lane * N + warp] : 0.0f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      x = add(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) tot[warp] = x;
  }
  __syncthreads();
}

// f = -(the sum of the pair values) at the pose whose terms are `pose`
__device__ float value_pass(const float* pose, const float* tgt,
                            const float* src, const unsigned char* sel,
                            float* part, float* tot, int GK, int P,
                            const Params& p) {
  float acc[1] = {0.0f};
  for (int e = threadIdx.x; e < P; e += kThreads) {
    const int j = static_cast<int>(fdiv(static_cast<unsigned>(e), p.by_k));
    const int k = static_cast<int>(fdiv(j, p.by_k)) * p.K + (e - j * p.K);
    acc[0] = add(acc[0], pair_value(pose, tgt, src, sel, e, j, k, GK, p).v);
  }
  block_sums<1>(acc, part, tot);
  return -tot[0];
}

// the nine sums of the gradient pass (the twin's _grad_hess_terms, each
// product v * z summed over the pairs) into tot[0..9)
__device__ void grad_hess_pass(const float* pose, const float* tgt,
                               const float* src, const unsigned char* sel,
                               float* part, float* tot, int GK, int P,
                               const Params& p) {
  float acc[kHessSums];
#pragma unroll
  for (int i = 0; i < kHessSums; ++i) acc[i] = 0.0f;
  for (int e = threadIdx.x; e < P; e += kThreads) {
    const int j = static_cast<int>(fdiv(static_cast<unsigned>(e), p.by_k));
    const int k = static_cast<int>(fdiv(j, p.by_k)) * p.K + (e - j * p.K);
    const Pair q = pair_value(pose, tgt, src, sel, e, j, k, GK, p);
    const float I00 = q.I00, I01 = q.I01, I11 = q.I11;
    const float al0 = q.al0, al1 = q.al1, v = q.v;
    const float S00t = pose[kS00t * GK + j], S01t = pose[kS01t * GK + j];
    const float S11t = pose[kS11t * GK + j], S00tt = pose[kS00tt * GK + j];
    const float S01tt = pose[kS01tt * GK + j];
    const float S11tt = pose[kS11tt * GK + j];
    const float u0 = pose[kU0 * GK + j], u1 = pose[kU1 * GK + j];
    const float mt0 = -u1, mt1 = u0, mtt0 = -u0, mtt1 = -u1;
    const float Lx = -al0, Ly = -al1;
    const float Sta0 = add(mul(S00t, al0), mul(S01t, al1));
    const float Sta1 = add(mul(S01t, al0), mul(S11t, al1));
    const float trt = add(add(mul(I00, S00t), mul(mul(2.0f, I01), S01t)),
                          mul(I11, S11t));
    const float qt = sub(mul(2.0f, add(mul(mt0, al0), mul(mt1, al1))),
                         add(mul(al0, Sta0), mul(al1, Sta1)));
    const float Lt = sub(mul(-0.5f, trt), mul(0.5f, qt));
    const float Lxx = -I00, Lxy = -I01, Lyy = -I11;
    const float bt0 = add(mul(I00, mt0), mul(I01, mt1));
    const float bt1 = add(mul(I01, mt0), mul(I11, mt1));
    const float dl0 = add(mul(I00, Sta0), mul(I01, Sta1));
    const float dl1 = add(mul(I01, Sta0), mul(I11, Sta1));
    const float at0 = sub(bt0, dl0), at1 = sub(bt1, dl1);
    const float Lxt = -at0, Lyt = -at1;
    const float Mt00 = add(mul(I00, S00t), mul(I01, S01t));
    const float Mt01 = add(mul(I00, S01t), mul(I01, S11t));
    const float Mt10 = add(mul(I01, S00t), mul(I11, S01t));
    const float Mt11 = add(mul(I01, S01t), mul(I11, S11t));
    const float trtt = add(
        -add(add(mul(Mt00, Mt00), mul(mul(2.0f, Mt01), Mt10)),
             mul(Mt11, Mt11)),
        add(add(mul(I00, S00tt), mul(mul(2.0f, I01), S01tt)),
            mul(I11, S11tt)));
    const float qtt = sub(
        sub(add(mul(2.0f, add(mul(mtt0, al0), mul(mtt1, al1))),
                mul(2.0f, add(mul(mt0, at0), mul(mt1, at1)))),
            mul(2.0f, add(mul(at0, Sta0), mul(at1, Sta1)))),
        add(add(mul(mul(al0, al0), S00tt),
                mul(mul(mul(2.0f, al0), al1), S01tt)),
            mul(mul(al1, al1), S11tt)));
    const float Ltt = sub(mul(-0.5f, trtt), mul(0.5f, qtt));
    acc[0] = add(acc[0], mul(v, Lx));
    acc[1] = add(acc[1], mul(v, Ly));
    acc[2] = add(acc[2], mul(v, Lt));
    acc[3] = add(acc[3], mul(v, add(mul(Lx, Lx), Lxx)));
    acc[4] = add(acc[4], mul(v, add(mul(Lx, Ly), Lxy)));
    acc[5] = add(acc[5], mul(v, add(mul(Lx, Lt), Lxt)));
    acc[6] = add(acc[6], mul(v, add(mul(Ly, Ly), Lyy)));
    acc[7] = add(acc[7], mul(v, add(mul(Ly, Lt), Lyt)));
    acc[8] = add(acc[8], mul(v, add(mul(Lt, Lt), Ltt)));
  }
  block_sums<kHessSums>(acc, part, tot);
}

// The damped step from the nine sums (the twin's _grad_hess, A = H + lam I
// + 1e-9 I with torch's products by the identity, and _solve3): x = A^-1
// (-g) by the adjugate.
__device__ __forceinline__ void lm_step(const float* tot, float lam,
                                        float (&x)[3]) {
  // g = -(sums 0..2), H = -(sums 3..8); b = -g
  const float b[3] = {-(-tot[0]), -(-tot[1]), -(-tot[2])};
  const float h[3][3] = {{-tot[3], -tot[4], -tot[5]},
                         {-tot[4], -tot[6], -tot[7]},
                         {-tot[5], -tot[7], -tot[8]}};
  const float lam_on = mul(lam, 1.0f), lam_off = mul(lam, 0.0f);
  const float eps = static_cast<float>(1e-9);
  const float eps_on = mul(eps, 1.0f), eps_off = mul(eps, 0.0f);
  float a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[i][j] = add(add(h[i][j], i == j ? lam_on : lam_off),
                    i == j ? eps_on : eps_off);
  }
  const float c00 = sub(mul(a[1][1], a[2][2]), mul(a[1][2], a[2][1]));
  const float c01 = sub(mul(a[1][2], a[2][0]), mul(a[1][0], a[2][2]));
  const float c02 = sub(mul(a[1][0], a[2][1]), mul(a[1][1], a[2][0]));
  const float c10 = sub(mul(a[0][2], a[2][1]), mul(a[0][1], a[2][2]));
  const float c11 = sub(mul(a[0][0], a[2][2]), mul(a[0][2], a[2][0]));
  const float c12 = sub(mul(a[0][1], a[2][0]), mul(a[0][0], a[2][1]));
  const float c20 = sub(mul(a[0][1], a[1][2]), mul(a[0][2], a[1][1]));
  const float c21 = sub(mul(a[0][2], a[1][0]), mul(a[0][0], a[1][2]));
  const float c22 = sub(mul(a[0][0], a[1][1]), mul(a[0][1], a[1][0]));
  const float det = add(add(mul(a[0][0], c00), mul(a[0][1], c01)),
                        mul(a[0][2], c02));
  const float tiny = static_cast<float>(1e-30);
  const float den = fabsf(det) > tiny ? det : tiny;
  x[0] = __fdiv_rn(add(add(mul(c00, b[0]), mul(c10, b[1])), mul(c20, b[2])),
                   den);
  x[1] = __fdiv_rn(add(add(mul(c01, b[0]), mul(c11, b[1])), mul(c21, b[2])),
                   den);
  x[2] = __fdiv_rn(add(add(mul(c02, b[0]), mul(c12, b[1])), mul(c22, b[2])),
                   den);
}

__global__ void __launch_bounds__(kThreads)
    gmm_lm_kernel(const Params p) {
  extern __shared__ float smem[];
  const int GK = p.G * p.K;
  const int P = GK * p.K;
  const int r = blockIdx.x;
  const int ti = r / p.rows_per_tgt;
  float* tgt = smem;                                 // kTgtFields x GK
  float* src = tgt + kTgtFields * GK;                // kSrcFields x GK
  float* pose = src + kSrcFields * GK;               // the current pose's
  float* trial = pose + kPoseFields * GK;            // the trial pose's
  float* part = trial + kPoseFields * GK;            // kWarps x kHessSums
  float* tot = part + kWarps * kHessSums;            // kHessSums (+ pad)
  unsigned char* sel = reinterpret_cast<unsigned char*>(tot + 16);

  for (int i = threadIdx.x; i < GK; i += kThreads) {
    const size_t sr = static_cast<size_t>(r) * GK + i;
    const size_t tr = static_cast<size_t>(ti) * GK + i;
    src[kSm0 * GK + i] = p.src_mus[sr * 2];
    src[kSm1 * GK + i] = p.src_mus[sr * 2 + 1];
    src[kSa * GK + i] = p.src_covs[sr * 4];
    src[kSb * GK + i] = p.src_covs[sr * 4 + 1];
    src[kSd * GK + i] = p.src_covs[sr * 4 + 3];
    src[kSw * GK + i] = p.src_ws[sr];
    tgt[kTm0 * GK + i] = p.tgt_mus[tr * 2];
    tgt[kTm1 * GK + i] = p.tgt_mus[tr * 2 + 1];
    tgt[kTc00 * GK + i] = p.tgt_covs[tr * 4];
    tgt[kTc01 * GK + i] = p.tgt_covs[tr * 4 + 1];
    tgt[kTc11 * GK + i] = p.tgt_covs[tr * 4 + 3];
    tgt[kTw * GK + i] = p.tgt_ws[tr];
  }
  const unsigned char* sel_r = p.sel + static_cast<size_t>(r) * P;
  for (int e = threadIdx.x; e < P; e += kThreads) sel[e] = sel_r[e];
  float x = p.T0[r * 3], y = p.T0[r * 3 + 1], th = p.T0[r * 3 + 2];
  __syncthreads();
  pose_terms(pose, src, GK, x, y, cosf(th), sinf(th), p);
  __syncthreads();
  float f = value_pass(pose, tgt, src, sel, part, tot, GK, P, p);
  float lam = static_cast<float>(1e-3);
  for (int it = 0; it < p.iters; ++it) {
    grad_hess_pass(pose, tgt, src, sel, part, tot, GK, P, p);
    float dx[3];
    lm_step(tot, lam, dx);
    const float nx = add(x, dx[0]), ny = add(y, dx[1]);
    const float nth = add(th, dx[2]);
    pose_terms(trial, src, GK, nx, ny, cosf(nth), sinf(nth), p);
    __syncthreads();
    const float fn = value_pass(trial, tgt, src, sel, part, tot, GK, P, p);
    const bool ok = fn < f && isfinite(nx) && isfinite(ny) && isfinite(nth);
    if (ok) {
      x = nx;
      y = ny;
      th = nth;
      f = fn;
      float* t = pose;
      pose = trial;
      trial = t;
    }
    lam = ok ? mul(lam, static_cast<float>(0.33))
             : mul(lam, static_cast<float>(10.0));
  }
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(clamp_min(
        mul(p.src_ac[r], p.tgt_ac[ti]), static_cast<float>(1e-12)));
    p.corr[r] = __fdiv_rn(-f, norm);
    p.T[r * 3] = x;
    p.T[r * 3 + 1] = y;
    p.T[r * 3 + 2] = th;
  }
}

}  // namespace

extern "C" int cc_gmm_lm(const void* src_mus, const void* src_covs,
                         const void* src_ws, const void* src_ac,
                         const void* tgt_mus, const void* tgt_covs,
                         const void* tgt_ws, const void* tgt_ac,
                         const void* sel, const void* T0, void* corr, void* T,
                         int rows, int rows_per_tgt, int G, int K, int iters,
                         float scale, float m2_scale, float two_scale,
                         float m4_scale, void* stream) {
  if (rows < 0 || rows_per_tgt < 1 || G < 1 || K < 1 || iters < 0 ||
      rows % rows_per_tgt != 0 ||
      static_cast<long long>(G) * K * K >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int GK = G * K;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kTgtFields + kSrcFields +
                                           2 * kPoseFields) * GK +
                       kWarps * kHessSums + 16) +
      static_cast<size_t>(GK) * K;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Params p;
  p.src_mus = static_cast<const float*>(src_mus);
  p.src_covs = static_cast<const float*>(src_covs);
  p.src_ws = static_cast<const float*>(src_ws);
  p.src_ac = static_cast<const float*>(src_ac);
  p.tgt_mus = static_cast<const float*>(tgt_mus);
  p.tgt_covs = static_cast<const float*>(tgt_covs);
  p.tgt_ws = static_cast<const float*>(tgt_ws);
  p.tgt_ac = static_cast<const float*>(tgt_ac);
  p.sel = static_cast<const unsigned char*>(sel);
  p.T0 = static_cast<const float*>(T0);
  p.corr = static_cast<float*>(corr);
  p.T = static_cast<float*>(T);
  p.rows_per_tgt = rows_per_tgt;
  p.G = G;
  p.K = K;
  p.iters = iters;
  p.g2 = scale;
  p.m2g2 = m2_scale;
  p.two_g2 = two_scale;
  p.m4g2 = m4_scale;
  p.by_k = make_fastdiv(static_cast<unsigned>(K));
  gmm_lm_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
