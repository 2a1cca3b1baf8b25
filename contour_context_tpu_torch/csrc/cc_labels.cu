// 8-connected component labels of N binary masks, to their fixpoint in one
// launch.
//
// Replaces: contour_context_tpu/ops/descriptor.py, cc_labels (the
// lax.while_loop that propagates labels to their fixpoint, :280). There is
// no Pallas kernel behind it; the JAX package runs the loop on the device
// with no host round trip, and the port's plain version
// (ops/kernels.cc_labels_plain) checks its fixpoint on the host once a
// propagate. This kernel takes that check off the host.
//
//   labels[i, p] = min { q : q in the 8-connected component of pixel p of
//                        mask i }   for a foreground p,
//   labels[i, p] = S = nr * nc      for a background p.
//
// The answer is unique, so any correct algorithm is bit-equal to the plain
// version and to the JAX function.
//
// What bounds it on the card: it must read each mask byte once and write
// each int32 label once: 5 bytes a pixel, 10.8 MB for the 96 masks of a
// block of 16 scans (6 levels, 150 x 150), ~3.2 us by bytes; a scan's 6
// masks are 0.68 MB (0.2 us), far under a launch's own cost. The work is a
// union-find whose depth follows the components' shapes, so the real floor
// is latency: the barrier-separated phases, the serial chains inside each
// (a union's finds, a strip root's chase), and how many SMs a launch
// spreads over.
//
// Design. A thread-block cluster of kCluster = 8 CTAs a mask (the portable
// cluster size; grid (8, N), cluster (8, 1, 1), launched with
// cudaLaunchKernelEx and cudaLaunchAttributeClusterDimension, which CUDA
// graph capture records like any launch): CTA k labels the strip of rows
// [k h, min((k + 1) h, nr)), h = ceil(nr / 8) (19 rows at 150 x 150), so a
// scan runs on 48 SMs and a block's 768 CTAs fit in one wave: 192 threads
// and at most 40 registers a thread let eight CTAs share an SM, and
// cudaOccupancyMaxActiveClusters (kernel_times reads it through
// cc_cc_labels_max_active_clusters) must reach the block's 96 clusters (at
// 256 threads and six CTAs an SM it read 92, and 4 clusters waited for a
// second wave). With uniform strips the owner of a global index x is
// x / (h nc), and the row above a non-empty strip always lies in the
// previous CTA's strip; strips past nr are empty (nr < 8, or 37 rows: 5 a
// strip, the last 2) and only take part in the barriers. The union-find
// runs over runs, not pixels: a row is kept as 32-column words of
// foreground bits, a run's node is the slot of its first pixel, labelled
// by its global linear index, so a root is still the component's minimum
// pixel, and most of the work is a few word operations a 32 pixels.
// Phases:
//   1. load: the halo row (the row above the strip) and the strip's rows
//      are one contiguous byte range, read a 16-byte chunk a thread (one
//      16-byte load where the chunk lies inside the range, single bytes at
//      its two ends: a strip starts at r0 nc, 2850 at 150 x 150, on no
//      4-byte boundary) and kept as a bit stream, a bit a byte;
//   2. rows: a thread a row cuts its 32-column foreground words out of the
//      stream (a funnel shift each), finds each word's run starts (w &
//      ~(w << 1 | carry-in)) and the start of the run entering each word;
//      each run start of the strip becomes a node, its own root;
//   3. strip unions, a thread a (row, word): a pixel is united with the row
//      above only where it first touches a run there (with its upper
//      neighbour when that is foreground and the left pair is not both
//      foreground; else with its upper-left when its left one is
//      background, with its upper-right when its right one is background),
//      found for 32 pixels at once with word operations: one union a pair
//      of touching runs, between their first pixels. A union links the
//      larger root under the smaller with atomicMin and retries from the
//      root it lost to (Playne and Hawick); finds halve the path;
//   4. strip flatten: each run points at its strip root (finds that do
//      not halve), and a bit a run marks the strip roots; then
//      cluster.sync();
//   5. boundary unions, a warp a word and a lane a pixel: the strip's
//      first row against the halo (whose runs are the previous CTA's
//      nodes), by the rule of phase 3, through distributed shared memory:
//      a find reads the owner CTA's slot through cluster.map_shared_rank,
//      a link is an atomicMin on the owner's mapped slot, the larger root
//      still under the smaller; then cluster.sync();
//   6. root chase: each strip root that phase 5 linked follows its parents
//      to the component's root (reads through the other CTAs' shared
//      memory) and stores it; then the CTA arrives at a cluster barrier
//      and waits on it only before it exits (no CTA may leave while
//      another still reads its shared memory), so the barrier's latency
//      hides behind phase 7;
//   7. write: a pixel's label is the stored root of its run's strip root,
//      a warp a (row, word), four in flight, written coalesced.
// Remote atomics are relaxed: no CTA reads another's slots before the
// cluster barrier after phase 4, and the barriers (release / acquire)
// order every write before them.
//
// Path halving beside a concurrent atomicMin is safe. A slot only ever
// holds an index no larger than its own (a link stores a smaller root, a
// halving store the parent of the parent), so the parents form no cycle
// and every find ends at a slot that holds itself. A halving store writes
// only to a slot it read as a non-root, and a non-root never becomes a
// root again. It may overwrite a link that a stale union made into a slot
// that had stopped being a root (atomicMin returned another parent), but
// that union goes on to unite the smaller root with the returned parent,
// so the sets stay whole. When no union is left, a set's one root is its
// least index, since every parent is smaller than its child. Phases 4, 5
// and 6 do not halve: in phase 4 a slower halving store of an older
// ancestor could land after a run's stored strip root and replace it, and
// a run that phase 4 pointed at its strip root must keep that parent (only
// roots are linked later), which phase 7 relies on.
//
// Launch requirements: S = nr * nc < 2^15 (ops/kernels.cc_labels checks
// it), N <= 65535 masks; shared memory (h + 1) nc / 8 bytes of mask bits,
// 4 h nc of slots and 4 (4 h + 3) ceil(nc / 32) of words a CTA (13.4 KB
// at 150 x 150; at most ~168 KB, at nr = 1), 8 CTAs co-scheduled in one
// GPC. A launch that is refused returns its error; there is no fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;       // CTAs a mask: the portable cluster size
constexpr int kThreads = 192;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 8;     // CTAs an SM: a block's 96 clusters at once
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a CTA
constexpr int kStampSlots = 16;
constexpr unsigned kFull = 0xffffffffu;

template <bool Stamp>
__device__ __forceinline__ void stamp(long long* stamps, int i) {
  if (Stamp && threadIdx.x == 0)
    stamps[(static_cast<size_t>(blockIdx.y) * kCluster + blockIdx.x) *
               kStampSlots + i] = clock64();
}

// The shared memory of a CTA whose strip has h rows of nc columns, W =
// ceil(nc / 32) words a row; rows of the word arrays: 0 the halo (the row
// above the strip), 1 + r the strip's row r.
struct Layout {
  int bits, slots, fg, st, cy, rt, bytes;
  __host__ __device__ Layout(int h, int nc) {
    const int W = (nc + 31) / 32;
    const int chunks = ((h + 1) * nc + 15) / 16 + 1;   // of 16 mask bytes
    bits = 0;                               // a bit a mask byte, 2 words pad
    slots = (chunks + 1) / 2 * 4 + 8;       // int32 a pixel
    fg = slots + 4 * h * nc;                // foreground words
    st = fg + 4 * (h + 1) * W;              // run-start words
    cy = st + 4 * (h + 1) * W;              // run start entering a word
    rt = cy + 4 * (h + 1) * W;              // strip-root words
    bytes = rt + 4 * h * W;
  }
};

// bit i of the result: byte i of x is not 0 (x holds 4 mask bytes)
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// Phases 2-4 work inside the strip: x is a global index, L holds the
// strip's slots from global index `base` on.
__device__ __forceinline__ int find_strip(volatile int* L, int x, int base) {
  while (true) {
    const int y = L[x - base];
    if (y == x) return x;
    const int z = L[y - base];
    if (z == y) return y;
    L[x - base] = z;                 // path halving
    x = z;
  }
}

// the same find without halving: what phase 4 stores must stay stored
__device__ __forceinline__ int root_strip(const volatile int* L, int x,
                                          int base) {
  while (true) {
    const int y = L[x - base];
    if (y == x) return x;
    x = y;
  }
}

__device__ __forceinline__ void unite_strip(int* L, int a, int b, int base) {
  while (true) {
    a = find_strip(L, a, base);
    b = find_strip(L, b, base);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // b is the larger root: hang it under a, unless another thread gave it
    // a parent first; then unite a with that parent
    const int old = atomicMin(&L[b - base], a);
    if (old == b) return;
    b = old;
  }
}

// Phases 5-6 cross strips: global index x lives in CTA x / ss of the
// cluster (ss = h nc), at slot x % ss of its shared memory.
__device__ __forceinline__ volatile int* slot(cg::cluster_group& cl,
                                              int* L, int x, int ss) {
  const int k = x / ss;
  return static_cast<volatile int*>(cl.map_shared_rank(L, k)) + (x - k * ss);
}

__device__ __forceinline__ int find_cluster(cg::cluster_group& cl, int* L,
                                            int x, int ss) {
  while (true) {
    const int y = *slot(cl, L, x, ss);
    if (y == x) return x;
    x = y;
  }
}

__device__ __forceinline__ void unite_cluster(cg::cluster_group& cl, int* L,
                                              int a, int b, int ss) {
  while (true) {
    a = find_cluster(cl, L, a, ss);
    b = find_cluster(cl, L, b, ss);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(const_cast<int*>(slot(cl, L, b, ss)), a);
    if (old == b) return;
    b = old;
  }
}

// The column where the run of foreground pixel c starts, from its row's
// run-start words st and the run start entering each word, cy.
__device__ __forceinline__ int run_start(const unsigned* st, const int* cy,
                                         int c) {
  const int j = c >> 5;
  const unsigned s = st[j] & (kFull >> (31 - (c & 31)));
  return s ? (j << 5) + 31 - __clz(s) : cy[j];
}

// The unions of word j of a row (foreground words f, run starts st / cy,
// global index of its column 0 g) with the row above (fu, stu, cyu, gu):
// one at each pixel where the row first touches a run above (see the note
// at the top), pixel and neighbour replaced by their runs' starts; only at
// the word's pixels in `mine` (a thread takes a whole word, a lane one
// pixel of it).
template <typename Unite>
__device__ __forceinline__ void unite_word(
    const unsigned* f, const unsigned* st, const int* cy, int g,
    const unsigned* fu, const unsigned* stu, const int* cyu, int gu, int j,
    int W, unsigned mine, Unite unite) {
  const unsigned w = f[j], u = fu[j];
  const unsigned lw = (w << 1) | (j > 0 ? f[j - 1] >> 31 : 0u);
  const unsigned lu = (u << 1) | (j > 0 ? fu[j - 1] >> 31 : 0u);
  const unsigned ru = (u >> 1) | (j + 1 < W ? fu[j + 1] << 31 : 0u);
  const unsigned rw = (w >> 1) | (j + 1 < W ? f[j + 1] << 31 : 0u);
  const unsigned up = w & u & ~(lw & lu);      // with the pixel above
  const unsigned ul = w & ~u & lu & ~lw;       // with the upper-left one
  const unsigned ur = w & ~u & ru & ~rw;       // with the upper-right one
  for (unsigned any = (up | ul | ur) & mine; any; any &= any - 1) {
    const int b = __ffs(any) - 1;
    const int c = (j << 5) + b;
    const int a = g + run_start(st, cy, c);
    if ((up >> b) & 1u) unite(a, gu + run_start(stu, cyu, c));
    if ((ul >> b) & 1u) unite(a, gu + run_start(stu, cyu, c - 1));
    if ((ur >> b) & 1u) unite(a, gu + run_start(stu, cyu, c + 1));
  }
}

template <bool Stamp>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    cc_labels_kernel(const unsigned char* __restrict__ masks,
                     int* __restrict__ labels, int nr, int nc, int h,
                     long long* stamps) {
  stamp<Stamp>(stamps, 0);
  cg::cluster_group cl = cg::this_cluster();
  const int S = nr * nc;
  const int W = (nc + 31) / 32;
  const int ss = h * nc;                          // slots a strip
  const int r0 = static_cast<int>(blockIdx.x) * h;
  const int rows = r0 < nr ? min(h, nr - r0) : 0;
  const int base = r0 * nc;                       // first global index
  const int halo = r0 > 0 && rows > 0;            // a row above to read
  const unsigned char* m = masks + static_cast<size_t>(blockIdx.y) * S;
  int* out = labels + static_cast<size_t>(blockIdx.y) * S + base;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(h, nc);
  unsigned short* Bh = reinterpret_cast<unsigned short*>(smem + lay.bits);
  const unsigned* Bw = reinterpret_cast<const unsigned*>(smem + lay.bits);
  int* L = reinterpret_cast<int*>(smem + lay.slots);
  unsigned* Fg = reinterpret_cast<unsigned*>(smem + lay.fg);
  unsigned* St = reinterpret_cast<unsigned*>(smem + lay.st);
  int* Cy = reinterpret_cast<int*>(smem + lay.cy);
  unsigned* Rt = reinterpret_cast<unsigned*>(smem + lay.rt);

  // 1. load the halo row's and the strip's bytes (one contiguous range
  //    [lo, hi)) as a bit stream: bit i is the byte at address A0 + i, A0
  //    the range's start rounded down to 16; a thread a 16-byte chunk, one
  //    16-byte load where the chunk lies inside the range, single bytes at
  //    its two ends, 16 bits stored
  const uintptr_t lo =
      reinterpret_cast<uintptr_t>(m + base - (halo ? nc : 0));
  const uintptr_t hi = reinterpret_cast<uintptr_t>(m + base + rows * nc);
  const uintptr_t A0 = lo & ~uintptr_t{15};
  for (int i = t; A0 + 16 * static_cast<uintptr_t>(i) < hi; i += kThreads) {
    const uintptr_t a = A0 + 16 * static_cast<uintptr_t>(i);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (a >= lo && a + 16 <= hi) {
      v = __ldg(reinterpret_cast<const uint4*>(a));
    } else {
      unsigned char b[16];
#pragma unroll
      for (int q = 0; q < 16; ++q)
        b[q] = a + q >= lo && a + q < hi
                   ? __ldg(reinterpret_cast<const unsigned char*>(a + q))
                   : 0;
      v.x = b[0] | b[1] << 8 | b[2] << 16 | static_cast<unsigned>(b[3]) << 24;
      v.y = b[4] | b[5] << 8 | b[6] << 16 | static_cast<unsigned>(b[7]) << 24;
      v.z = b[8] | b[9] << 8 | b[10] << 16 |
            static_cast<unsigned>(b[11]) << 24;
      v.w = b[12] | b[13] << 8 | b[14] << 16 |
            static_cast<unsigned>(b[15]) << 24;
    }
    Bh[i] = static_cast<unsigned short>(nibble(v.x) | nibble(v.y) << 4 |
                                        nibble(v.z) << 8 | nibble(v.w) << 12);
  }
  __syncthreads();
  stamp<Stamp>(stamps, 1);

  // 2. rows: a thread a row cuts its 32-column words out of the bit stream
  //    (a funnel shift each), finds each word's run starts (w & ~(w << 1 |
  //    carry-in)) and the start of the run entering each word; each run
  //    start of the strip becomes a union-find node, its own root
  {
    // the stream's bit of the halo row's first byte (negative without a
    // halo)
    const int row0 = static_cast<int>(
        static_cast<intptr_t>(reinterpret_cast<uintptr_t>(m) - A0) + base -
        nc);
    const unsigned last = kFull >> (31 - ((nc - 1) & 31));
    for (int R = halo ? t : t + 1; R <= rows; R += kThreads) {
      int carry = -1;
      unsigned cin = 0;
      for (int j = 0; j < W; ++j) {
        const int o = row0 + R * nc + (j << 5);
        unsigned w = __funnelshift_r(Bw[o >> 5], Bw[(o >> 5) + 1], o & 31);
        if (j == W - 1) w &= last;
        const unsigned s = w & ~((w << 1) | cin);
        Fg[R * W + j] = w;
        St[R * W + j] = s;
        Cy[R * W + j] = carry;
        if (s) carry = (j << 5) + 31 - __clz(s);
        cin = w >> 31;
        if (R > 0)
          for (unsigned b = s; b; b &= b - 1) {
            const int i = (R - 1) * nc + (j << 5) + __ffs(b) - 1;
            L[i] = base + i;
          }
      }
    }
  }
  __syncthreads();
  stamp<Stamp>(stamps, 2);

  // 3. unions between the strip's rows: a thread a (row, word)
  {
    const auto unite = [&](int a, int b) { unite_strip(L, a, b, base); };
    for (int k = t; k < (rows - 1) * W; k += kThreads) {
      const int R = 2 + k / W, j = k % W;         // strip row R - 1 >= 1
      unite_word(Fg + R * W, St + R * W, Cy + R * W, base + (R - 1) * nc,
                 Fg + (R - 1) * W, St + (R - 1) * W, Cy + (R - 1) * W,
                 base + (R - 2) * nc, j, W, kFull, unite);
    }
  }
  __syncthreads();
  stamp<Stamp>(stamps, 3);

  // 4. flatten the strip's runs to their strip roots, and mark the roots
  for (int k = t; k < rows * W; k += kThreads) {
    const int R = 1 + k / W, j = k % W;
    unsigned roots = 0;
    for (unsigned b = St[R * W + j]; b; b &= b - 1) {
      const int x = base + (R - 1) * nc + (j << 5) + __ffs(b) - 1;
      const int rt = root_strip(L, x, base);
      L[x - base] = rt;
      if (rt == x) roots |= b & (~b + 1);
    }
    Rt[k] = roots;
  }
  cl.sync();
  stamp<Stamp>(stamps, 4);

  // 5. unions across the strip boundary (the strip's first row against the
  //    halo, whose runs are the previous CTA's), through distributed
  //    shared memory: a warp a word, a lane a pixel, so that the remote
  //    finds of one word run side by side
  if (halo) {
    const auto unite = [&](int a, int b) { unite_cluster(cl, L, a, b, ss); };
    for (int j = warp; j < W; j += kWarps)
      unite_word(Fg + W, St + W, Cy + W, base, Fg, St, Cy, base - nc, j, W,
                 1u << lane, unite);
  }
  cl.sync();
  stamp<Stamp>(stamps, 5);

  // 6. each strip root that phase 5 linked stores its component's root
  for (int k = t; k < rows * W; k += kThreads) {
    const int r = k / W, j = k % W;
    for (unsigned b = Rt[k]; b; b &= b - 1) {
      const int i = r * nc + (j << 5) + __ffs(b) - 1;
      const int p = L[i];
      if (p != base + i) L[i] = find_cluster(cl, L, p, ss);
    }
  }
  // this CTA is done reading the others: arrive now and wait only before
  // exiting, so that the cluster barrier's latency hides behind the write
  __syncthreads();
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  stamp<Stamp>(stamps, 6);

  // 7. a pixel's label: the stored root of its run's strip root (a strip
  //    root holds the component's root itself, which may lie in another
  //    strip); a warp a (row, word), four in flight, the writes coalesced
  for (int k0 = warp * 4; k0 < rows * W; k0 += kWarps * 4) {
    int lab[4], at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u, r = k / W, j = k - r * W, c = (j << 5) + lane;
      at[u] = k < rows * W && c < nc ? r * nc + c : -1;
      lab[u] = S;
      if (at[u] >= 0 && (Fg[(r + 1) * W + j] >> lane) & 1u)
        lab[u] = L[r * nc + run_start(St + (r + 1) * W, Cy + (r + 1) * W, c)];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (lab[u] != S && lab[u] >= base) lab[u] = L[lab[u] - base];
      if (at[u] >= 0) out[at[u]] = lab[u];
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (Stamp) {
    __syncthreads();
    stamp<Stamp>(stamps, 7);
  }
}

template <bool Stamp>
int launch_cc(const void* masks, void* labels, int n_masks, int nr, int nc,
              long long* stamps, void* stream) {
  if (n_masks < 0 || n_masks > 65535 || nr <= 0 || nc <= 0 ||
      static_cast<long long>(nr) * nc >= (1 << 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_masks == 0) return 0;
  const int h = (nr + kCluster - 1) / kCluster;
  const Layout lay(h, nc);
  if (lay.bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        cc_labels_kernel<Stamp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, n_masks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, cc_labels_kernel<Stamp>, static_cast<const unsigned char*>(masks),
      static_cast<int*>(labels), nr, nc, h, stamps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cc_cc_labels(const void* masks, void* labels, int n_masks,
                            int nr, int nc, void* stream) {
  return launch_cc<false>(masks, labels, n_masks, nr, nc, nullptr, stream);
}

// Measurement only (kernel_times.cc_phase_split; the main path never calls
// it): the same kernel with thread 0 of each CTA writing clock64() at each
// phase boundary into stamps[cta * 16 + i], i = 0 .. the number of phases.
extern "C" int cc_cc_labels_phases(const void* masks, void* labels,
                                   int n_masks, int nr, int nc, void* stamps,
                                   void* stream) {
  return launch_cc<true>(masks, labels, n_masks, nr, nc,
                         static_cast<long long*>(stamps), stream);
}

extern "C" const char* cc_cc_labels_phase_names() {
  return "load,rows,strip unions,strip flatten+cluster sync,"
         "boundary unions+cluster sync,root chase,write+cluster wait";
}

extern "C" int cc_cc_labels_ctas_per_mask() { return kCluster; }

// Measurement only: how many clusters of this kernel the card holds at once
// for nr x nc masks (cudaOccupancyMaxActiveClusters), or -(CUDA error).
extern "C" int cc_cc_labels_max_active_clusters(int nr, int nc) {
  const int h = (nr + kCluster - 1) / kCluster;
  const Layout lay(h, nc);
  cudaError_t e = cudaFuncSetAttribute(
      cc_labels_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, cc_labels_kernel<false>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
