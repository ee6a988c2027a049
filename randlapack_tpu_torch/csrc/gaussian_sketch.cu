// Fused generate-and-apply Gaussian sketch for Hopper (sm_90a). Replaces
// the Pallas TPU kernel gaussian_sketch of
// randlapack_tpu/ops/pallas_kernels.py:125 (pallas_call at :166):
//
//   out = S A,   S (d, m) ~ N(0, 1/d) made inside the kernel,
//   A (m, n)  ->  out (d, n)
//
// S never exists in device memory. Entry S[i][r] is a function of
// (seed, i, r) alone, not of the tiling or the grid: Philox4x32-10 (the
// counter-based generator of Random123, written out below) on the
// counter (r / 4, i, 0, 0) with the key (seed's low word, its high word)
// gives four 32-bit words w0..w3; the low 23 bits of each make a uniform
// in [0, 1); u1 is floored at 1e-7; Box-Muller on (w0, w1) and (w2, w3)
// gives two pairs of normals, and this kernel uses BOTH branches:
//   S[i][4q + 0] = sqrt(-2 ln u1(w0)) cos(2 pi u2(w1)) / sqrt(d)
//   S[i][4q + 1] = sqrt(-2 ln u1(w0)) sin(2 pi u2(w1)) / sqrt(d)
//   S[i][4q + 2], S[i][4q + 3] likewise from (w2, w3).
// (The TPU kernel used the cosine branch only, on the TPU's own PRNG.)
// The plain version in ops/kernels.py builds the same S from the same
// words with integer tensor operations.
//
// What bounds it on an H100: operations (2 d m n flops against 4 m n
// bytes of A), and beside the product the generation of S: a Philox call
// and two Box-Muller transforms are about 170 instructions for four
// entries even in their cheapest form, and every 128 x 128 tile of out
// needs all m entries of its 128 rows of S. Generated once per tile, S
// costs more multiprocessor time than the product on the tensor cores.
//
// The fp32 design (sketch_ws_kernel) runs the product on the tensor cores,
// the generation beside it, and shares what is generated:
//
// - Product. Three TF32 products per fp32 product on
//   wgmma.mma_async.m64n128k8, as K1/K2 of wy.cu (tc.cuh holds what they
//   share): out^T = A^T S^T per 128 x 128 tile of out. One Philox call
//   yields S[i][4q .. 4q+3], four consecutive reduction indices of one
//   row of S, which is exactly one 16-byte row of a K-major core matrix:
//   the generator splits its four values into TF32 halves and stores hi
//   and lo straight into the layout wgmma reads as its shared operand,
//   followed by fence.proxy.async. A is the register operand: each warp
//   reads its 16 columns of the raw [k][n] tile in the fragment layout
//   and splits them there.
// - Chunked accumulation. The reduction is m long and the tensor cores
//   add with truncation, so the wgmma accumulator starts from zero every
//   `chunk` stages of 32 and is folded with FADD into a second set of
//   registers (default: every stage).
// - Roles. Warps 8-11 (one warpgroup, setmaxnreg.dec to 40 registers) only
//   generate: they fill a ring of 5 S buffers (hi and lo, 32 KB each)
//   ahead of the consumers, handing each over by an mbarrier pair (full,
//   empty). Warps 0-7 (two warpgroups, setmaxnreg.inc to 232) own 64
//   columns of the tile each: they copy their own 32 x 64 slice of A
//   through a 3-stage cp.async ring (16-byte copies in their zero-fill
//   form; a named barrier per warpgroup, no block barrier), fetch a
//   stage's fragments while the stage before is on the tensor cores,
//   split them, wait for the S tile, multiply and fold. The two branches
//   never meet again.
// - Clusters. The 4 blocks of a thread-block cluster take neighbouring
//   column tiles of out for the same rows of S and walk the reduction
//   together. Each block's producers generate a quarter of
//   every S tile into their own buffer, and one lane of each producer
//   warp sends its warp's share (whole core-matrix rows, contiguous) to
//   the same place in the other blocks by cp.async.bulk through
//   distributed shared memory; the receiver's full barrier counts those
//   bytes (expect_tx / complete_tx), so no cluster-wide fence is needed
//   (cluster-scope release/acquire on every hand-over was tried first and
//   cost more than the generation it saved). A buffer is refilled from
//   every block, so its empty barrier counts the consumer warps of the
//   whole cluster (remote arrivals). S is thus generated once per 512
//   columns of out instead of once per 128.
// - Cheaper entries. The fp32 Box-Muller of these kernels evaluates the
//   definition's formulas without conversions or library calls
//   (box_muller_fast below); against the plain S it stays within 2e-7.
// - Tiles. Persistent: one cluster per 4 multiprocessors walks over work
//   items, rows of S fastest, so the blocks that run together read the
//   same rows of A and the 50 MB L2 serves most of the d/128 passes over
//   it. The reduction of every tile is split into `splits` parts (the
//   wrapper chooses the count that fills the last wave), each an item of
//   its own written to `part`, and a second kernel adds the parts in index
//   order: no float atomics, two launches are bit-equal.
//
// Non-finite entries of A: Inf splits into hi = Inf and a lo that is NaN
// or garbled, so an Inf that the plain version carries through as +-Inf
// may come out NaN; a column of out is non-finite exactly where the plain
// version's is.
//
// Guarded path. 16-byte copies need A 16-byte aligned and n a multiple of
// 4; the tensor-core entry point refuses anything else
// (cudaErrorInvalidValue) and the wrapper sends such operands, and all of
// f64, to the SIMT kernel below: each block owns a 64 x 128 tile of out
// and walks over all of m in steps of 16; each of the 256 threads makes
// one Philox call a step (4 entries of the 64 x 16 tile of S, written to
// shared memory, with the library's logf, sqrtf and sincosf) and
// accumulates a 4 x 8 micro-tile in FFMA/DFMA. The fp32 SIMT kernel also
// stays reachable on its own (rl_gaussian_sketch_simt_f32) as the
// yardstick of the earlier design.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "tc.cuh"

namespace {

// ---------------------------------------------------------------------
// S's entries, and the SIMT kernel: fp64, and fp32 for the guarded path
// ---------------------------------------------------------------------

constexpr int kBD = 64;              // rows of out (and of S) per block
constexpr int kBN = 128;             // columns of out per block
constexpr int kDK = 16;              // step over m (4 Philox quads)
constexpr int kRows = 4;             // micro-tile rows per thread
constexpr int kCols = 8;             // micro-tile columns per thread
constexpr int kLanes = 16;
constexpr int kThreads = kLanes * kLanes;   // 256 = kBD * kDK / 4

// four neighbouring values, read from shared memory in one piece
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T v[4];
};

__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t w[4]) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  w[0] = c0; w[1] = c1; w[2] = c2; w[3] = c3;
}

__device__ __forceinline__ void sincos_t(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

// Box-Muller on two words: both branches, scaled
template <typename T>
__device__ __forceinline__ void box_muller(uint32_t wa, uint32_t wb, T scale,
                                           T* zc, T* zs) {
  T u1 = T(wa & 0x7FFFFFu) * T(1.0 / 8388608.0);
  const T u2 = T(wb & 0x7FFFFFu) * T(1.0 / 8388608.0);
  u1 = u1 > T(1e-7) ? u1 : T(1e-7);
  const T radius = sqrt_t(T(-2) * log_t(u1));
  T sn, cs;
  sincos_t(T(6.283185307179586) * u2, &sn, &cs);
  *zc = (radius * cs) * scale;
  *zs = (radius * sn) * scale;
}

// The same two branches in fp32 by cheaper evaluations of the same
// formulas, free of conversion instructions and of library calls:
// - a 23-bit uniform k / 2^23 is the float with k as its mantissa, minus 1
//   (exact);
// - ln u1 = lg2.approx(u1) ln 2, whose absolute error of about 1e-7 moves
//   the radius by 1e-7 / radius; above u1 = 0.998, where the radius falls
//   below 0.06, the series -t - t^2/2 - t^3/3 in t = 1 - u1 (exact) takes
//   over; the radius itself by sqrt.approx (relative error 2^-23);
// - the angle 2 pi k / 2^23: the top three bits of k name the octant, the
//   other twenty the place in it, mirrored in the odd octants, so that
//   sine and cosine are two short polynomials on [0, pi/4] (the Cephes
//   sinf/cosf coefficients, an ulp or two), swapped and signed by octant.
//   No rounding of 2 pi u2 to fp32, which the plain version has.
// Measured on the card against the plain S: within 2e-7 at d = 70.
__device__ __forceinline__ void box_muller_fast(uint32_t wa, uint32_t wb,
                                                float scale, float* zc,
                                                float* zs) {
  float u1 = __uint_as_float(0x3F800000u | (wa & 0x7FFFFFu)) - 1.0f;
  u1 = u1 > 1e-7f ? u1 : 1e-7f;
  float lg;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(lg) : "f"(u1));
  const float t = 1.0f - u1;
  const float near1 = -t * fmaf(t, fmaf(t, 0.33333334f, 0.5f), 1.0f);
  const float ln = u1 > 0.998f ? near1 : lg * 0.69314718f;
  float radius;
  asm("sqrt.approx.ftz.f32 %0, %1;\n" : "=f"(radius) : "f"(-2.f * ln));
  radius *= scale;
  // place in the octant, from the far end in the odd ones: y in [0, 1]
  const uint32_t k = wb & 0x7FFFFFu;
  const uint32_t oct = k >> 20;
  const uint32_t low = k & 0xFFFFFu;
  const uint32_t f = (oct & 1u) ? 0x100000u - low : low;
  // f / 2^20 exactly: f has at most 21 bits
  const float y = __uint_as_float(0x4B000000u | f) - 8388608.0f;
  const float x = y * (0.78539816f / 1048576.0f);
  const float x2 = x * x;
  const float sp = x * fmaf(x2, fmaf(x2, fmaf(x2, -1.9515295891e-4f,
                                              8.3321608736e-3f),
                                     -1.6666654611e-1f), 1.0f);
  const float cp = fmaf(x2 * x2, fmaf(x2, fmaf(x2, 2.443315711809948e-5f,
                                               -1.388731625493765e-3f),
                                      4.166664568298827e-2f),
                        fmaf(x2, -0.5f, 1.0f));
  // octants 1, 2, 5, 6 take the sine from the cosine polynomial and the
  // other way round; sine is negative in octants 4-7, cosine in 2-5
  const bool swap = ((oct + 1u) & 2u) != 0u;
  float sn = swap ? cp : sp;
  float cs = swap ? sp : cp;
  sn = (oct & 4u) ? -sn : sn;
  cs = ((oct + 2u) & 4u) ? -cs : cs;
  *zc = radius * cs;
  *zs = radius * sn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gaussian_sketch_kernel(const T* __restrict__ A, T* __restrict__ out, int d,
                       int m, int n, uint32_t key0, uint32_t key1, T scale) {
  __shared__ __align__(32) T Ss[kDK][kBD];   // S tile, transposed (r, i)
  __shared__ __align__(32) T As[kDK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int ty = tid / kLanes;
  const int i0 = blockIdx.y * kBD;
  const int j0 = blockIdx.x * kBN;
  const int gi = tid % kBD;          // this thread generates row i0 + gi,
  const int gq = tid / kBD;          // quad gq of each step

  T acc[kRows][kCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b < kCols; ++b) acc[a][b] = T(0);

  for (int r0 = 0; r0 < m; r0 += kDK) {
    uint32_t w[4];
    philox4x32_10((uint32_t)(r0 / 4 + gq), (uint32_t)(i0 + gi), 0u, 0u,
                  key0, key1, w);
    T z0, z1, z2, z3;
    box_muller<T>(w[0], w[1], scale, &z0, &z1);
    box_muller<T>(w[2], w[3], scale, &z2, &z3);
    Ss[4 * gq + 0][gi] = z0;
    Ss[4 * gq + 1][gi] = z1;
    Ss[4 * gq + 2][gi] = z2;
    Ss[4 * gq + 3][gi] = z3;
    for (int e = tid; e < kDK * kBN; e += kThreads) {
      const int kk = e / kBN, jj = e % kBN;
      const int r = r0 + kk, j = j0 + jj;
      As[kk][jj] = (r < m && j < n) ? A[(size_t)r * n + j] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      const Quad<T> sv = *reinterpret_cast<const Quad<T>*>(&Ss[kk][4 * ty]);
      const Quad<T> a0 = *reinterpret_cast<const Quad<T>*>(&As[kk][4 * tx]);
      const Quad<T> a1 =
          *reinterpret_cast<const Quad<T>*>(&As[kk][kBN / 2 + 4 * tx]);
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] += sv.v[a] * a0.v[b];
          acc[a][4 + b] += sv.v[a] * a1.v[b];
        }
    }
    __syncthreads();
  }

  // micro-tile: rows i0 + 4 ty + a, columns j0 + 4 tx + b and 64 further
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = i0 + 4 * ty + a;
    if (i >= d) continue;
#pragma unroll
    for (int b = 0; b < kCols; ++b) {
      const int j = j0 + (b / 4) * (kBN / 2) + 4 * tx + b % 4;
      if (j < n) out[(size_t)i * n + j] = acc[a][b];
    }
  }
}

// ---------------------------------------------------------------------
// fp32 on the tensor cores: 3xTF32 wgmma, S generated into wgmma's layout
// ---------------------------------------------------------------------

constexpr int BJ = 128;              // columns of out per tile (wgmma's M)
constexpr int BI = 128;              // rows of S and out per tile (wgmma's N)
constexpr int NT = BI / 8;           // 8-row groups of S across the tile
constexpr int kStages = 3;           // cp.async ring of A
constexpr int kWgCols = 64;          // columns of the tile a warpgroup owns
// row length of a warpgroup's raw A slice [k][column]: the pad puts the 32
// addresses of a fragment load (4 rows x 8 columns) on 32 banks
constexpr int LDA = kWgCols + 8;
constexpr int kSliceFloats = BK * LDA;
constexpr int kSFloats = BK * BI;    // one half (hi or lo) of an S tile
constexpr int kSBufs = 5;            // S ring of the producer warps
constexpr int kCluster = 4;          // blocks of a cluster, which share S
constexpr int kProducers = 4;        // producer warps of a block
constexpr int kARingFloats = 2 * kStages * kSliceFloats;
constexpr size_t kWsSmemBytes =
    (size_t)(kSBufs * 2 * kSFloats + kARingFloats) * sizeof(float) +
    2 * kSBufs * sizeof(uint64_t);

// Where a block is in its list of work: item `item` (a 128x128 tile of out
// for one part of the reduction), stage `kt` of its `nk`.
struct Cursor {
  int item, kt, nk;
  int i0, j0, kbeg;
};

// the list itself: rows of S fastest, then columns of out, then parts. An
// item is one tile for each of the kCluster blocks of a cluster, neighbours
// along the columns of out; block `rank` of the cluster takes the rank-th
// of them, which may lie past n (all zeros, not stored)
struct Walk {
  int items, tiles, nti, m, kper, step, rank;
  __device__ __forceinline__ void init(int d, int m_, int n, int kper_,
                                       int splits, int rank_,
                                       int first_step) {
    rank = rank_;
    nti = (d + BI - 1) / BI;
    tiles = nti * (((n + BJ - 1) / BJ + kCluster - 1) / kCluster);
    items = tiles * splits;
    m = m_;
    kper = kper_;
    step = first_step;
  }
  __device__ __forceinline__ void enter(Cursor& c, int item) const {
    c.item = item;
    c.kt = 0;
    if (item < items) {
      const int z = item / tiles, r = item - z * tiles;
      c.i0 = (r % nti) * BI;
      c.j0 = ((r / nti) * kCluster + rank) * BJ;
      c.kbeg = z * kper;
      c.nk = (min(m, c.kbeg + kper) - c.kbeg + BK - 1) / BK;   // >= 1
    }
  }
  __device__ __forceinline__ void advance(Cursor& c) const {
    if (++c.kt == c.nk) enter(c, c.item + step);
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// waits until the barrier has left the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// the address of this block's shared-memory address `addr` in block `rank`
// of the cluster
__device__ __forceinline__ uint32_t map_to_block(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// arrives at barrier `bar` (this block's address) of block `rank`; orders
// nothing but the barrier itself
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n"
               :: "r"(map_to_block(smem_u32(bar), rank)) : "memory");
}

// arrives at this block's `bar` and tells it to wait for `bytes` more of
// bulk copies as well
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// `bytes` from this block's `src` to the same place in block `rank`, by the
// copy engine; block `rank`'s barrier `bar` counts the bytes as they land
__device__ __forceinline__ void bulk_copy_to_block(const float* src,
                                                   int bytes, uint64_t* bar,
                                                   int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(map_to_block(smem_u32(src), rank)), "r"(smem_u32(src)),
         "r"(bytes), "r"(map_to_block(smem_u32(bar), rank)) : "memory");
}

// all threads of all blocks of the cluster meet
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// barrier `id` among the 128 threads of a warpgroup
__device__ __forceinline__ void bar_sync128(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// Rows [k0, k0+BK) x columns [c0, c0+64) of A (m x n, n % 4 == 0) into a
// warpgroup's slice s[BK][LDA], by its 128 threads; rows >= kend and
// columns >= n are zeros.
__device__ __forceinline__ void load_slice(float* s, const float* A, int n,
                                           int kend, int k0, int c0, int p) {
#pragma unroll
  for (int i = 0; i < BK * kWgCols / 4 / 128; ++i) {
    const int c = p + i * 128;
    const int r = c / (kWgCols / 4), c4 = (c % (kWgCols / 4)) * 4;
    const bool ok = (k0 + r < kend) && (c0 + c4 < n);
    const float* src = ok ? A + (size_t)(k0 + r) * n + (c0 + c4) : A;
    cp_async16(s + r * LDA + c4, src, ok ? 16 : 0);
  }
}

// a thread's raw A values of a stage: its warp's 16 columns of out in
// wgmma's fragment layout ([q][e]: column w16 + g + 8(e&1) of the slice,
// k 8q + t + 4(e>>1))
__device__ __forceinline__ void load_frag(float (&araw)[BK / 8][4],
                                          const float* s, int w16, int g,
                                          int t) {
#pragma unroll
  for (int q = 0; q < BK / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      araw[q][e] = s[(q * 8 + t + (e >> 1) * 4) * LDA + w16 + g + (e & 1) * 8];
}

// A warp's share of rows [i0, i0+128) x columns [k0, k0+32) of S as TF32
// halves in wgmma's core matrices: the kProducers warps in each of the
// kCluster blocks generate, warp w of block `rank` the RW = 8 rows from
// (rank kProducers + w) RW on, so its share is one whole core-matrix row,
// RW x 128 contiguous bytes of each half. A Philox call is one row of S
// and 4 of k, 16 bytes of a core matrix; 8 neighbouring lanes store one
// core matrix's 128 bytes. Returns the share's offset in floats.
constexpr int RW = BI / (kProducers * kCluster);
static_assert(RW == 8, "a warp's share is one row of core matrices");

__device__ __forceinline__ int generate_s(float* shi, float* slo, int i0,
                                          int k0, int w, int lane, int rank,
                                          uint32_t key0, uint32_t key1,
                                          float scale) {
  const int row0 = (rank * kProducers + w) * RW;
  const int ii = row0 + lane % RW;
  // two calls in flight: the producer warps have few registers a thread
#pragma unroll 2
  for (int it = 0; it < RW / 4; ++it) {
    const int kb = lane / RW + (32 / RW) * it;
    uint32_t x[4];
    philox4x32_10((uint32_t)(k0 / 4 + kb), (uint32_t)(i0 + ii), 0u, 0u, key0,
                  key1, x);
    float z[4];
    box_muller_fast(x[0], x[1], scale, &z[0], &z[1]);
    box_muller_fast(x[2], x[3], scale, &z[2], &z[3]);
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(z[e], h[e], l[e]);
    const int off = ((ii / 8) * (BK / 4) + kb) * kCoreFloats + (ii % 8) * 4;
    *reinterpret_cast<uint4*>(shi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(slo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
  return (row0 / 8) * (BK / 4) * kCoreFloats;
}

// a stage's raw A fragments as TF32 halves
__device__ __forceinline__ void split_frag(const float (&araw)[BK / 8][4],
                                           uint32_t (&ah)[BK / 8][4],
                                           uint32_t (&al)[BK / 8][4]) {
#pragma unroll
  for (int q = 0; q < BK / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(araw[q][e], ah[q][e], al[q][e]);
}

// Called after wgmma_wait_all: the tensor cores read a stage's A fragments
// from these registers until then, which the compiler cannot know, so
// they stay live (and out of reuse) up to here.
__device__ __forceinline__ void release_frag(const uint32_t (&ah)[BK / 8][4],
                                             const uint32_t (&al)[BK / 8][4]) {
#pragma unroll
  for (int q = 0; q < BK / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("" :: "r"(ah[q][e]), "r"(al[q][e]) : "memory");
}

// one stage on the tensor cores: part (+)= A-fragments x S tile, the two
// small products first; `keep` 0 starts the accumulator from zero
__device__ __forceinline__ void multiply_stage(
    float (&part)[4 * NT], const uint32_t (&ah)[BK / 8][4],
    const uint32_t (&al)[BK / 8][4], const float* shi, const float* slo,
    int keep) {
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < BK / 8; ++q) {
    // 8 of k are two core matrices
    const uint64_t dh = b_descriptor(shi + 2 * q * kCoreFloats);
    const uint64_t dl = b_descriptor(slo + 2 * q * kCoreFloats);
    wgmma_tf32(part, al[q], dh, q > 0 || keep);
    wgmma_tf32(part, ah[q], dl, 1);
    wgmma_tf32(part, ah[q], dh, 1);
  }
  wgmma_commit();
}

// A tile's sums to out (or to its part): a thread holds, for the 8-row
// group c of S, rows i0 + 8c + 2t and + 1 of out at columns j and j + 8,
// as acc[4c] (j, 2t), [4c+1] (j, 2t+1), [4c+2] (j+8, 2t), [4c+3] (j+8, 2t+1);
// the 8 lanes g of one t store 8 consecutive columns of a row
__device__ __forceinline__ void store_tile(float (&acc)[4 * NT], float* dst,
                                           int d, int n, int i0, int j,
                                           int t) {
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 8 * c + 2 * t + (e & 1);
      const int col = j + (e >> 1) * 8;
      if (i < d && col < n) dst[(size_t)i * n + col] = acc[4 * c + e];
      acc[4 * c + e] = 0.f;
    }
}

// Warps 8-11 generate S into a ring of kSBufs buffers, warps 0-7 (two
// warpgroups, 64 columns of the tile each) copy A, multiply and fold. The
// kCluster blocks of a cluster work on neighbouring column tiles of the
// same rows of S and share each S tile: every block's producer warps
// generate a quarter of it into their own buffer and one lane of each
// sends the warp's share on to the same place in the other blocks by bulk
// copies through distributed shared memory, which the receiving block's
// full[b] counts in bytes. full[b] counts the block's 4 producer warps
// (one lane arrives for its warp after all lanes' fences, announcing the
// bytes that warp's counterparts in the other blocks will send); empty[b]
// one lane of each of the 8 consumer warps of every block of the cluster,
// since a buffer is refilled from every block.
__global__ void __launch_bounds__(384, 1)
sketch_ws_kernel(const float* __restrict__ A, float* out, int d, int m, int n,
                 int kper, int splits, int chunk, uint32_t key0,
                 uint32_t key1, float scale) {
  extern __shared__ __align__(128) float smem[];
  float* sS = smem;                               // [buffer][hi, lo]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kSBufs * 2 * kSFloats + kARingFloats);
  uint64_t* empty = full + kSBufs;
  const int tid = threadIdx.x;
  const int rank = cluster_rank();
  if (tid == 0) {
    for (int b = 0; b < kSBufs; ++b) {
      mbar_init(full + b, kProducers);
      mbar_init(empty + b, 8 * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  Walk walk;
  walk.init(d, m, n, kper, splits, rank, gridDim.x / kCluster);
  const int first = blockIdx.x / kCluster;

  if (tid >= 256) {
    // ---- producer warpgroup: generate, fence, hand over
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int p = tid - 256;
    Cursor c;
    walk.enter(c, first);
    int b = 0;
    uint32_t parity = 1;              // the buffers start empty
    const int w = p >> 5, lane = p & 31;
    // bytes of one half of a warp's share
    constexpr int kShare = RW * BK * (int)sizeof(float);
    while (c.item < walk.items) {
      mbar_wait(empty + b, parity);
      float* shi = sS + b * 2 * kSFloats;
      const int off =
          generate_s(shi, shi + kSFloats, c.i0, c.kbeg + c.kt * BK, w, lane,
                     rank, key0, key1, scale);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect(full + b, (kCluster - 1) * 2 * kShare);
#pragma unroll
        for (int q = 1; q < kCluster; ++q) {
          const int peer = (rank + q) % kCluster;
          bulk_copy_to_block(shi + off, kShare, full + b, peer);
          bulk_copy_to_block(shi + kSFloats + off, kShare, full + b, peer);
        }
      }
      walk.advance(c);
      if (++b == kSBufs) {
        b = 0;
        parity ^= 1;
      }
    }
    cluster_sync();                   // no block leaves while others write
  } else {
    // ---- consumer warpgroups: copy A, multiply, fold
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wg = tid >> 7, p = tid & 127;
    const int w16 = ((tid >> 5) & 3) * 16;
    float* ring = smem + kSBufs * 2 * kSFloats + wg * kStages * kSliceFloats;

    float acc[4 * NT], part[4 * NT];
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) acc[e] = part[e] = 0.f;
    int since = 0;

    Cursor ld, cp;
    walk.enter(ld, first);
    walk.enter(cp, first);
    int lslot = 0, cslot = 0, b = 0;
    uint32_t parity = 0;
    auto load_stage = [&]() {
      if (ld.item < walk.items) {
        load_slice(ring + lslot * kSliceFloats, A, n, min(m, ld.kbeg + kper),
                   ld.kbeg + ld.kt * BK, ld.j0 + wg * kWgCols, p);
        walk.advance(ld);
      }
      lslot = (lslot + 1) % kStages;
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) load_stage();
    float araw[BK / 8][4];
    if (cp.item < walk.items) {
      cp_async_wait<kStages - 2>();
      bar_sync128(1 + wg);
      load_frag(araw, ring + cslot * kSliceFloats, w16, g, t);
    }

    while (cp.item < walk.items) {
      // slot cslot is read no more, and the one before it is refilled now
      load_stage();
      uint32_t ah[BK / 8][4], al[BK / 8][4];
      split_frag(araw, ah, al);
      mbar_wait(full + b, parity);      // the S tile has arrived
      const float* shi = sS + b * 2 * kSFloats;
      multiply_stage(part, ah, al, shi, shi + kSFloats, since > 0);
      // while the tensor cores run: fetch the next stage's fragments
      Cursor nx = cp;
      walk.advance(nx);
      if (nx.item < walk.items) {
        cp_async_wait<kStages - 2>();   // this thread's copies of that stage
        bar_sync128(1 + wg);            // the warpgroup's
        load_frag(araw, ring + ((cslot + 1) % kStages) * kSliceFloats, w16,
                  g, t);
      }
      wgmma_wait_all();
      release_frag(ah, al);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kCluster; ++q) mbar_arrive_remote(empty + b, q);
      }
      const bool last = cp.kt == cp.nk - 1;
      if (++since == chunk || last) {
        since = 0;
#pragma unroll
        for (int e = 0; e < 4 * NT; ++e) acc[e] += part[e];
      }
      if (last)
        store_tile(acc, out + (size_t)(cp.kbeg / kper) * d * n, d, n, cp.i0,
                   cp.j0 + wg * kWgCols + w16 + g, t);
      cp = nx;
      cslot = (cslot + 1) % kStages;
      if (++b == kSBufs) {
        b = 0;
        parity ^= 1;
      }
    }
    cp_async_wait<0>();
    cluster_sync();
  }
}

void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                    int blocks, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.blockDim = dim3(384);
  cfg.gridDim = dim3(blocks);
  cfg.dynamicSmemBytes = kWsSmemBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// how many clusters of sketch_ws_kernel run at once on the current device
// (asked of the CUDA runtime once a device)
cudaError_t active_clusters(int* clusters) {
  constexpr int kDevices = 64;
  static int known[kDevices] = {};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sketch_ws_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kWsSmemBytes);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kDevices && known[dev] > 0) {
    *clusters = known[dev];
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, sms / kCluster * kCluster, nullptr);
  err = cudaOccupancyMaxActiveClusters(clusters, sketch_ws_kernel, &cfg);
  if (err == cudaSuccess && *clusters < 1) err = cudaErrorLaunchOutOfResources;
  if (err == cudaSuccess && dev >= 0 && dev < kDevices) known[dev] = *clusters;
  return err;
}

template <typename T>
int launch_gaussian_sketch(const void* A, void* out, int d, int m, int n,
                           unsigned key0, unsigned key1, double scale,
                           void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (d + kBD - 1) / kBD);
  gaussian_sketch_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)A, (T*)out, d, m, n, (uint32_t)key0, (uint32_t)key1,
      (T)scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// How many clusters (of 4 blocks) of the tensor-core kernel the current
// card holds at once: the work items of one wave. Negative: a cudaError.
int rl_gaussian_sketch_wave() {
  int clusters = 0;
  const cudaError_t err = active_clusters(&clusters);
  return err == cudaSuccess ? clusters : -(int)err;
}

// fp32 on the tensor cores. `splits` > 1 splits the reduction over m into
// that many parts, written to `part` (splits, d, n) and added in index
// order; `chunk` is the number of 32-deep stages the wgmma accumulator
// runs before it is folded with FADD (0: never). Operands that are not
// 16-byte aligned with n % 4 == 0 are refused (cudaErrorInvalidValue).
int rl_gaussian_sketch_f32(const void* A_, void* out, void* part, int d,
                           int m, int n, unsigned key0, unsigned key1,
                           double scale, int splits, int chunk,
                           void* stream) {
  if (n % 4 || splits < 1 || splits > 65535 || !aligned16(A_) ||
      !aligned16(out) || (splits > 1 && !aligned16(part)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // each part a whole number of stages, and none of them empty
  const int kper = ((m + splits - 1) / splits + BK - 1) / BK * BK;
  splits = (m + kper - 1) / kper;
  int clusters = 0;
  cudaError_t err = active_clusters(&clusters);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)((d + BI - 1) / BI) *
                          (((n + BJ - 1) / BJ + kCluster - 1) / kCluster) *
                          splits;
  if (items >= INT32_MAX) return (int)cudaErrorInvalidValue;
  float* dst = (float*)(splits > 1 ? part : out);
  // as many clusters as the card holds at once, or as there are items
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr,
                 (int)(items < clusters ? items : clusters) * kCluster, s);
  err = cudaLaunchKernelEx(&cfg, sketch_ws_kernel, (const float*)A_, dst, d,
                           m, n, kper, splits,
                           chunk > 0 ? chunk : INT32_MAX, (uint32_t)key0,
                           (uint32_t)key1, (float)scale);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n4 = (size_t)d * n / 4;
  add_parts_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      (const float4*)part, (float4*)out, n4, splits);
  return (int)cudaGetLastError();
}

int rl_gaussian_sketch_simt_f32(const void* A, void* out, int d, int m, int n,
                                unsigned key0, unsigned key1, double scale,
                                void* stream) {
  return launch_gaussian_sketch<float>(A, out, d, m, n, key0, key1, scale,
                                       stream);
}

int rl_gaussian_sketch_f64(const void* A, void* out, int d, int m, int n,
                           unsigned key0, unsigned key1, double scale,
                           void* stream) {
  return launch_gaussian_sketch<double>(A, out, d, m, n, key0, key1, scale,
                                        stream);
}

}  // extern "C"
