// Masked WY trailing-update kernels of the factored BQRRP driver, for
// Hopper (sm_90a). They replace the two Pallas TPU kernels of
// randlapack_tpu/ops/pallas_wy.py:
//
//   masked_vt_a        (pallas_wy.py:91, pallas_call at :117)
//       W = V^T (A * mask)        V (m,b), A (m,w), mask (w,) -> W (b,w)
//   a_minus_vz_masked  (pallas_wy.py:134, pallas_call at :153)
//       A <- A - (V Z) * mask     A (m,w), V (m,k), Z (k,w), mask (w,)
//
// What bounds them on an H100: operations. At the main-path shapes
// (m = 8192, b = 256, w = 4096..8192, k = 1024) they do 2*m*b*w (2*m*k*w)
// flops against one pass over A. The fp32 FFMA units peak at 67 TFLOP/s;
// the tensor cores take no fp32 operand but do 495 TFLOP/s in TF32, so
// three TF32 products per fp32 product have a ceiling of 165 TFLOP/s.
//
// The fp32 design (wy_tc_kernel) emulates fp32 on the tensor cores, as the
// JAX kernels' Precision.HIGHEST is itself a multi-pass emulation of fp32
// on the TPU's matrix unit:
//
// - Split. Each fp32 operand x becomes hi = tf32(x), lo = tf32(x - hi),
//   both rounded to nearest, ties away (cvt.rna for hi, the same rounding
//   by integer operations for lo; truncation would double the split
//   error). The product is lo*hi + hi*lo + hi*hi, the two small products
//   first; lo*lo (<= 2^-22 relative) is dropped.
// - wgmma. The products run as wgmma.mma_async.m64n128k8 (tf32 in, fp32
//   accumulate), the only way to the tensor cores' full rate. For TF32 it
//   takes K-major operands only, and both kernels have operands that are
//   not (V and A of masked_vt_a run down the reduction; so does Z). So
//   the left operand goes through registers: each warp reads its 16 rows
//   of the raw tile by 32-bit loads in the fragment layout, whatever the
//   tile's layout, and splits them there. The right operand, which wgmma
//   reads from shared memory only, gets a conversion pass: the raw 32x128
//   tile is read, K1's mask multiplied in, split, and hi and lo stored
//   K-major in unswizzled core matrices (8 columns x 16 bytes), followed
//   by fence.proxy.async; that pass runs on the next stage while the
//   tensor cores work on this one (two B buffers).
// - Chunked accumulation. The tensor cores add into their accumulator
//   with truncation, not round-to-nearest: over a long reduction the sum
//   shrinks by about 6e-8 of itself for every 8 terms (measured: a
//   relative error of 5.7e-5 at m = 8192 where cuBLAS's fp32 has 8e-7).
//   So the wgmma accumulator is started from zero (scale-d = 0) every
//   `chunk` stages of 32; then it is added with ordinary FADD (round to
//   nearest) into a second set of fp32 registers. The wrapper's default
//   chunk is the longest that stays within cuBLAS's error with a margin.
// - Ring. 4 stages of a 128x32 (32x128) raw tile of each operand in
//   dynamic shared memory, filled by 16-byte cp.async copies in their
//   zero-fill form (a row or column past the edge copies 0 bytes); loads
//   run three stages ahead of the wgmma. With the split B buffers:
//   208,896 bytes, one block a multiprocessor.
// - Tiles. One block of two warpgroups owns a 128x128 output tile, a
//   warpgroup 64 rows of it (2 x 64 accumulator registers a thread). The
//   kernel is persistent: one block per multiprocessor walks over its
//   share of the tiles, and its loads run ahead across tile boundaries,
//   so a tile's epilogue overlaps the next tile's first loads
//   (a_minus_vz_masked has 4096 tiles of only 32 stages each at the main
//   shape). masked_vt_a's output is only b x w = 128 tiles at the main
//   shape and fewer as the window narrows, so its reduction can be split
//   into parts, each a work item of its own written to `part`, and a
//   second kernel adds the parts in index order (no float atomics: two
//   launches are bit-equal).
// - Epilogues. Lane pairs exchange halves of their accumulator fragments
//   so each thread holds 4 consecutive columns of one row: W is stored,
//   and A read (all of a thread's 16 loads first), updated with
//   acc * mask and written in place, 16 bytes a thread (A is not an
//   operand of the product).
//
// Non-finite entries: Inf splits into hi = Inf and a lo that is NaN or
// garbled, so an Inf that the plain version carries through as +-Inf may
// come out NaN; the finite/non-finite pattern of the output is the plain
// version's.
// The mask is multiplied, not used to skip: a non-finite A entry under
// mask 0 gives NaN, as A*mask does in JAX.
//
// Trailing-precision forms (the drivers' trailing_precision other than
// "highest"; the JAX package's _tp_matmul / masked_vt_a_mixed). The same
// kernel, its template's kMode picking the arithmetic of the products:
//   kTf32x3  the fp32 design above ("highest");
//   kTf32    one TF32 product, hi*hi only ("high": Precision.HIGH is
//            TF32 on this card), 4 wgmma a stage in place of 12;
//   kBf16    one bf16 product, operands rounded to nearest even and
//            wgmma.m64n128k16 with fp32 accumulation ("default");
//   kBf16x3  three bf16 products of the halves hi = bf16(x),
//            lo = bf16(x - hi), hi*hi + hi*lo + lo*hi, lo*lo dropped
//            (the JAX package's bf16_3x_matmul, "bf16_3x_emul").
// The bf16 forms keep the raw fp32 ring and the conversion pass; their
// split B tile holds 8 bf16 of k per 16 bytes (core matrices of 8
// columns x 8 k), so a stage is two k16 products. The accumulator is
// restarted every `chunk` stages in every form, as above.
//
// Guarded path. 16-byte copies need every operand 16-byte aligned with
// row lengths that are multiples of 4 (b, w for masked_vt_a; k, w for
// a_minus_vz_masked). The tensor-core entry points refuse anything else
// (cudaErrorInvalidValue); the wrapper sends such shapes, and all of f64,
// to the SIMT kernels below, which take any m, b, k, w: 64x64 tiles, 4x4
// micro-tiles of FFMA/DFMA per thread, a 16-deep stage, every edge masked.
// The fp32 SIMT kernels also stay reachable on their own
// (rl_*_simt_f32) as the yardstick of the earlier design.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "tc.cuh"

namespace {

// ---------------------------------------------------------------------
// SIMT kernels: fp64, and fp32 for the guarded path
// ---------------------------------------------------------------------

constexpr int kTile = 64;            // output tile edge (BM = BN)
constexpr int kDepth = 16;           // staged reduction depth (BK)
constexpr int kMicro = 4;            // micro-tile edge per thread
constexpr int kStride = kTile / kMicro;           // 16
constexpr int kThreads = kStride * kStride;        // 256

// W[i][j] = sum_r V[r][i] * (A[r][j] * mask[j])
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_vt_a_kernel(const T* __restrict__ V, const T* __restrict__ A,
                   const T* __restrict__ mask, T* __restrict__ W,
                   int m, int b, int w) {
  __shared__ T Vs[kDepth][kTile];
  __shared__ T As[kDepth][kTile];
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % kStride;
  const int ty = tid / kStride;

  T acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[a][c] = T(0);

  for (int r0 = 0; r0 < m; r0 += kDepth) {
    for (int e = tid; e < kDepth * kTile; e += kThreads) {
      const int kk = e / kTile, ii = e % kTile;
      const int r = r0 + kk, i = i0 + ii;
      Vs[kk][ii] = (r < m && i < b) ? V[(size_t)r * b + i] : T(0);
    }
    for (int e = tid; e < kDepth * kTile; e += kThreads) {
      const int kk = e / kTile, jj = e % kTile;
      const int r = r0 + kk, j = j0 + jj;
      As[kk][jj] = (r < m && j < w) ? A[(size_t)r * w + j] * mask[j] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      T va[kMicro], vb[kMicro];
#pragma unroll
      for (int a = 0; a < kMicro; ++a) va[a] = Vs[kk][ty + a * kStride];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) vb[c] = As[kk][tx + c * kStride];
#pragma unroll
      for (int a = 0; a < kMicro; ++a)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) acc[a][c] += va[a] * vb[c];
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = i0 + ty + a * kStride;
    if (i >= b) continue;
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int j = j0 + tx + c * kStride;
      if (j < w) W[(size_t)i * w + j] = acc[a][c];
    }
  }
}

// A[r][c] <- A[r][c] - (sum_q V[r][q] * Z[q][c]) * mask[c]
template <typename T>
__global__ void __launch_bounds__(kThreads)
a_minus_vz_masked_kernel(T* __restrict__ A, const T* __restrict__ V,
                         const T* __restrict__ Z, const T* __restrict__ mask,
                         int m, int k, int w) {
  // +1 column: V is read along its rows (q fastest) and stored transposed,
  // the pad keeps those stores off a single bank
  __shared__ T Vs[kDepth][kTile + 1];
  __shared__ T Zs[kDepth][kTile];
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % kStride;
  const int ty = tid / kStride;

  T acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[a][c] = T(0);

  for (int q0 = 0; q0 < k; q0 += kDepth) {
    for (int e = tid; e < kDepth * kTile; e += kThreads) {
      const int rr = e / kDepth, kk = e % kDepth;
      const int r = r0 + rr, q = q0 + kk;
      Vs[kk][rr] = (r < m && q < k) ? V[(size_t)r * k + q] : T(0);
    }
    for (int e = tid; e < kDepth * kTile; e += kThreads) {
      const int kk = e / kTile, cc = e % kTile;
      const int q = q0 + kk, c = c0 + cc;
      Zs[kk][cc] = (q < k && c < w) ? Z[(size_t)q * w + c] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      T va[kMicro], vb[kMicro];
#pragma unroll
      for (int a = 0; a < kMicro; ++a) va[a] = Vs[kk][ty + a * kStride];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) vb[c] = Zs[kk][tx + c * kStride];
#pragma unroll
      for (int a = 0; a < kMicro; ++a)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) acc[a][c] += va[a] * vb[c];
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int r = r0 + ty + a * kStride;
    if (r >= m) continue;
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int col = c0 + tx + c * kStride;
      if (col < w) {
        const size_t idx = (size_t)r * w + col;
        A[idx] = A[idx] - acc[a][c] * mask[col];
      }
    }
  }
}

template <typename T>
int launch_masked_vt_a(const void* V, const void* A, const void* mask,
                       void* W, int m, int b, int w, void* stream) {
  const dim3 grid((w + kTile - 1) / kTile, (b + kTile - 1) / kTile);
  masked_vt_a_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)V, (const T*)A, (const T*)mask, (T*)W, m, b, w);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_a_minus_vz_masked(void* A, const void* V, const void* Z,
                             const void* mask, int m, int k, int w,
                             void* stream) {
  const dim3 grid((w + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  a_minus_vz_masked_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (T*)A, (const T*)V, (const T*)Z, (const T*)mask, m, k, w);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// fp32 on the tensor cores: three TF32 products behind a cp.async ring
// ---------------------------------------------------------------------

// the forms of the tensor-core kernel (its kMode; `mode` of the C entry
// points)
constexpr int kTf32x3 = 0, kTf32 = 1, kBf16 = 2, kBf16x3 = 3;

// x rounded to TF32, to nearest, ties away (the hi half of split_tf32)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d (this warpgroup's 64 x 128) = a (64x16 bf16, registers: a warp's 16
// rows in mma.m16n8k16's A layout) * b (16x128 bf16, shared, K-major) +
// (keep ? d : 0); fp32 accumulate, asynchronous
__device__ __forceinline__ void wgmma_bf16(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(keep));
}

// the bf16 forms' split B tile: core matrices of 8 columns x 8 bf16 of k
// (128 bytes), kCoreK bytes to the next along k and BK/8 of them, 512
// bytes, to the next along n
constexpr int kCoreNBf16 = (BK / 8) * kCoreFloats * 4;

__device__ __forceinline__ uint64_t b_descriptor_bf16(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)(kCoreK >> 4) << 16 | (uint64_t)(kCoreNBf16 >> 4) << 32;
}

constexpr int BM = 128, BN = 128;    // output tile of a block
constexpr int kStages = 4;
constexpr int kTcThreads = 256;      // 2 warpgroups, 64 rows of the tile each
constexpr int NT = BN / 8;           // 8-column groups across the tile
// row lengths of the raw tiles in shared memory: the pads put the 32
// addresses of a fragment load (8 rows x 4 columns, or 4 rows x 8
// columns) on 32 banks
constexpr int LDK = BK + 4;          // a tile stored [row][k]
constexpr int LDN = BN + 8;          // a tile stored [k][row or column]
constexpr int kStageA = (BM * LDK > BK * LDN) ? BM * LDK : BK * LDN;
constexpr int kStageB = BK * LDN;
constexpr int kStageFloats = kStageA + kStageB;
constexpr int kSplitFloats = BK * BN;
constexpr size_t kTcSmemBytes =
    (size_t)(kStages * kStageFloats + 4 * kSplitFloats) * sizeof(float);

// Rows [k0, k0+BK) x columns [c0, c0+BN) of G (rows x ld, row-major,
// ld % 4 == 0) into s[BK][LDN]; rows >= kend and columns >= ld are zeros.
__device__ __forceinline__ void load_tile_kn(float* s, const float* G, int ld,
                                             int kend, int k0, int c0,
                                             int tid) {
#pragma unroll
  for (int i = 0; i < BK * BN / 4 / kTcThreads; ++i) {
    const int c = tid + i * kTcThreads;
    const int r = c / (BN / 4), c4 = (c % (BN / 4)) * 4;
    const bool ok = (k0 + r < kend) && (c0 + c4 < ld);
    const float* src = ok ? G + (size_t)(k0 + r) * ld + (c0 + c4) : G;
    cp_async16(s + r * LDN + c4, src, ok ? 16 : 0);
  }
}

// Rows [r0, r0+BM) x columns [k0, k0+BK) of G (rows x ld, row-major,
// ld % 4 == 0) into s[BM][LDK]; rows >= rows and columns >= kend are zeros.
__device__ __forceinline__ void load_tile_mk(float* s, const float* G, int ld,
                                             int rows, int r0, int kend,
                                             int k0, int tid) {
#pragma unroll
  for (int i = 0; i < BM * BK / 4 / kTcThreads; ++i) {
    const int c = tid + i * kTcThreads;
    const int r = c / (BK / 4), c4 = (c % (BK / 4)) * 4;
    const bool ok = (r0 + r < rows) && (k0 + c4 < kend);
    const float* src = ok ? G + (size_t)(r0 + r) * ld + (k0 + c4) : G;
    cp_async16(s + r * LDK + c4, src, ok ? 16 : 0);
  }
}

// Where a block is in its list of work: item `item` (a 128x128 output tile
// of one part of the reduction), stage `kt` of its `nk`.
struct TileCursor {
  int item, kt, nk;
  int m0, n0, kbeg;
};

// acc[i][j] = sum_q P(i,q) * Q[q][j] (* mask[j]) over 128x128 tiles.
//   kVtA (masked_vt_a):  P(i,q) = V[q][i], V (K x M); Q = A (K x N), the
//       mask multiplied into Q; part z of the reduction (kper long) goes
//       to out (M x N) + z*M*N.
//   else (a_minus_vz_masked): P(i,q) = V[i][q], V (M x K); Q = Z (K x N);
//       out (M x N) <- out - acc * mask, in place.
// Persistent: block x works items x, x + gridDim.x, ... and its loads run
// kStages-1 stages ahead of its wgmma across item boundaries. Per stage:
// every thread splits its A values (its warp's 16 rows, fetched a stage
// ahead) and the warpgroup issues the stage's wgmma (12 for kTf32x3); while
// those run, all threads fetch the next stage's A values and split its B
// tile into the other B buffer. kMode picks the products' arithmetic (see
// the file's head).
template <bool kVtA, int kMode>
__global__ void __launch_bounds__(kTcThreads, 1)
wy_tc_kernel(const float* __restrict__ P, const float* __restrict__ Q,
             const float* __restrict__ mask, float* out,
             int M, int N, int K, int kper, int splits, int chunk) {
  constexpr bool kBf = kMode == kBf16 || kMode == kBf16x3;
  constexpr bool kLo = kMode == kTf32x3 || kMode == kBf16x3;  // lo halves
  extern __shared__ __align__(128) float smem[];
  float* split = smem + kStages * kStageFloats;   // [buffer][hi, lo]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (tid >> 5) * 16;           // this warp's rows of the tile
  const int ntx = (N + BN - 1) / BN;
  const int tiles = ntx * ((M + BM - 1) / BM);
  const int items = tiles * splits;

  auto enter = [&](TileCursor& c, int item) {
    c.item = item;
    c.kt = 0;
    if (item < items) {
      const int z = item / tiles, r = item - z * tiles;
      c.m0 = (r / ntx) * BM;
      c.n0 = (r % ntx) * BN;
      c.kbeg = z * kper;
      c.nk = (min(K, c.kbeg + kper) - c.kbeg + BK - 1) / BK;   // >= 1
    }
  };
  auto advance = [&](TileCursor& c) {
    if (++c.kt == c.nk) enter(c, c.item + gridDim.x);
  };
  auto load_stage = [&](const TileCursor& c, int slot) {
    float* sA = smem + slot * kStageFloats;
    const int k0 = c.kbeg + c.kt * BK, kend = min(K, c.kbeg + kper);
    if (kVtA) load_tile_kn(sA, P, M, kend, k0, c.m0, tid);
    else      load_tile_mk(sA, P, K, M, c.m0, kend, k0, tid);
    load_tile_kn(sA + kStageA, Q, N, kend, k0, c.n0, tid);
  };
  // The raw B tile [k][n] of `slot`, times K1's mask, as hi and lo halves
  // in core matrices: a thread takes one column n and 4 x 4 values of k
  // (TF32; bf16: 2 x 8), and 8 neighbouring threads store one core
  // matrix's 128 bytes. The one-product forms store hi only.
  auto split_b = [&](const TileCursor& c, int slot, int buf) {
    const float* sB = smem + slot * kStageFloats + kStageA;
    float* bhi = split + buf * 2 * kSplitFloats;
    float* blo = bhi + kSplitFloats;
    const int n = tid % BN;
    float mk = 1.f;
    if (kVtA) mk = (c.n0 + n < N) ? mask[c.n0 + n] : 0.f;
    constexpr int kPer = kBf ? 8 : 4;     // values of k in 16 bytes
#pragma unroll
    for (int i = 0; i < BK / kPer / (kTcThreads / BN); ++i) {
      const int kb = tid / BN + (kTcThreads / BN) * i;
      float x[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        x[e] = sB[(kPer * kb + e) * LDN + n];
        if (kVtA) x[e] *= mk;
      }
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kMode == kTf32x3) split_tf32(x[e], h[e], l[e]);
        else if constexpr (kMode == kTf32) h[e] = tf32_rna(x[e]);
        else if constexpr (kMode == kBf16)
          h[e] = pack_bf16(x[2 * e], x[2 * e + 1]);
        else split_bf16(x[2 * e], x[2 * e + 1], h[e], l[e]);
      }
      const int off =
          ((n / 8) * (BK / kPer) + kb) * kCoreFloats + (n % 8) * 4;
      *reinterpret_cast<uint4*>(bhi + off) =
          make_uint4(h[0], h[1], h[2], h[3]);
      if constexpr (kLo)
        *reinterpret_cast<uint4*>(blo + off) =
            make_uint4(l[0], l[1], l[2], l[3]);
    }
  };

  // a thread's share of its warpgroup's 64x128 accumulator: for the 8-column
  // group c, rows g and g+8 of its warp, columns 8c+2t and 8c+2t+1, as
  // [4c] (g, 2t), [4c+1] (g, 2t+1), [4c+2] (g+8, 2t), [4c+3] (g+8, 2t+1)
  float acc[4 * NT];        // sums of whole chunks, added with FADD
  float part[4 * NT];       // the running chunk, added to by the wgmma
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e) acc[e] = part[e] = 0.f;
  int since = 0;            // stages in the running chunk

  TileCursor ld, cp;        // where the loads are, where the wgmma is
  enter(ld, blockIdx.x);
  enter(cp, blockIdx.x);
  int lslot = 0, cslot = 0, buf = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ld.item < items) {
      load_stage(ld, lslot);
      advance(ld);
    }
    lslot = (lslot + 1) % kStages;
    cp_async_commit();
  }
  // a thread's raw A values of a stage: its warp's 16 rows in wgmma's
  // fragment layout. TF32, [q][e]: row g + 8(e&1), k 8q + t + 4(e>>1).
  // bf16, [q][e]: element e&1 of register r = 2(q&1) + (e>>1) of the k16
  // product q>>1, which holds row g + 8(r&1), k 2t + 8(r>>1) and the next
  float araw[BK / 8][4];
  auto load_a = [&](int slot) {
    const float* sA = smem + slot * kStageFloats;
#pragma unroll
    for (int q = 0; q < BK / 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 2 * (q & 1) + (e >> 1);
        const int row = wm + g + (kBf ? (r & 1) : (e & 1)) * 8;
        const int col = kBf ? (q >> 1) * 16 + 2 * t + (e & 1) + (r >> 1) * 8
                            : q * 8 + t + (e >> 1) * 4;
        araw[q][e] = kVtA ? sA[col * LDN + row] : sA[row * LDK + col];
      }
  };
  if (cp.item < items) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_a(cslot);
    split_b(cp, cslot, buf);
    fence_proxy_async();
  }
  __syncthreads();

  while (cp.item < items) {
    // split buffer `buf` holds this stage's B and araw its A; raw slot
    // cslot is read no more, and the one before it is refilled now
    if (ld.item < items) {
      load_stage(ld, lslot);
      advance(ld);
    }
    lslot = (lslot + 1) % kStages;
    cp_async_commit();
    const float* bhi = split + buf * 2 * kSplitFloats;
    const float* blo = bhi + kSplitFloats;
    // the A fragments: TF32, one k8 product's per q; bf16, one k16
    // product's per q < BK/16 (the rest unused)
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int q = 0; q < BK / 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        al[q][e] = 0u;
        if constexpr (kMode == kTf32x3)
          split_tf32(araw[q][e], ah[q][e], al[q][e]);
        else if constexpr (kMode == kTf32) ah[q][e] = tf32_rna(araw[q][e]);
        else ah[q][e] = 0u;
      }
    if constexpr (kBf) {
#pragma unroll
      for (int q = 0; q < BK / 16; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = araw[2 * q + (r >> 1)][2 * (r & 1)];
          const float b = araw[2 * q + (r >> 1)][2 * (r & 1) + 1];
          if constexpr (kMode == kBf16) ah[q][r] = pack_bf16(a, b);
          else split_bf16(a, b, ah[q][r], al[q][r]);
        }
    }
    wgmma_fence();
    if constexpr (!kBf) {
#pragma unroll
      for (int q = 0; q < BK / 8; ++q) {
        // 8 of k are two core matrices; the small products first, and a
        // chunk's first product starts the accumulator from zero
        const uint64_t dh = b_descriptor(bhi + 2 * q * kCoreFloats);
        if constexpr (kLo) {
          const uint64_t dl = b_descriptor(blo + 2 * q * kCoreFloats);
          wgmma_tf32(part, al[q], dh, q > 0 || since > 0);
          wgmma_tf32(part, ah[q], dl, 1);
          wgmma_tf32(part, ah[q], dh, 1);
        } else {
          wgmma_tf32(part, ah[q], dh, q > 0 || since > 0);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < BK / 16; ++q) {
        // 16 of k are two core matrices, as above
        const uint64_t dh = b_descriptor_bf16(bhi + 2 * q * kCoreFloats);
        if constexpr (kLo) {
          const uint64_t dl = b_descriptor_bf16(blo + 2 * q * kCoreFloats);
          wgmma_bf16(part, al[q], dh, q > 0 || since > 0);
          wgmma_bf16(part, ah[q], dl, 1);
          wgmma_bf16(part, ah[q], dh, 1);
        } else {
          wgmma_bf16(part, ah[q], dh, q > 0 || since > 0);
        }
      }
    }
    wgmma_commit();

    // while the tensor cores run: fetch the next stage's A and split its B
    // into the other buffer
    TileCursor nx = cp;
    advance(nx);
    if (nx.item < items) {
      cp_async_wait<kStages - 2>();   // this thread's copies of that stage
      __syncthreads();                // everyone's
      load_a((cslot + 1) % kStages);
      split_b(nx, (cslot + 1) % kStages, buf ^ 1);
      fence_proxy_async();
    }
    wgmma_wait_all();
    release_frag(ah, al);
    const bool last = cp.kt == cp.nk - 1;
    if (++since == chunk || last) {
      since = 0;
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) acc[e] += part[e];
    }

    if (last) {
      // The item's epilogue. Lane pairs (t, t^1) trade halves of each
      // 8-column group: the even lane ends with row g, the odd lane with
      // row g+8, each 4 consecutive columns (N % 4 == 0: all four or none).
      const bool odd = t & 1;
      const int i = cp.m0 + wm + g + (odd ? 8 : 0);
      const int j0 = cp.n0 + (t & ~1) * 2;
      float* dst = (kVtA ? out + (size_t)(cp.kbeg / kper) * M * N : out) +
                   (size_t)i * N;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        float* v = acc + 4 * c;
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
        if (odd) {
          v[0] = r0;
          v[1] = r1;
        } else {
          v[2] = r0;
          v[3] = r1;
        }
      }
      if (kVtA) {
#pragma unroll
        for (int c = 0; c < NT; ++c)
          if (i < M && j0 + c * 8 < N)
            *reinterpret_cast<float4*>(dst + j0 + c * 8) = make_float4(
                acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
      } else {
        // all of the thread's loads of A first (into the chunk's registers,
        // free by now), then the updates and stores
#pragma unroll
        for (int c = 0; c < NT; ++c)
          if (i < M && j0 + c * 8 < N) {
            const float4 x =
                *reinterpret_cast<const float4*>(dst + j0 + c * 8);
            part[4 * c] = x.x;
            part[4 * c + 1] = x.y;
            part[4 * c + 2] = x.z;
            part[4 * c + 3] = x.w;
          }
#pragma unroll
        for (int c = 0; c < NT; ++c)
          if (i < M && j0 + c * 8 < N) {
            const float4 mj =
                *reinterpret_cast<const float4*>(mask + j0 + c * 8);
            *reinterpret_cast<float4*>(dst + j0 + c * 8) = make_float4(
                part[4 * c] - acc[4 * c] * mj.x,
                part[4 * c + 1] - acc[4 * c + 1] * mj.y,
                part[4 * c + 2] - acc[4 * c + 2] * mj.z,
                part[4 * c + 3] - acc[4 * c + 3] * mj.w);
          }
      }
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) acc[e] = 0.f;
    }
    __syncthreads();    // the other buffer is whole; this stage is done with
    advance(cp);
    cslot = (cslot + 1) % kStages;
    buf ^= 1;
  }
  cp_async_wait<0>();
}

template <bool kVtA, int kMode>
int launch_wy_tc_form(const float* P, const float* Q, const float* mask,
                      float* out, int M, int N, int K, int kper, int splits,
                      int chunk, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        wy_tc_kernel<kVtA, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long items =
      (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM) * splits;
  if (items >= INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  wy_tc_kernel<kVtA, kMode><<<grid, kTcThreads, kTcSmemBytes, stream>>>(
      P, Q, mask, out, M, N, K, kper, splits,
      chunk > 0 ? chunk : INT32_MAX);
  return (int)cudaGetLastError();
}

template <bool kVtA>
int launch_wy_tc(const float* P, const float* Q, const float* mask,
                 float* out, int M, int N, int K, int kper, int splits,
                 int chunk, int mode, cudaStream_t stream) {
  switch (mode) {
    case kTf32x3:
      return launch_wy_tc_form<kVtA, kTf32x3>(P, Q, mask, out, M, N, K,
                                              kper, splits, chunk, stream);
    case kTf32:
      return launch_wy_tc_form<kVtA, kTf32>(P, Q, mask, out, M, N, K, kper,
                                            splits, chunk, stream);
    case kBf16:
      return launch_wy_tc_form<kVtA, kBf16>(P, Q, mask, out, M, N, K, kper,
                                            splits, chunk, stream);
    case kBf16x3:
      return launch_wy_tc_form<kVtA, kBf16x3>(P, Q, mask, out, M, N, K,
                                              kper, splits, chunk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// fp32 operands on the tensor cores in the form `mode` (0 the three-TF32
// fp32 design, 1 one TF32 product, 2 one bf16 product, 3 three bf16
// products). `splits` > 1 splits the reduction into that many parts,
// written to `part` (splits, b, w) and added in index order; `chunk` is
// the number of 32-deep stages the wgmma accumulator runs before it is
// folded with FADD (0: never). Operands that are not 16-byte aligned with
// b % 4 == w % 4 == 0, and an unknown mode, are refused
// (cudaErrorInvalidValue).
int rl_masked_vt_a_mode_f32(const void* V, const void* A, const void* mask,
                            void* W, void* part, int m, int b, int w,
                            int splits, int chunk, int mode, void* stream) {
  if (b % 4 || w % 4 || splits < 1 || splits > 65535 || !aligned16(V) ||
      !aligned16(A) || !aligned16(W) || (splits > 1 && !aligned16(part)) ||
      mode < kTf32x3 || mode > kBf16x3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // each part a whole number of stages, and none of them empty
  const int kper = ((m + splits - 1) / splits + BK - 1) / BK * BK;
  splits = (m + kper - 1) / kper;
  const int err = launch_wy_tc<true>(
      (const float*)V, (const float*)A, (const float*)mask,
      (float*)(splits > 1 ? part : W), b, w, m, kper, splits, chunk, mode,
      s);
  if (err != 0 || splits == 1) return err;
  const size_t n4 = (size_t)b * w / 4;
  add_parts_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      (const float4*)part, (float4*)W, n4, splits);
  return (int)cudaGetLastError();
}

// in place, in the form `mode` (as above). Operands that are not 16-byte
// aligned with k % 4 == w % 4 == 0, and an unknown mode, are refused
// (cudaErrorInvalidValue).
int rl_a_minus_vz_masked_mode_f32(void* A, const void* V, const void* Z,
                                  const void* mask, int m, int k, int w,
                                  int chunk, int mode, void* stream) {
  if (k % 4 || w % 4 || !aligned16(A) || !aligned16(V) || !aligned16(Z) ||
      !aligned16(mask) || mode < kTf32x3 || mode > kBf16x3)
    return (int)cudaErrorInvalidValue;
  return launch_wy_tc<false>((const float*)V, (const float*)Z,
                             (const float*)mask, (float*)A, m, w, k, k, 1,
                             chunk, mode, (cudaStream_t)stream);
}

int rl_masked_vt_a_simt_f32(const void* V, const void* A, const void* mask,
                            void* W, int m, int b, int w, void* stream) {
  return launch_masked_vt_a<float>(V, A, mask, W, m, b, w, stream);
}

int rl_masked_vt_a_f64(const void* V, const void* A, const void* mask,
                       void* W, int m, int b, int w, void* stream) {
  return launch_masked_vt_a<double>(V, A, mask, W, m, b, w, stream);
}

int rl_a_minus_vz_masked_simt_f32(void* A, const void* V, const void* Z,
                                  const void* mask, int m, int k, int w,
                                  void* stream) {
  return launch_a_minus_vz_masked<float>(A, V, Z, mask, m, k, w, stream);
}

int rl_a_minus_vz_masked_f64(void* A, const void* V, const void* Z,
                             const void* mask, int m, int k, int w,
                             void* stream) {
  return launch_a_minus_vz_masked<double>(A, V, Z, mask, m, k, w, stream);
}

}  // extern "C"
