// Fused squared-exponential kernel product for Hopper (sm_90a). Replaces
// the Pallas TPU kernel kernel_matmat of
// randlapack_tpu/ops/pallas_kernels.py:48 (pallas_call at :91):
//
//   out = K(X, X) V,   K_ij = exp(-max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0)
//                                 / (2 sigma^2))
//   X (d, n) one point per column, V (n, s)  ->  out (n, s)
//
// No tile of K is ever stored in device memory, nor in shared memory.
//
// What bounds it on an H100: operations, not bytes (X, V and out are a few
// megabytes, the n^2 (2d + 2s + 6) flops and n^2 exponentials are not), and
// among the operations the exponentials: the special-function units give
// 16 results per multiprocessor and clock, which at d = 8, s = 1 is more
// time than the cross term on the tensor cores or the rest on FFMA.
//
// The fp32 design (kernel_matmat_tc_kernel) therefore spends one ex2.approx
// and as few other instructions as it can on an entry:
//
// - Folded scales. With a = log2(e) / (2 sigma^2) the entry is
//   2^min(e_ij, 0), e_ij = x'_i.x'_j + n'_i + n'_j, where x' = sqrt(2a) x
//   and n'_i = -|x'_i|^2 / 2. A prologue (pack_kernel) writes x', rounded
//   once to fp32 and then to the sum of its TF32 halves hi + lo (tc.cuh's
//   split; the norms are taken of that sum, so that cross term and norms
//   describe the same points and cancel on the diagonal), with
//   zero rows up to a multiple of 8 in d and zero points up to a multiple
//   of 128 in n, in the order the fragments are read; n'; and V in chunks
//   of SC columns, zero past n and s. The clamp min(e, 0) is the TPU
//   kernel's max(d^2, 0).
// - Cross term on the tensor cores: mma.sync.m16n8k8 (tf32 in, fp32
//   accumulate) on lo.lo + lo.hi + hi.lo + hi.hi, the accumulator started
//   from zero, so the tensor cores' truncating adds act on a sum of d
//   terms only; the norms are added afterwards with round-to-nearest FADD.
//   All four products, not the three of a plain matrix product: the
//   exponent is a difference of nearly equal numbers where points are
//   close, and on the diagonal the dropped lo.lo (2^-22 |x'_i|^2) would
//   show as K_ii = 1 - 1.7e-7 |x'_i|^2, past 1e-6 for narrow kernels. A
//   warp owns 32 rows i for its whole walk over j and keeps their
//   fragments (hi and lo, d/8 k-steps) in registers; d <= 32.
// - j in tiles of 128 points, double-buffered in shared memory by 16-byte
//   cp.async copies (x' halves, n', V: 72 bytes a point at d <= 8, s = 1);
//   a point's halves are laid out so that one 16-byte shared load gives a
//   thread its B fragments of a k-step (hi and lo), conflict-free.
// - Per 16x8 tile of entries a thread holds 4 of them: four mma, then
//   for each entry two FADD, one FMNMX, one MUFU.EX2 and one FFMA per
//   column of V into its partial sums (2 x 2 rows x SC columns). The
//   partial sums of the 4 lanes that share a row meet once, after the last
//   tile, by shuffles in a fixed order.
// - A thread's sum over j runs in two levels where the registers allow (s
//   <= 4): over the 32 terms of a tile, then over the tiles.
// - A block is 8 warps = 256 rows i. When n/256 row blocks are too few to
//   fill the card the caller splits j over grid.z; each split writes its
//   own partial result and a second kernel adds the splits in index order.
//   No atomics: two launches on the same operands give the same bits.
//
// Any n and s are taken: s in chunks of SC = 1, 4 or 16 columns (grid.y),
// each of which recomputes its entries. f64, and f32 with d > 32, take the
// SIMT kernel below (kernel_matmat_kernel): each block owns 64 rows i and
// walks over tiles of 128 columns j; each of its 256 threads holds a 4x8
// micro-tile of the cross products (FFMA/DFMA over d, staged 16 deep
// through shared memory), turns it into kernel entries (norms plus cross
// term, clamped at 0, times 1/(2 sigma^2), expf/exp) and multiplies them
// into its partial sums. The fp32 SIMT kernel also stays reachable on its
// own (rl_kernel_matmat_simt_f32) as the yardstick of the earlier design.

#include <cuda_runtime.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "tc.cuh"

namespace {

// ---------------------------------------------------------------------
// SIMT kernel: fp64, and fp32 beyond d = 32
// ---------------------------------------------------------------------

constexpr int kTI = 64;              // rows i per block
constexpr int kTJ = 128;             // columns j per tile
constexpr int kDC = 16;              // staged depth over d
constexpr int kRows = 4;             // micro-tile rows per thread
constexpr int kCols = 8;             // micro-tile columns per thread
constexpr int kLanes = 16;           // threads along i and along j
constexpr int kThreads = kLanes * kLanes;   // 256

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// norms[i] = sum_k X[k][i]^2
template <typename T>
__global__ void col_norms_kernel(const T* __restrict__ X,
                                 T* __restrict__ norms, int d, int n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n) return;
  T acc = T(0);
  for (int k = 0; k < d; ++k) {
    const T x = X[(size_t)k * n + i];
    acc += x * x;
  }
  norms[i] = acc;
}

// dst[z][i][c] = sum over the j tiles of split z of K_ij V[j][c]
template <typename T, int SC>
__global__ void __launch_bounds__(kThreads)
kernel_matmat_kernel(const T* __restrict__ X, const T* __restrict__ V,
                     const T* __restrict__ norms, T* __restrict__ dst,
                     int d, int n, int s, T inv2s2, int tiles_per_split) {
  __shared__ T Xi[kDC][kTI];
  __shared__ T Xj[kDC][kTJ];
  __shared__ T Vs[SC][kTJ + 1];      // V tile, transposed; padded stores
  __shared__ T Nj[kTJ];
  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int ty = tid / kLanes;
  const int i0 = blockIdx.x * kTI;
  const int c0 = blockIdx.y * SC;
  const bool one_chunk = d <= kDC;   // X_i then stays in shared memory

  T ni[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = i0 + ty + a * kLanes;
    ni[a] = i < n ? norms[i] : T(0);
  }
  T acc[kRows][SC];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c = 0; c < SC; ++c) acc[a][c] = T(0);

  if (one_chunk) {
    for (int e = tid; e < d * kTI; e += kThreads) {
      const int kk = e / kTI, ii = e % kTI;
      const int i = i0 + ii;
      Xi[kk][ii] = i < n ? X[(size_t)kk * n + i] : T(0);
    }
  }

  const int ntiles = (n + kTJ - 1) / kTJ;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * kTJ;
    T cross[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int b = 0; b < kCols; ++b) cross[a][b] = T(0);

    for (int k0 = 0; k0 < d; k0 += kDC) {
      const int dc = min(kDC, d - k0);
      __syncthreads();               // the tiles' last readers are done
      if (!one_chunk) {
        for (int e = tid; e < dc * kTI; e += kThreads) {
          const int kk = e / kTI, ii = e % kTI;
          const int i = i0 + ii;
          Xi[kk][ii] = i < n ? X[(size_t)(k0 + kk) * n + i] : T(0);
        }
      }
      for (int e = tid; e < dc * kTJ; e += kThreads) {
        const int kk = e / kTJ, jj = e % kTJ;
        const int j = j0 + jj;
        Xj[kk][jj] = j < n ? X[(size_t)(k0 + kk) * n + j] : T(0);
      }
      if (k0 == 0) {
        for (int e = tid; e < kTJ * SC; e += kThreads) {
          const int jj = e / SC, c = e % SC;
          const int j = j0 + jj;
          Vs[c][jj] = (j < n && c0 + c < s) ? V[(size_t)j * s + c0 + c]
                                            : T(0);
        }
        for (int jj = tid; jj < kTJ; jj += kThreads) {
          const int j = j0 + jj;
          Nj[jj] = j < n ? norms[j] : T(0);
        }
      }
      __syncthreads();
      for (int kk = 0; kk < dc; ++kk) {
        T xi[kRows], xj[kCols];
#pragma unroll
        for (int a = 0; a < kRows; ++a) xi[a] = Xi[kk][ty + a * kLanes];
#pragma unroll
        for (int b = 0; b < kCols; ++b) xj[b] = Xj[kk][tx + b * kLanes];
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int b = 0; b < kCols; ++b) cross[a][b] += xi[a] * xj[b];
      }
    }

#pragma unroll
    for (int b = 0; b < kCols; ++b) {
      const int jj = tx + b * kLanes;
      const T nj = Nj[jj];
      T vj[SC];
#pragma unroll
      for (int c = 0; c < SC; ++c) vj[c] = Vs[c][jj];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        T d2 = ni[a] + nj - T(2) * cross[a][b];
        d2 = d2 > T(0) ? d2 : T(0);
        const T kt = exp_t(-d2 * inv2s2);
#pragma unroll
        for (int c = 0; c < SC; ++c) acc[a][c] += kt * vj[c];
      }
    }
  }

  // the 16 threads of a row (lanes tx of one half-warp) add their sums
  T* out_z = dst + (size_t)blockIdx.z * n * s;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = i0 + ty + a * kLanes;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      T v = acc[a][c];
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (tx == 0 && i < n && c0 + c < s) out_z[(size_t)i * s + c0 + c] = v;
    }
  }
}

// ---------------------------------------------------------------------
// fp32 on the tensor cores: TF32 mma cross term, one ex2 an entry
// ---------------------------------------------------------------------

constexpr int kBI = 256;             // rows i per block: 8 warps x 32
constexpr int kWarpRows = 32;        // two m16 tiles a warp
constexpr int kTcTJ = 128;           // points j per tile
constexpr int kMaxKSteps = 4;        // d <= 32 on this route

// floats a packed point takes in device memory (KS k-steps x 4 lanes t x
// {hi[t], hi[t+4], lo[t], lo[t+4]}) and in shared memory, where a pad of
// 64 bytes at KS > 1 keeps the stride at 4 mod 8 sixteen-byte units, so
// the 8 lanes of a quarter-warp (2 points x 4 t) hit 8 different units
__host__ __device__ constexpr int packed_floats(int ks) { return ks * 16; }
__host__ __device__ constexpr int smem_point_floats(int ks) {
  return ks == 1 ? 16 : ks * 16 + 16;
}
template <int KS, int SC>
__host__ __device__ constexpr int tile_floats() {
  return kTcTJ * (smem_point_floats(KS) + 1 + SC);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c += a (16x8, row) * b (8x8, col); tf32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The prologue, a thread a point j < n_pad: x' = scale * x split into TF32
// halves in fragment order, n' = -|x'|^2 / 2, and V in column chunks.
//   xs  [n_pad][ks][4][4]   {hi[8q+t], hi[8q+t+4], lo[8q+t], lo[8q+t+4]}
//   nrm [n_pad]
//   vp  [chunks][n_pad][sc]
__global__ void pack_kernel(const float* __restrict__ X,
                            const float* __restrict__ V,
                            float* __restrict__ xs, float* __restrict__ nrm,
                            float* __restrict__ vp, int d, int n, int n_pad,
                            int s, int ks, int sc, float scale) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_pad) return;
  float acc = 0.f;
  uint4* dst = reinterpret_cast<uint4*>(xs + (size_t)j * packed_floats(ks));
  for (int q = 0; q < ks; ++q)
    for (int t = 0; t < 4; ++t) {
      uint32_t h[2], l[2];
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * q + t + 4 * e;
        const float x = (j < n && k < d) ? scale * X[(size_t)k * n + j] : 0.f;
        split_tf32(x, h[e], l[e]);
        // the norm of what the products see: hi + lo (exact in fp32)
        const float xr = __uint_as_float(h[e]) + __uint_as_float(l[e]);
        acc = fmaf(xr, xr, acc);
      }
      dst[q * 4 + t] = make_uint4(h[0], h[1], l[0], l[1]);
    }
  nrm[j] = -0.5f * acc;
  const int chunks = (s + sc - 1) / sc;
  for (int cy = 0; cy < chunks; ++cy)
    for (int c = 0; c < sc; ++c) {
      const int col = cy * sc + c;
      vp[((size_t)cy * n_pad + j) * sc + c] =
          (j < n && col < s) ? V[(size_t)j * s + col] : 0.f;
    }
}

// dst[z][i][c] = sum over the j tiles of split z of K_ij V[j][c]
template <int KS, int SC>
__global__ void __launch_bounds__(256)
kernel_matmat_tc_kernel(const float* __restrict__ xs,
                        const float* __restrict__ nrm,
                        const float* __restrict__ vp, float* __restrict__ dst,
                        int n, int n_pad, int s, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  constexpr int PF = smem_point_floats(KS);
  constexpr int kTile = tile_floats<KS, SC>();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * kBI + (tid >> 5) * kWarpRows;
  const int c0 = blockIdx.y * SC;
  const float* vchunk = vp + (size_t)blockIdx.y * n_pad * SC;

  // tile `tile` of j into buffer `buf`: [x' halves | n' | V], 16 bytes a copy
  auto load_tile = [&](int buf, int tile) {
    float* sx = smem + buf * kTile;
    float* sn = sx + kTcTJ * PF;
    float* sv = sn + kTcTJ;
    const size_t j0 = (size_t)tile * kTcTJ;
    for (int c = tid; c < kTcTJ * KS * 4; c += 256) {
      const int jj = c / (KS * 4), u = c % (KS * 4);
      cp_async16(sx + jj * PF + u * 4,
                 xs + (j0 + jj) * packed_floats(KS) + u * 4, 16);
    }
    if (tid < kTcTJ / 4) cp_async16(sn + tid * 4, nrm + j0 + tid * 4, 16);
    for (int c = tid; c < kTcTJ * SC / 4; c += 256)
      cp_async16(sv + c * 4, vchunk + j0 * SC + c * 4, 16);
  };

  // this warp's rows: m-tile mt holds rows i0 + 16 mt + g and + 8 more
  uint32_t ah[2][KS][4], al[2][KS][4];
  float ni[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 16 * mt + 8 * h + g;
      const bool ok = i < n_pad;       // the last block may reach past n_pad
      ni[mt][h] = ok ? nrm[i] : 0.f;
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        const uint4 v = ok ? reinterpret_cast<const uint4*>(
                                 xs + (size_t)i * packed_floats(KS))[q * 4 + t]
                           : make_uint4(0u, 0u, 0u, 0u);
        // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
        ah[mt][q][h] = v.x;
        ah[mt][q][2 + h] = v.y;
        al[mt][q][h] = v.z;
        al[mt][q][2 + h] = v.w;
      }
    }

  // sums over all tiles, and (where the registers allow) over the running
  // tile, which joins them at the tile's end: two short sums in place of
  // one of n/4 terms
  constexpr bool kTwoLevel = SC <= 4;
  float acc[2][2][SC], tacc[2][2][kTwoLevel ? SC : 1];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < SC; ++c) acc[mt][h][c] = 0.f;

  const int ntiles = n_pad / kTcTJ;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  if (t_begin < t_end) load_tile(0, t_begin);
  cp_async_commit();
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    if (tile + 1 < t_end) load_tile(buf ^ 1, tile + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* sx = smem + buf * kTile;
    const float* sn = sx + kTcTJ * PF;
    const float* sv = sn + kTcTJ;
    if (kTwoLevel) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < SC; ++c) tacc[mt][h][c] = 0.f;
    }
#pragma unroll 2
    for (int nt = 0; nt < kTcTJ / 8; ++nt) {
      // B fragments of point 8 nt + g; entries of points 8 nt + 2t, + 1
      uint4 b[KS];
#pragma unroll
      for (int q = 0; q < KS; ++q)
        b[q] = *reinterpret_cast<const uint4*>(sx + (nt * 8 + g) * PF +
                                               (q * 4 + t) * 4);
      const float2 nj = *reinterpret_cast<const float2*>(sn + nt * 8 + 2 * t);
      float vj[2][SC];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int c = 0; c < SC; ++c)
          vj[e][c] = sv[(nt * 8 + 2 * t + e) * SC + c];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < KS; ++q) {
          mma_tf32(c4, al[mt][q][0], al[mt][q][1], al[mt][q][2], al[mt][q][3],
                   b[q].z, b[q].w);
          mma_tf32(c4, al[mt][q][0], al[mt][q][1], al[mt][q][2], al[mt][q][3],
                   b[q].x, b[q].y);
          mma_tf32(c4, ah[mt][q][0], ah[mt][q][1], ah[mt][q][2], ah[mt][q][3],
                   b[q].z, b[q].w);
          mma_tf32(c4, ah[mt][q][0], ah[mt][q][1], ah[mt][q][2], ah[mt][q][3],
                   b[q].x, b[q].y);
        }
        // c4: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ex = c4[2 * h + e] + (ni[mt][h] + (e ? nj.y : nj.x));
            const float kt = ex2_approx(fminf(ex, 0.f));
#pragma unroll
            for (int c = 0; c < SC; ++c) {
              if (kTwoLevel)
                tacc[mt][h][c] = fmaf(kt, vj[e][c], tacc[mt][h][c]);
              else
                acc[mt][h][c] = fmaf(kt, vj[e][c], acc[mt][h][c]);
            }
          }
      }
    }
    if (kTwoLevel) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < SC; ++c) acc[mt][h][c] += tacc[mt][h][c];
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // the 4 lanes of a row add their sums in a fixed order
  float* out_z = dst + (size_t)blockIdx.z * n * s;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 16 * mt + 8 * h + g;
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        float v = acc[mt][h][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0 && i < n && c0 + c < s) out_z[(size_t)i * s + c0 + c] = v;
      }
    }
}

template <int KS, int SC>
int launch_tc_tiles(const float* xs, const float* nrm, const float* vp,
                    float* dst, int n, int n_pad, int s, int splits,
                    cudaStream_t stream) {
  constexpr int bytes = 2 * tile_floats<KS, SC>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_matmat_tc_kernel<KS, SC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = n_pad / kTcTJ;
  const int per = (ntiles + splits - 1) / splits;
  const dim3 grid((n + kBI - 1) / kBI, (s + SC - 1) / SC, splits);
  kernel_matmat_tc_kernel<KS, SC><<<grid, 256, bytes, stream>>>(
      xs, nrm, vp, dst, n, n_pad, s, per);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_tc_chunks(const float* xs, const float* nrm, const float* vp,
                     float* dst, int n, int n_pad, int s, int splits,
                     cudaStream_t stream) {
  if (s == 1)
    return launch_tc_tiles<KS, 1>(xs, nrm, vp, dst, n, n_pad, s, splits,
                                  stream);
  if (s <= 4)
    return launch_tc_tiles<KS, 4>(xs, nrm, vp, dst, n, n_pad, s, splits,
                                  stream);
  return launch_tc_tiles<KS, 16>(xs, nrm, vp, dst, n, n_pad, s, splits,
                                 stream);
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------

// out[e] = part[0][e] + part[1][e] + ... in index order
template <typename T>
__global__ void add_splits_kernel(const T* __restrict__ part,
                                  T* __restrict__ out, size_t total,
                                  int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  T acc = part[e];
  for (int z = 1; z < splits; ++z) acc += part[(size_t)z * total + e];
  out[e] = acc;
}

template <typename T, int SC>
void launch_tiles(const T* X, const T* V, const T* norms, T* dst, int d,
                  int n, int s, T inv2s2, int splits, cudaStream_t stream) {
  const int ntiles = (n + kTJ - 1) / kTJ;
  const int per = (ntiles + splits - 1) / splits;
  const dim3 grid((n + kTI - 1) / kTI, (s + SC - 1) / SC, splits);
  kernel_matmat_kernel<T, SC><<<grid, kThreads, 0, stream>>>(
      X, V, norms, dst, d, n, s, inv2s2, per);
}

// norms (n,) and part (splits, n, s) are scratch; part is read only when
// splits > 1
template <typename T>
int launch_kernel_matmat(const void* X, const void* V, void* norms,
                         void* part, void* out, int d, int n, int s,
                         double inv2s2, int splits, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  col_norms_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      (const T*)X, (T*)norms, d, n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  T* dst = splits > 1 ? (T*)part : (T*)out;
  if (s == 1)
    launch_tiles<T, 1>((const T*)X, (const T*)V, (const T*)norms, dst, d, n,
                       s, (T)inv2s2, splits, stream);
  else if (s <= 4)
    launch_tiles<T, 4>((const T*)X, (const T*)V, (const T*)norms, dst, d, n,
                       s, (T)inv2s2, splits, stream);
  else
    launch_tiles<T, 16>((const T*)X, (const T*)V, (const T*)norms, dst, d, n,
                        s, (T)inv2s2, splits, stream);
  err = (int)cudaGetLastError();
  if (err || splits <= 1) return err;
  const size_t total = (size_t)n * s;
  add_splits_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (const T*)part, (T*)out, total, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 on the tensor cores, d <= 32 (else cudaErrorInvalidValue). `scratch`
// is one 16-byte aligned piece of n_pad (16 ks + 1 + ceil(s/sc) sc) floats,
// and splits * n * s more when splits > 1, with n_pad = n rounded up to
// 128, ks = 1, 2 or 4 for d <= 8, 16, 32 and sc = 1, 4 or 16 for s = 1,
// s <= 4 or more: the packed points xs, their norms nrm, V in chunks vp
// (each a multiple of 128 floats long) and the parts of a split sum.
int rl_kernel_matmat_f32(const void* X, const void* V, void* scratch,
                         void* out, int d, int n, int s, double inv2s2,
                         int splits, void* stream_) {
  // k-steps of 8 coordinates, rounded up to 1, 2 or 4 (zero rows)
  const int ks = d <= 8 ? 1 : d <= 16 ? 2 : 4;
  if (d > 8 * kMaxKSteps || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const int n_pad = (n + kTcTJ - 1) / kTcTJ * kTcTJ;
  const int sc = s == 1 ? 1 : s <= 4 ? 4 : 16;
  float* xs = (float*)scratch;
  float* nrm = xs + (size_t)n_pad * packed_floats(ks);
  float* vp = nrm + n_pad;
  float* part = vp + (size_t)((s + sc - 1) / sc) * n_pad * sc;
  // 2^(x'_i.x'_j - |x'_i|^2/2 - |x'_j|^2/2) = exp(-|x_i - x_j|^2 / (2 sigma^2))
  const float scale = (float)sqrt(2.0 * inv2s2 * 1.4426950408889634);
  pack_kernel<<<(n_pad + 127) / 128, 128, 0, stream>>>(
      (const float*)X, (const float*)V, xs, nrm, vp, d, n, n_pad, s, ks, sc,
      scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  float* dst = splits > 1 ? part : (float*)out;
  if (ks == 1)
    err = launch_tc_chunks<1>(xs, nrm, vp, dst, n, n_pad, s, splits, stream);
  else if (ks == 2)
    err = launch_tc_chunks<2>(xs, nrm, vp, dst, n, n_pad, s, splits, stream);
  else
    err = launch_tc_chunks<4>(xs, nrm, vp, dst, n, n_pad, s, splits, stream);
  if (err || splits <= 1) return err;
  const size_t total = (size_t)n * s;
  add_splits_kernel<float><<<(unsigned)((total + 255) / 256), 256, 0,
                             stream>>>(part, (float*)out, total, splits);
  return (int)cudaGetLastError();
}

int rl_kernel_matmat_simt_f32(const void* X, const void* V, void* norms,
                              void* part, void* out, int d, int n, int s,
                              double inv2s2, int splits, void* stream) {
  return launch_kernel_matmat<float>(X, V, norms, part, out, d, n, s,
                                     inv2s2, splits, stream);
}

int rl_kernel_matmat_f64(const void* X, const void* V, void* norms,
                         void* part, void* out, int d, int n, int s,
                         double inv2s2, int splits, void* stream) {
  return launch_kernel_matmat<double>(X, V, norms, part, out, d, n, s,
                                      inv2s2, splits, stream);
}

}  // extern "C"
