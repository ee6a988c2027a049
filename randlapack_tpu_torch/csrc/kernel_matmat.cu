// Fused squared-exponential kernel product for Hopper (sm_90a). Replaces
// the Pallas TPU kernel kernel_matmat of
// randlapack_tpu/ops/pallas_kernels.py:48 (pallas_call at :91):
//
//   out = K(X, X) V,   K_ij = exp(-max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0)
//                                 / (2 sigma^2))
//   X (d, n) one point per column, V (n, s)  ->  out (n, s)
//
// No tile of K is ever stored in device memory, nor in shared memory:
// each block owns 64 rows i and walks over tiles of 128 columns j; each of
// its 256 threads holds a 4x8 micro-tile of the cross products x_i.x_j
// (fp32 or fp64 FFMA over d, staged 16 deep through shared memory), turns
// it into kernel entries (the same formula as the TPU kernel: column norms
// plus cross term, clamped at 0, times 1/(2 sigma^2), expf/exp) and at
// once multiplies them into its partial sums of out (4 rows x SC columns
// of V in registers). The partial sums of the 16 threads that share a row
// meet once, after the last tile, by warp shuffles in a fixed order.
//
// Any n, d and s are taken: the edges are masked (a column j >= n enters
// with V_j = 0), d is walked in chunks of 16, and s in chunks of SC = 1, 4
// or 16 columns (grid.y), each of which recomputes its K entries. When
// n/64 row tiles are too few blocks to fill the card, the caller splits j
// over grid.z; each split writes its own partial result and a second
// kernel adds the splits in index order. No atomics: two launches on the
// same operands give the same bits.
//
// What bounds it on an H100: operations, not bytes (X, V and out are a few
// megabytes, the n^2 (2d + 2s + 6) flops and n^2 exponentials are not). At
// KRILL's shapes (d = 8, s = 1) each K entry costs 8 FFMA for the cross
// term, about 15 instructions for the clamp, scale and expf (one ex2 on
// the special-function unit) and one FFMA with V. A faster version would
// keep X_i in registers for small d, compute two entries per thread with
// packed instructions and overlap the next tile's loads (cp.async).

#include <cuda_runtime.h>
#include <cstddef>

namespace {

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

int rl_kernel_matmat_f32(const void* X, const void* V, void* norms,
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
