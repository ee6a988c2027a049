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
// The product is a SIMT GEMM in fp32 (or fp64) FFMA, no TF32: each block
// owns a 64 x 128 tile of out and walks over all of m in steps of 16, so
// the order of the sum is fixed and two runs give the same bits. Each of
// the 256 threads makes one Philox call a step (4 entries of the 64 x 16
// tile of S, written to shared memory) and accumulates a 4 x 8 micro-tile
// of 4 neighbouring rows by two groups of 4 neighbouring columns, so each
// step of the inner loop reads its operands with three 16-byte shared
// loads.
//
// What bounds it on an H100: operations (2 d m n flops against 4 m n
// bytes of A; at d >= 64 the FFMA rate is the limit). S is generated once
// for each 128 columns of out: a step costs a thread about 100 integer
// instructions (which run at half the fp32 rate) and 130 floating-point ones
// for its four entries beside the 512 FFMA of its micro-tile, and the two
// block barriers of a step are not overlapped with anything. A faster
// version would share one generated S tile between the blocks of a
// cluster along n (distributed shared memory), double-buffer the A tile
// (cp.async or TMA) and use a 3xTF32 split on wgmma.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

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

int rl_gaussian_sketch_f32(const void* A, void* out, int d, int m, int n,
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
