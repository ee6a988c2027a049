// Adaptive-sign unpivoted LU (LAPACK launhr_col_getrfnp2 semantics) for
// Hopper (sm_90a). Replaces the Pallas TPU kernel getrfnp_pallas of
// randlapack_tpu/ops/pallas_lu.py:39 (pallas_call at :91). This file
// builds the f32 kernels; getrfnp_f64.cu includes it for the f64 ones, so
// the two libraries compile at once.
//
// Factors M - diag(s) = L U of a square k x k matrix, choosing each
// s_j = -sign(current Schur diagonal) during the elimination, so every
// pivot d - s_j has |u_jj| >= 1 (d >= 0 gives d + 1, d < 0 gives d - 1).
// Output: F packed (unit-L strict lower + U upper), s (k,).
//
// What bounds it on an H100: the chain of k dependent elimination steps,
// not flops (2/3 k^3 = 11.2 MFLOP at k 256, ~22 us of one SM's FFMA).
//
// getrfnp_kernel, the blocked kernel: ONE block of 512 threads on one SM,
// right-looking over panels of kNb = 32 columns. For the panel at j:
//   P1  one warp factors the 32 x 32 diagonal block in registers (lane r
//       holds row r; the pivot row goes out by shuffles), choosing each
//       s_j from the current diagonal: no block barrier inside the steps;
//   P2  every thread solves a whole row of L21 = A21 U11^-1 or a whole
//       column of U12 = L11^-1 A12 in registers, L11/U11 read from a
//       32 x 33 copy in shared memory, and writes L21 transposed (LT);
//   P3  the rank-32 update A22 -= L21 U12 by warp tiles of 8 rows x 64
//       columns (8 x 2 values a thread), L21 read from LT by broadcast
//       16-byte loads.
// P1 and P2 are unrolled: rolled step loops (the register row shifted a
// place a step) ran slower in scratch builds.
// P1 of the next panel runs inside P3: warps 1-4 update the next diagonal
// block first and signal warp 0 (named barrier 2), which factors it while
// warps 1-15 update the rest and then write the finished panel to F. So
// a panel costs two block barriers, not two a step, and the chain of 32
// sign decisions hides behind the update wherever the update is longer.
// The trailing matrix lives in shared memory from the first panel where
// it fits (pick_resident): at k <= 224 f32 (k <= 128 f64) from the start,
// M copied in; at k 256 f32 after the first panel, which reads M and
// updates straight into shared memory, L21 and U12 staged there (LT and
// the last 32 rows of the copy, which it updates last, from L2). Panels
// before that work on F in device memory (L2), each warp tile loading its
// U12 values 16 rows at a time (8 in f64): those sizes (k 256 f64, 300,
// 2048) are correct, not fast.
//
// Every entry receives the same operations in the same order as in the
// flat elimination: at step p, a_rc = fma(-l_rp, u_pc, a_rc), l_rp =
// a_rp / pivot_p. So the blocked and the flat kernel agree bit for bit
// where the compiler contracts the flat kernel's a - l*u into the same fma.
// The plain versions (randlapack_tpu_torch/ops/lu.py: getrfnp, recursive;
// getrfnp_schedule, this kernel's order) round differently.
//
// getrfnp_flat_kernel, the earlier kernel (kept as getrfnp_flat): the flat
// k-step elimination of the Pallas kernel, one block of 1024 threads on F
// in device memory, two barriers and an L2 read of the diagonal a step.

#include <cuda_runtime.h>
#include <cstddef>
#include <type_traits>

namespace {

constexpr int kNb = 32;                      // panel width = warp width
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 8;                       // trailing tile: rows a thread
constexpr int kTC = 2;                       // columns a thread (lane + 32 q)
constexpr size_t kSmemMax = 232448;          // a block's dynamic shared memory

template <typename T>
using Diag = T[kNb + 1];                     // rows of the 32 x 33 copy

// a - l * u rounded once, as the flat kernel's contracted a -= l * u
__device__ __forceinline__ float fnma(float l, float u, float a) {
  return __fmaf_rn(-l, u, a);
}
__device__ __forceinline__ double fnma(double l, double u, double a) {
  return __fma_rn(-l, u, a);
}

// 32 consecutive values at p, in 16-byte pieces when vec (p 16-aligned)
template <typename T>
__device__ __forceinline__ void load_row(const T* p, T (&a)[kNb], bool vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < kNb; c += 16 / sizeof(T)) {
      if constexpr (sizeof(T) == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + c);
        a[c] = v.x; a[c + 1] = v.y; a[c + 2] = v.z; a[c + 3] = v.w;
      } else {
        const double2 v = *reinterpret_cast<const double2*>(p + c);
        a[c] = v.x; a[c + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kNb; ++c) a[c] = p[c];
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* p, const T (&a)[kNb], bool vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < kNb; c += 16 / sizeof(T)) {
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float4*>(p + c) =
            make_float4(a[c], a[c + 1], a[c + 2], a[c + 3]);
      else
        *reinterpret_cast<double2*>(p + c) = make_double2(a[c], a[c + 1]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kNb; ++c) p[c] = a[c];
  }
}

// named barrier id of count threads (a multiple of 32): wait, or arrive
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// kTR consecutive values at p (16-aligned, shared memory)
template <typename T>
__device__ __forceinline__ void load_tile_rows(const T* p, T (&l)[kTR]) {
#pragma unroll
  for (int i = 0; i < kTR; i += 16 / sizeof(T)) {
    if constexpr (sizeof(T) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      l[i] = v.x; l[i + 1] = v.y; l[i + 2] = v.z; l[i + 3] = v.w;
    } else {
      const double2 v = *reinterpret_cast<const double2*>(p + i);
      l[i] = v.x; l[i + 1] = v.y;
    }
  }
}

// P1: one warp factors the w x w diagonal block read at src (pitch lsrc)
// into A (pitch lda), w <= 32, lane r holding row r; writes the block to
// D and the signs to s. vec: src's rows are 16-byte aligned.
template <typename T>
__device__ __forceinline__ void factor_diag(const T* src, int lsrc, T* A,
                                            int lda, int w, bool vec,
                                            Diag<T>* D, T* s, int lane) {
  T a[kNb];
  if (w == kNb) {
    load_row(src + (size_t)lane * lsrc, a, vec);
  } else {
#pragma unroll
    for (int c = 0; c < kNb; ++c)
      a[c] = (lane < w && c < w) ? src[(size_t)lane * lsrc + c] : T(0);
  }
  T sv = T(0);
#pragma unroll
  for (int p = 0; p < kNb; ++p) {
    if (p < w) {
      const T d = __shfl_sync(0xffffffffu, a[p], p);
      const T sj = d >= T(0) ? T(-1) : T(1);
      const T piv = d - sj;
      const bool below = lane > p;
      const T l = a[p] / piv;
#pragma unroll
      for (int c = p + 1; c < kNb; ++c) {
        const T u = __shfl_sync(0xffffffffu, a[c], p);
        if (below) a[c] = fnma(l, u, a[c]);
      }
      if (below) a[p] = l;
      if (lane == p) {
        a[p] = piv;
        sv = sj;
      }
    }
  }
  if (lane < w) {
#pragma unroll
    for (int c = 0; c < kNb; ++c)
      if (c < w) A[(size_t)lane * lda + c] = a[c];
    s[lane] = sv;
  }
#pragma unroll
  for (int c = 0; c < kNb; ++c) D[lane][c] = a[c];
}

// P2: rows of L21 = A21 U11^-1 and columns of U12 = L11^-1 A12 of the
// panel of order n > 32 (so 32 wide), read at src and written to A (both
// pitch lda), one task a thread. L21 rows < nlt also go to LT transposed
// (LT[p * ltp + r]) when LT is given, U12 to Ust (pitch ldu) when given.
// vec: the rows of src and A are 16-byte aligned in device memory.
template <typename T>
__device__ __forceinline__ void solve_panel(const T* src, T* A, int lda,
                                            int n, bool vec, const Diag<T>* D,
                                            T* LT, int ltp, int nlt, T* Ust,
                                            int ldu, int tid) {
  const int n2 = n - kNb;
  for (int t = tid; t < 2 * n2; t += kThreads) {
    T a[kNb];
    if (t < n2) {
      load_row(src + (size_t)(kNb + t) * lda, a, vec);
#pragma unroll
      for (int p = 0; p < kNb; ++p) {
        const T l = a[p] / D[p][p];
        a[p] = l;
#pragma unroll
        for (int c = p + 1; c < kNb; ++c) a[c] = fnma(l, D[p][c], a[c]);
      }
      store_row(A + (size_t)(kNb + t) * lda, a, vec);
      if (LT != nullptr && t < nlt) {
#pragma unroll
        for (int p = 0; p < kNb; ++p) LT[p * ltp + t] = a[p];
      }
    } else {
      const int c = t - n2;
#pragma unroll
      for (int p = 0; p < kNb; ++p) a[p] = src[(size_t)p * lda + kNb + c];
#pragma unroll
      for (int p = 0; p < kNb; ++p)
#pragma unroll
        for (int r = p + 1; r < kNb; ++r) a[r] = fnma(D[r][p], a[p], a[r]);
#pragma unroll
      for (int p = 0; p < kNb; ++p) A[(size_t)p * lda + kNb + c] = a[p];
      if (Ust != nullptr) {
#pragma unroll
        for (int p = 0; p < kNb; ++p) Ust[(size_t)p * ldu + c] = a[p];
      }
    }
  }
}

// P2: rows of L21 = A21 U11^-1 and columns of U12 = L11^-1 A12 of the
// panel of order n > 32 at A (so 32 wide), one task a thread, in place;
// each L21 row also goes to LT transposed (LT[p * ltp + r]) when kLT.
// vec: A's rows are 16-byte aligned in device memory.
template <typename T, bool kLT>
__device__ __forceinline__ void solve_panel(T* A, int lda, int n, bool vec,
                                            const Diag<T>* D, T* LT, int ltp,
                                            int tid) {
  const int n2 = n - kNb;
  for (int t = tid; t < 2 * n2; t += kThreads) {
    T a[kNb];
    if (t < n2) {
      T* row = A + (size_t)(kNb + t) * lda;
      load_row(row, a, vec);
#pragma unroll
      for (int p = 0; p < kNb; ++p) {
        const T l = a[p] / D[p][p];
        a[p] = l;
#pragma unroll
        for (int c = p + 1; c < kNb; ++c) a[c] = fnma(l, D[p][c], a[c]);
      }
#pragma unroll
      for (int c = 0; c < kNb; ++c) row[c] = a[c];
      if (kLT) {
#pragma unroll
        for (int p = 0; p < kNb; ++p) LT[p * ltp + t] = a[p];
      }
    } else {
      T* col = A + kNb + (t - n2);
#pragma unroll
      for (int p = 0; p < kNb; ++p) a[p] = col[(size_t)p * lda];
#pragma unroll
      for (int p = 0; p < kNb; ++p)
#pragma unroll
        for (int r = p + 1; r < kNb; ++r) a[r] = fnma(D[r][p], a[p], a[r]);
#pragma unroll
      for (int p = 1; p < kNb; ++p) col[(size_t)p * lda] = a[p];
    }
  }
}

// P3 on one warp tile: rows r0 .. r0 + 7 (< rend) and columns
// cb + lane + 32 q (< cend) of dst = S22 - L21 U12, each entry taking its
// 32 terms one by one in p order. S22 at src (pitch lsrc); L21 and U12 in
// A (L21 row r at L + r * lda, U12 row p at U + p * lda). kLT: L21 read
// from its transposed copy LT in shared memory (a broadcast 16-byte load
// for 4 rows); else the tile's rows of L21 are loaded once, a column a
// lane, and handed out by shuffles, and its values of U12 are loaded
// kPre rows at a time ahead of their products (device memory).
template <typename T, int TC, bool kLT>
__device__ __forceinline__ void update_tile(const T* src, int lsrc,
                                            const T* L, const T* U, int lda,
                                            const T* LT, int ltp, T* dst,
                                            int ldd, int r0, int rend, int cb,
                                            int cend, int lane) {
  T acc[kTR][TC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int q = 0; q < TC; ++q) {
      const int r = r0 + i, c = cb + lane + 32 * q;
      acc[i][q] = (r < rend && c < cend) ? src[(size_t)r * lsrc + c] : T(0);
    }
  if constexpr (kLT) {
#pragma unroll 8
    for (int p = 0; p < kNb; ++p) {
      T l[kTR], u[TC];
      load_tile_rows(LT + p * ltp + r0, l);
#pragma unroll
      for (int q = 0; q < TC; ++q) {
        const int c = cb + lane + 32 * q;
        u[q] = c < cend ? U[(size_t)p * lda + c] : T(0);
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int q = 0; q < TC; ++q) acc[i][q] = fnma(l[i], u[q], acc[i][q]);
    }
  } else {
    constexpr int kPre = sizeof(T) == 4 ? kNb / 2 : kNb / 4;  // U12 rows a load
    T lr[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
      lr[i] = r0 + i < rend ? L[(size_t)(r0 + i) * lda + lane] : T(0);
#pragma unroll
    for (int p0 = 0; p0 < kNb; p0 += kPre) {
      T u[kPre][TC];
#pragma unroll
      for (int p = 0; p < kPre; ++p)
#pragma unroll
        for (int q = 0; q < TC; ++q) {
          const int c = cb + lane + 32 * q;
          u[p][q] = c < cend ? U[(size_t)(p0 + p) * lda + c] : T(0);
        }
#pragma unroll
      for (int p = 0; p < kPre; ++p)
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const T l = __shfl_sync(0xffffffffu, lr[i], p0 + p);
#pragma unroll
          for (int q = 0; q < TC; ++q)
            acc[i][q] = fnma(l, u[p][q], acc[i][q]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int q = 0; q < TC; ++q) {
      const int r = r0 + i, c = cb + lane + 32 * q;
      if (r < rend && c < cend) dst[(size_t)r * ldd + c] = acc[i][q];
    }
}

// P3 for the worker warps (1 ..): with diag, warps 1 .. w2 / 8 first
// update one 8-row tile each of the next diagonal block (w2 x w2) and
// signal warp 0 at barrier 2; then all take the tiles of rows [rb, re)
// of the update of the trailing matrix (order n2 + 32), all columns but
// the diagonal block's (rows and columns < w2).
template <typename T, bool kLT>
__device__ __forceinline__ void update_rows(const T* src, int lsrc,
                                            const T* L, const T* U, int lu,
                                            const T* LT, int ltp, T* dst,
                                            int ldd, int n2, int w2, int rb,
                                            int re, bool diag, int warp,
                                            int lane) {
  const int nd = (w2 + kTR - 1) / kTR;
  if (diag && warp <= nd) {
    update_tile<T, 1, kLT>(src, lsrc, L, U, lu, LT, ltp, dst, ldd,
                           (warp - 1) * kTR, w2, 0, w2, lane);
    named_arrive(2, 32 * (nd + 1));
  }
  const int ct1 = (n2 - w2 + 32 * kTC - 1) / (32 * kTC);
  const int ct2 = (n2 + 32 * kTC - 1) / (32 * kTC);
  const int ue = re < w2 ? re : w2, lb = rb > w2 ? rb : w2;
  const int t1 = rb < ue ? (ue - rb + kTR - 1) / kTR * ct1 : 0;
  const int tiles = t1 + (lb < re ? (re - lb + kTR - 1) / kTR * ct2 : 0);
  for (int t = warp - 1; t < tiles; t += kWarps - 1) {
    const bool up = t < t1;
    const int q = up ? t : t - t1, ct = up ? ct1 : ct2;
    update_tile<T, kTC, kLT>(src, lsrc, L, U, lu, LT, ltp, dst, ldd,
                             (up ? rb : lb) + q / ct * kTR, up ? ue : re,
                             (up ? w2 : 0) + q % ct * 32 * kTC, n2, lane);
  }
}

// Warp 0's part of P3: once warps 1 .. have updated the next diagonal
// block (w2 x w2, at dst), its P1 (signs to s_next).
template <typename T>
__device__ __forceinline__ void next_diag(T* dst, int ldd, int w2,
                                          Diag<T>* D, T* s_next, int lane) {
  named_sync(2, 32 * ((w2 + kTR - 1) / kTR + 1));
  factor_diag(dst, ldd, dst, ldd, w2, false, D, s_next, lane);
}

// A panel of order n > 32 while the trailing matrix is in shared memory
// (at A, pitch lds; its place in F at Fp, pitch k): P2, then P3 in place,
// the next P1 on warp 0. The workers then write the finished panel (its
// 32 rows and the 32 columns below them) to F while warp 0 factors.
template <typename T>
__device__ __forceinline__ void panel_resident(T* A, int lds, T* Fp, int k,
                                               int n, Diag<T>* D, T* LT,
                                               int ltp, T* s_next, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int n2 = n - kNb, w2 = n2 < kNb ? n2 : kNb;
  solve_panel(A, A, lds, n, false, D, LT, ltp, n2, (T*)nullptr, 0, tid);
  __syncthreads();
  const T* L = A + (size_t)kNb * lds;
  T* A22 = A + (size_t)kNb * lds + kNb;
  if (warp == 0) {
    next_diag(A22, lds, w2, D, s_next, lane);
  } else {
    update_rows<T, true>(A22, lds, L, A + kNb, lds, LT, ltp, A22, lds, n2,
                         w2, 0, n2, true, warp, lane);
    for (int r = warp - 1; r < n; r += kWarps - 1)
      for (int c = lane; c < (r < kNb ? n : kNb); c += 32)
        Fp[(size_t)r * k + c] = A[r * lds + c];
  }
  __syncthreads();
}

// A panel of order n > 32 in device memory: read at src (M for the first
// panel, else A; pitch k), written to A. Its update goes to A's trailing
// matrix, or, when stage (the last panel before the move), into S (pitch
// lds) in two passes: rows < n2 - 32 from L21 and U12 staged in shared
// memory (LT, and S's last 32 rows), then those last rows from A.
template <typename T>
__device__ __forceinline__ void panel_device(const T* src, T* A, int k,
                                             int n, bool vec, bool stage,
                                             T* S, int lds, Diag<T>* D,
                                             T* LT, int ltp, T* s_next,
                                             int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int n2 = n - kNb, w2 = n2 < kNb ? n2 : kNb;
  const int split = stage ? n2 - kNb : n2;
  T* Ust = stage ? S + (size_t)split * lds : nullptr;
  solve_panel(src, A, k, n, vec, D, stage ? LT : nullptr, ltp, split, Ust,
              lds, tid);
  __syncthreads();
  const T* src22 = src + (size_t)kNb * k + kNb;
  const T* L = A + (size_t)kNb * k;
  if (warp == 0) {
    next_diag(stage ? S : A + (size_t)kNb * k + kNb, stage ? lds : k, w2, D,
              s_next, lane);
  } else if (stage) {
    update_rows<T, true>(src22, k, L, Ust, lds, LT, ltp, S, lds, n2, w2, 0,
                         split, true, warp, lane);
    named_sync(1, kThreads - 32);   // the staged U12 is read: overwrite it
    update_rows<T, false>(src22, k, L, A + kNb, k, LT, ltp, S, lds, n2, w2,
                          split, n2, false, warp, lane);
  } else {
    T* A22 = A + (size_t)kNb * k + kNb;
    update_rows<T, false>(src22, k, L, A + kNb, k, LT, ltp, A22, k, n2, w2, 0,
                          n2, true, warp, lane);
  }
  __syncthreads();
}

// M (k x k) into dst (pitch ldd): 16-byte loads, eight in flight a
// thread, when vec (M 16-byte aligned, k a multiple of the vector)
template <typename T>
__device__ __forceinline__ void copy_in(const T* M, T* dst, int ldd, int k,
                                        bool vec, int tid) {
  using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
  constexpr int kV = 16 / sizeof(T);
  if (vec) {
    const int q = k / kV, total = k * q;
    for (int e0 = tid; e0 < total; e0 += 8 * kThreads) {
      V v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (e0 + u * kThreads < total)
          v[u] = reinterpret_cast<const V*>(M)[e0 + u * kThreads];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) {
          const T* x = reinterpret_cast<const T*>(&v[u]);
          T* d = dst + (size_t)(e / q) * ldd + e % q * kV;
#pragma unroll
          for (int i = 0; i < kV; ++i) d[i] = x[i];
        }
      }
    }
  } else {
    for (int r = tid / 32; r < k; r += kWarps)
      for (int c = tid % 32; c < k; c += 32)
        dst[(size_t)r * ldd + c] = M[(size_t)r * k + c];
  }
}

// L21's transposed copy: 32 rows of pitch ltp, a multiple of kTR
__host__ __device__ constexpr int lt_pitch(int n) {
  return n > kNb ? (n - kNb + kTR - 1) / kTR * kTR : 0;
}

// shared memory for a trailing matrix of order n: the 32 x 33 copy of the
// diagonal block, L21's transposed copy, the matrix with row pitch n + 1
template <typename T>
size_t smem_bytes(int n) {
  return sizeof(T) * ((size_t)kNb * (kNb + 1) + (size_t)kNb * lt_pitch(n) +
                      (size_t)n * (n + 1));
}

// The first panel (a multiple of kNb) whose trailing matrix fits in shared
// memory. The panel before it stages U12 in the copy's last 32 rows, so
// the copy must have more than 64 (it has over 100 wherever j > 0).
template <typename T>
int pick_resident(int k) {
  int j = 0;
  while (smem_bytes<T>(k - j) > kSmemMax) j += kNb;
  return j;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
getrfnp_kernel(const T* __restrict__ M, T* __restrict__ F,
               T* __restrict__ s, int k, int j_res) {
  extern __shared__ __align__(16) unsigned char smem_blocked[];
  Diag<T>* D = reinterpret_cast<Diag<T>*>(smem_blocked);
  T* LT = reinterpret_cast<T*>(smem_blocked) + kNb * (kNb + 1);
  const int nr = k - j_res, lds = nr + 1, ltp = lt_pitch(nr);
  T* S = LT + kNb * ltp;
  const int tid = threadIdx.x;
  const bool vec = reinterpret_cast<size_t>(F) % 16 == 0 &&
                   reinterpret_cast<size_t>(M) % 16 == 0 &&
                   k % (16 / sizeof(T)) == 0;
  if (j_res == 0) {
    copy_in(M, S, lds, k, vec, tid);
    __syncthreads();
  }
  if (tid < 32) {
    const bool res = j_res == 0;
    factor_diag(res ? S : M, res ? lds : k, res ? S : F, res ? lds : k,
                k < kNb ? k : kNb, vec && !res, D, s, tid);
  }
  __syncthreads();
  for (int j = 0; j < j_res; j += kNb) {
    T* A = F + (size_t)j * k + j;
    panel_device(j == 0 ? M : A, A, k, k - j, vec, j + kNb == j_res, S, lds,
                 D, LT, ltp, s + j + kNb, tid);
  }
  int j = j_res;
  for (; k - j > kNb; j += kNb)
    panel_resident(S + (size_t)(j - j_res) * (lds + 1), lds,
                   F + (size_t)j * k + j, k, k - j, D, LT, ltp, s + j + kNb,
                   tid);
  // the last panel (the others went out as they were finished)
  const int nl = k - j;
  for (int e = tid; e < nl * nl; e += kThreads)
    F[(size_t)(j + e / nl) * k + j + e % nl] =
        S[(j - j_res + e / nl) * lds + j - j_res + e % nl];
}

template <typename T>
int launch_getrfnp(const void* M, void* F, void* s, int k, void* stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        getrfnp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemMax);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int j_res = pick_resident<T>(k);
  getrfnp_kernel<T><<<1, kThreads, smem_bytes<T>(k - j_res),
                      (cudaStream_t)stream>>>((const T*)M, (T*)F, (T*)s, k,
                                              j_res);
  return (int)cudaGetLastError();
}

// ---- the earlier flat kernel (getrfnp_flat) ---------------------------------

constexpr int kSide = 32;                    // 32 x 32 threads
constexpr int kFlatThreads = kSide * kSide;  // 1024

template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
getrfnp_flat_kernel(const T* __restrict__ M, T* __restrict__ F,
                    T* __restrict__ s, int k) {
  extern __shared__ unsigned char smem_flat[];
  T* col = reinterpret_cast<T*>(smem_flat);   // scaled column j (rows > j)
  T* row = col + k;                          // row j (columns > j)
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kSide + tx;

  const size_t kk = (size_t)k * k;
  for (size_t e = tid; e < kk; e += kFlatThreads) F[e] = M[e];
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    const T d = F[(size_t)j * k + j];
    const T sj = d >= T(0) ? T(-1) : T(1);
    const T piv = d - sj;
    for (int r = j + 1 + tid; r < k; r += kFlatThreads) {
      const T c = F[(size_t)r * k + j] / piv;
      col[r] = c;
      F[(size_t)r * k + j] = c;
    }
    for (int c = j + 1 + tid; c < k; c += kFlatThreads)
      row[c] = F[(size_t)j * k + c];
    __syncthreads();
    // every thread has read d: the diagonal can take the pivot now
    if (tid == 0) {
      F[(size_t)j * k + j] = piv;
      s[j] = sj;
    }
    for (int r = j + 1 + ty; r < k; r += kSide) {
      const T cr = col[r];
      T* Fr = F + (size_t)r * k;
      for (int c = j + 1 + tx; c < k; c += kSide) Fr[c] -= cr * row[c];
    }
    __syncthreads();
  }
}

template <typename T>
int launch_getrfnp_flat(const void* M, void* F, void* s, int k,
                        void* stream) {
  const size_t smem = 2 * (size_t)k * sizeof(T);
  getrfnp_flat_kernel<T><<<1, dim3(kSide, kSide), smem,
                           (cudaStream_t)stream>>>((const T*)M, (T*)F,
                                                   (T*)s, k);
  return (int)cudaGetLastError();
}

}  // namespace

#ifndef RL_GETRFNP_F64

extern "C" {

int rl_getrfnp_f32(const void* M, void* F, void* s, int k, void* stream) {
  return launch_getrfnp<float>(M, F, s, k, stream);
}

int rl_getrfnp_flat_f32(const void* M, void* F, void* s, int k,
                        void* stream) {
  return launch_getrfnp_flat<float>(M, F, s, k, stream);
}

}  // extern "C"

#endif  // RL_GETRFNP_F64
