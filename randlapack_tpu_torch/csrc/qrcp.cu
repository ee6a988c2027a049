// HQRRP's two column-pivoted Householder kernels for Hopper (sm_90a).
// They replace the two Pallas TPU kernels of
// randlapack_tpu/ops/pallas_qrcp.py:
//
//   qrcp_select_pivots  (K5, pallas_qrcp.py:50, pallas_call at :142)
//       greedy Householder-QRCP pivot order of a (d, n) sketch restricted
//       to the live columns: nsteps reflector steps with Drmac partial-norm
//       downdating -> (nsteps,) pivot indices
//   qrcp_panel          (K6, pallas_qrcp.py:195, pallas_call at :316)
//       unblocked Householder QR(CP) of a full-height (m, b) panel from
//       row row0: in-panel column swaps, Drmac downdating, LAPACK packed
//       output W (R above, alpha on the diagonal, reflector tails below),
//       taus (b,) and the in-panel pivot order sigma (b,)
//
// Both are long chains of dependent reflector steps over an array that
// one SM cannot hold (at the main-path shapes the f32 sketch is 138 x 8192
// and the f32 panel 8192 x 128, 4.5 and 4 MB). So each is ONE persistent
// cooperative kernel: the array is cut into slabs (K5: ranges of columns,
// K6: ranges of rows >= row0), each block keeps its slab across all
// steps, and the steps are separated by grid-wide barriers
// (cooperative_groups grid.sync()); device memory sees only the per-step
// partials. Every block reduces the partials in the same fixed order with
// the same instructions, so the pivot, the reflector and the downdated
// norms are bit-identical in all blocks and no block broadcasts them.
// Pivot ties resolve as torch.argmax does: NaN first, then the larger
// value, then the lower index; unavailable columns score -1.
//
// What bounds them on an H100 is the latency of each step's chain, not
// flops or bytes: K5 does ~0.3 GFLOP a call at 138 x 8192 x 128 steps and
// K6 ~0.27 GFLOP at 8192 x 128, ~4 us at the 67 TFLOP/s fp32 peak, against
// 128 steps of dependent phases. Timestamps at every phase boundary of the
// first kernels of this file (their grid.sync() each ~1 us after the last
// block arrives) showed the blocks' own work to be most of a step: loops
// over a slab in shared memory, thread-0 serial sections, partials read in
// dependent batches. The step kernels (qrcp_*_step_kernel) are built
// around that:
//   - the slab lives in registers, each warp holding 8 columns and each
//     lane rows lane + 32 j, so a column sum is a warp's shuffles (9 for 8
//     columns) and the rank-1 update touches no shared memory;
//   - fewer exchanges a step: K6 has two, not three (step l's trailing
//     sums of squares are step l + 1's column norms, and the head row goes
//     out with them), K5 one, not two (each block sends its candidate's
//     column with its best value, and the winner's is read from its slot);
//   - one L2 round trip per exchange: a warp reads only its own columns'
//     partials, a few independent loads a lane, added in a fixed order;
//   - no serial thread-0 loops: pivot choice and larfg run in every warp
//     alike; K6 pivots by a logical column map and moves its columns to
//     their places once, at the end.
// The grid.sync() barriers stay. K6's step kernel sums a norm over the
// same rows as the plain version in another order, as the first kernel
// did. Shapes the step kernels cannot hold (K6: b > 128 or more row slabs
// than fit at once; K5: d > 256 or too many column slabs) take the first
// kernels of this file (the *_coop entry points), which keep slabs in
// shared memory where they fit and in device memory otherwise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <limits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 1024;     // the wrappers size the partials for it
constexpr int kSlab = 64;          // target columns of a K5 block
constexpr int kSplit = 4;          // K5 lanes sharing one column's rows
constexpr int kPad = 8;            // K5 shared slab row padding: the
                                   // kSplit lanes of a column hit distinct
                                   // banks
constexpr int kPanelRows = 64;     // target rows of a K6 block

// (a, ia) ranks ahead of (b, ib) in torch.argmax's order
template <typename T>
__device__ __forceinline__ bool ahead(T a, int ia, T b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && bn ? ia < ib : an;
  if (a != b) return a > b;
  return ia < ib;
}

// The warp's best (value, index) in torch.argmax's order, in lane 0.
template <typename T>
__device__ __forceinline__ void warp_best(T& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (ahead(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Sum over the kSplit lanes of a group (mask = the group's lanes); every
// lane gets the same bits, since float addition commutes.
template <typename T>
__device__ __forceinline__ T group_sum(T v, unsigned mask) {
  for (int off = 1; off < kSplit; off <<= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

// Sum over the block, in a fixed order; the result is valid in thread 0.
// `red` holds kWarps values; the caller syncs before reusing it.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = T(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Sum of p[g * stride] over g in [0, count), added in order g = 0, 1, ...
// (so every block gets the same bits), with the loads of the other blocks'
// partials issued kBatch at a time: one L2 round trip per batch, not per
// term.
constexpr int kBatch = 16;

template <typename T>
__device__ __forceinline__ T sum_in_order(const T* p, int count,
                                          size_t stride) {
  T acc = T(0);
  int g = 0;
  for (; g + kBatch <= count; g += kBatch) {
    T x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) x[k] = __ldcg(p + (size_t)(g + k) * stride);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) acc += x[k];
  }
  for (; g < count; ++g) acc += __ldcg(p + (size_t)g * stride);
  return acc;
}

// Drmac downdate of one column's partial norm dn and reference norm en
// from its new R entry rr; trail() gives the exact trailing norm, asked
// only where cancellation makes the downdate unreliable.
template <typename T, typename F>
__device__ __forceinline__ void downdate(T& dn, T& en, T rr, T tol3z,
                                         F trail) {
  if (dn == T(0)) return;
  const T dsafe = dn > T(0) ? dn : T(1);
  const T esafe = en > T(0) ? en : T(1);
  T temp = fabs(rr) / dsafe;
  temp = (T(1) + temp) * (T(1) - temp);
  temp = temp > T(0) ? temp : T(0);
  const T temp5 = dn / esafe;
  const T temp2 = temp * temp5 * temp5;
  if (temp2 <= tol3z) {
    const T t = trail();
    dn = t;
    en = t;
  } else {
    dn = dn * sqrt(temp);
  }
}

// ------------------------------------------------ K5, cooperative --

template <typename T>
struct SelectArgs {
  const T* Y;          // (d, n) row-major sketch
  const T* live;       // (n,) > 0 where the column may be chosen
  int64_t* chosen;     // (nsteps,) out
  T* gW;               // (d, n) working copy when the slab is not in smem
  T* gcol;             // (3, n) dN, eN, avail when the slab is not in smem
  T* xbuf;             // (d,) the pivot column, published by its owner
  T* part_val;         // (kMaxGrid,) per-block best value
  int* part_idx;       // (kMaxGrid,) per-block best index
  int d, n, nsteps, ncol, in_smem;
  T tol3z;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
qrcp_select_coop_kernel(SelectArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int d = a.d;
  const int c0 = blockIdx.x * a.ncol;
  const int nc = max(0, min(a.ncol, a.n - c0));

  T *W, *dN, *eN, *av, *v;
  size_t ld;
  if (a.in_smem) {
    W = sm;
    ld = a.ncol + kPad;
    dN = W + (size_t)d * ld;
    eN = dN + a.ncol;
    av = eN + a.ncol;
    v = av + a.ncol;
  } else {
    W = a.gW + c0;
    ld = a.n;
    dN = a.gcol + c0;
    eN = dN + a.n;
    av = eN + a.n;
    v = sm;
  }
  T* red = v + d;                 // kThreads values
  T* sc = red + kThreads;         // 4 scalars
  int* ridx = reinterpret_cast<int*>(sc + 4);   // kThreads indices

  // W = Y on the live columns (0 elsewhere), dN = eN = column norms
  for (int jl = tid; jl < nc; jl += kThreads) {
    const int j = c0 + jl;
    const bool lv = a.live[j] > T(0);
    T s = T(0);
    for (int r = 0; r < d; ++r) {
      const T y = lv ? a.Y[(size_t)r * a.n + j] : T(0);
      W[r * ld + jl] = y;
      s += y * y;
    }
    dN[jl] = sqrt(s);
    eN[jl] = dN[jl];
    av[jl] = lv ? T(1) : T(0);
  }

  for (int l = 0; l < a.nsteps; ++l) {
    // 1. this block's best (value, index); -2 loses to every column
    T bv = T(-2);
    int bi = INT_MAX;
    for (int jl = tid; jl < nc; jl += kThreads) {
      const T val = av[jl] > T(0) ? dN[jl] : T(-1);
      if (ahead(val, c0 + jl, bv, bi)) {
        bv = val;
        bi = c0 + jl;
      }
    }
    warp_best(bv, bi);
    if ((tid & 31) == 0) {
      red[tid >> 5] = bv;
      ridx[tid >> 5] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w)
        if (ahead(red[w], ridx[w], bv, bi)) {
          bv = red[w];
          bi = ridx[w];
        }
      __stcg(a.part_val + blockIdx.x, bv);
      __stcg(a.part_idx + blockIdx.x, bi);
    }
    grid.sync();

    // 2. every block reduces the partials in the same order -> p; the
    // owner of column p publishes it and retires it
    if (tid < 32) {
      // the maximum is unique in this order, so any reduction order
      // gives every block the same p
      T gv = T(-2);
      int gi = INT_MAX;
      for (int g = tid; g < (int)gridDim.x; g += 32) {
        const T val = __ldcg(a.part_val + g);
        const int ix = __ldcg(a.part_idx + g);
        if (ahead(val, ix, gv, gi)) {
          gv = val;
          gi = ix;
        }
      }
      warp_best(gv, gi);
      if (tid == 0) ridx[0] = gi;
    }
    __syncthreads();
    const int p = ridx[0];
    if (p >= c0 && p < c0 + nc) {
      const int pl = p - c0;
      for (int r = tid; r < d; r += kThreads) __stcg(a.xbuf + r, W[r * ld + pl]);
      if (tid == 0) av[pl] = T(0);
    }
    if (blockIdx.x == 0 && tid == 0) a.chosen[l] = p;
    grid.sync();

    // 3. larfg on column p with its head at row l, redundantly per block
    for (int r = tid; r < d; r += kThreads) v[r] = __ldcg(a.xbuf + r);
    __syncthreads();
    T s2 = T(0);
    for (int r = l + tid; r < d; r += kThreads) s2 += v[r] * v[r];
    s2 = block_sum(s2, red);
    if (tid == 0) {
      const T xi = v[l];
      const T normx = sqrt(s2);
      const T alpha = xi >= T(0) ? -normx : normx;
      const T denom = xi - alpha;
      const bool safe = fabs(denom) > T(0);
      T tau = safe ? (alpha - xi) / (alpha != T(0) ? alpha : T(1)) : T(0);
      if (!(normx > T(0))) tau = T(0);
      sc[0] = tau;
      sc[1] = safe ? denom : T(1);
    }
    __syncthreads();
    const T tau = sc[0];
    const T denom_s = sc[1];
    for (int r = tid; r < d; r += kThreads)
      v[r] = r > l ? v[r] / denom_s : (r == l ? T(1) : T(0));
    __syncthreads();

    // 4. apply H = I - tau v v^T to the available columns, then downdate;
    // kSplit neighbouring lanes share a column, each taking every
    // kSplit-th row, so a step's dependent chain is d / kSplit long
    const int q = tid % kSplit;
    const unsigned gmask = ((1u << kSplit) - 1) << ((tid & 31) & ~(kSplit - 1));
    for (int jl = tid / kSplit; jl < nc; jl += kThreads / kSplit) {
      if (!(av[jl] > T(0))) continue;
      T dn = dN[jl], en = eN[jl];
      T s = T(0);
      for (int r = l + q; r < d; r += kSplit) s += v[r] * W[r * ld + jl];
      const T w = tau * group_sum(s, gmask);
      for (int r = l + q; r < d; r += kSplit) W[r * ld + jl] -= v[r] * w;
      __syncwarp(gmask);
      downdate(dn, en, W[l * ld + jl], a.tol3z, [&]() {
        T t = T(0);
        for (int r = l + 1 + q; r < d; r += kSplit) {
          const T x = W[r * ld + jl];
          t += x * x;
        }
        return sqrt(group_sum(t, gmask));
      });
      if (q == 0) {
        dN[jl] = dn;
        eN[jl] = en;
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------ K6, cooperative --

template <typename T>
struct PanelArgs {
  const T* P;          // (m, b) row-major panel
  T* W;                // (m, b) out, packed
  T* taus;             // (b,) out
  int64_t* sigma;      // (b,) out
  T* part;             // partials: see the layout below
  int m, b, row0, rows_per, pivot, in_smem;
  T tol3z;
};

// Column sums over this block's rows [r_begin, nr) of f(r, c) for the
// columns c in [c_begin, b), in a fixed order; out[c] in shared memory.
template <typename T, typename F>
__device__ void column_sums(int b, int c_begin, int r_begin, int nr, F f,
                            T* red, T* out) {
  const int S = b < kThreads ? kThreads / b : 1;
  for (int e = threadIdx.x; e < b * S; e += kThreads) {
    const int c = e % b, s = e / b;
    T acc = T(0);
    if (c >= c_begin)
      for (int r = r_begin + s; r < nr; r += S) acc += f(r, c);
    red[e] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < b; c += kThreads) {
    T acc = T(0);
    for (int s = 0; s < S; ++s) acc += red[s * b + c];
    out[c] = acc;
  }
  __syncthreads();
}

// Sum of every block's partial row (G, b) for c >= c_begin, in a fixed
// order: S threads a column each add every S-th block's row, then the S
// sums are added in order. out[c] in shared memory.
template <typename T>
__device__ void grid_column_sums(const T* part, int b, int c_begin, T* red,
                                 T* out) {
  const int S = b < kThreads ? kThreads / b : 1;
  const int G = gridDim.x;
  for (int e = threadIdx.x; e < b * S; e += kThreads) {
    const int c = e % b, s = e / b;
    red[e] = c >= c_begin && s < G
                 ? sum_in_order(part + (size_t)s * b + c, (G - s + S - 1) / S,
                                (size_t)S * b)
                 : T(0);
  }
  __syncthreads();
  for (int c = c_begin + threadIdx.x; c < b; c += kThreads) {
    T acc = T(0);
    for (int s = 0; s < S; ++s) acc += red[s * b + c];
    out[c] = acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qrcp_panel_coop_kernel(PanelArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int b = a.b;
  const int rlo = a.row0 + blockIdx.x * a.rows_per;
  const int nr = max(0, min(a.rows_per, a.m - rlo));
  const int RS = b > kThreads ? b : kThreads;

  T* slab = a.in_smem ? sm : a.W + (size_t)rlo * b;
  T* dN = sm + (a.in_smem ? (size_t)a.rows_per * b : 0);
  T* eN = dN + b;
  T* wv = eN + b;           // per-column reduced values of the step
  T* red = wv + b;          // RS values
  T* sc = red + RS;         // 4 scalars
  int* sig = reinterpret_cast<int*>(sc + 4);   // b in-panel pivots
  // partials in device memory
  T* p_norm = a.part;                        // (G,) sum x_r^2, rows >= i
  T* p_xi = p_norm + kMaxGrid;               // x_i, from row i's owner
  T* p_dot = p_xi + 1;                       // (G, b)
  T* p_trail = p_dot + (size_t)kMaxGrid * b; // (G, b)
  T* p_rrow = p_trail + (size_t)kMaxGrid * b;  // (b,) row i, from its owner

  for (size_t e = tid; e < (size_t)nr * b; e += kThreads)
    slab[e] = a.P[(size_t)rlo * b + e];
  for (int c = tid; c < b; c += kThreads) sig[c] = c;
  __syncthreads();
  column_sums(b, 0, 0, nr, [&](int r, int c) {
    const T x = slab[(size_t)r * b + c];
    return x * x;
  }, red, wv);
  for (int c = tid; c < b; c += kThreads)
    __stcg(p_trail + (size_t)blockIdx.x * b + c, wv[c]);
  grid.sync();
  grid_column_sums(p_trail, b, 0, red, wv);
  for (int c = tid; c < b; c += kThreads) {
    dN[c] = sqrt(wv[c]);
    eN[c] = dN[c];
  }
  __syncthreads();

  for (int l = 0; l < b; ++l) {
    const int i = a.row0 + l;
    const int il = i - rlo;             // row i in this block's slab
    const int ra = max(0, il);          // first local row >= i
    // 1. pivot among columns >= l and the swap l <-> p (all blocks alike)
    if (a.pivot) {
      if (tid < 32) {
        T bv = T(-2);         // loses to every column (dN >= 0 or NaN)
        int p = INT_MAX;
        for (int c = l + tid; c < b; c += 32)
          if (ahead(dN[c], c, bv, p)) {
            bv = dN[c];
            p = c;
          }
        warp_best(bv, p);
        if (tid == 0) {
          T t = dN[l]; dN[l] = dN[p]; dN[p] = t;
          t = eN[l]; eN[l] = eN[p]; eN[p] = t;
          const int s = sig[l]; sig[l] = sig[p]; sig[p] = s;
          *reinterpret_cast<int*>(sc + 3) = p;
        }
      }
      __syncthreads();
      const int p = *reinterpret_cast<int*>(sc + 3);
      if (p != l)
        for (int r = tid; r < nr; r += kThreads) {
          T* row = slab + (size_t)r * b;
          const T t = row[l]; row[l] = row[p]; row[p] = t;
        }
      __syncthreads();
    }

    // 2. ||x[i:]||^2 of column l -> larfg, identical in every block
    T s2 = T(0);
    for (int r = ra + tid; r < nr; r += kThreads) {
      const T x = slab[(size_t)r * b + l];
      s2 += x * x;
    }
    s2 = block_sum(s2, red);
    if (tid == 0) {
      __stcg(p_norm + blockIdx.x, s2);
      if (il >= 0 && il < nr) __stcg(p_xi, slab[(size_t)il * b + l]);
    }
    grid.sync();
    T n2 = T(0);
    if (tid < 32) {
      for (int g = tid; g < G; g += 32) n2 += __ldcg(p_norm + g);
      for (int off = 16; off > 0; off >>= 1)
        n2 += __shfl_down_sync(0xffffffffu, n2, off);
    }
    if (tid == 0) {
      const T xi = __ldcg(p_xi);
      const T normx = sqrt(n2);
      T alpha = xi >= T(0) ? -normx : normx;
      const T denom = xi - alpha;
      const bool safe = fabs(denom) > T(0);
      T tau = safe ? (alpha - xi) / (alpha != T(0) ? alpha : T(1)) : T(0);
      if (!(normx > T(0))) {
        tau = T(0);
        alpha = xi;
      }
      sc[0] = tau;
      sc[1] = safe ? denom : T(1);
      sc[2] = alpha;
    }
    __syncthreads();
    const T tau = sc[0], denom_s = sc[1], alpha = sc[2];
    // column l becomes its packed form: alpha at row i, v below (rows
    // above i keep their R values: v is 0 there, so H leaves them)
    for (int r = ra + tid; r < nr; r += kThreads) {
      T* x = slab + (size_t)r * b + l;
      *x = r == il ? alpha : *x / denom_s;
    }
    __syncthreads();

    // 3. w_c = tau * v^T W[:, c] for c > l (v_i = 1, the tail in col l)
    column_sums(b, l + 1, ra, nr, [&](int r, int c) {
      const T vr = r == il ? T(1) : slab[(size_t)r * b + l];
      return vr * slab[(size_t)r * b + c];
    }, red, wv);
    for (int c = l + 1 + tid; c < b; c += kThreads)
      __stcg(p_dot + (size_t)blockIdx.x * b + c, wv[c]);
    grid.sync();
    grid_column_sums(p_dot, b, l + 1, red, wv);
    // one warp a row, its lanes across the columns
    for (int r = ra + (tid >> 5); r < nr; r += kWarps) {
      T* row = slab + (size_t)r * b;
      const T vr = r == il ? T(1) : row[l];
      for (int c = l + 1 + (tid & 31); c < b; c += 32)
        row[c] -= vr * (tau * wv[c]);
    }
    if (blockIdx.x == 0 && tid == 0) a.taus[l] = tau;
    __syncthreads();

    // 4. Drmac downdate of the columns > l: r_row from row i's owner,
    // exact trailing norms (rows > i) reduced over the grid
    if (a.pivot && l + 1 < b) {
      column_sums(b, l + 1, max(0, il + 1), nr, [&](int r, int c) {
        const T x = slab[(size_t)r * b + c];
        return x * x;
      }, red, wv);
      for (int c = l + 1 + tid; c < b; c += kThreads) {
        __stcg(p_trail + (size_t)blockIdx.x * b + c, wv[c]);
        if (il >= 0 && il < nr)
          __stcg(p_rrow + c, slab[(size_t)il * b + c]);
      }
      grid.sync();
      grid_column_sums(p_trail, b, l + 1, red, wv);
      for (int c = l + 1 + tid; c < b; c += kThreads) {
        T dn = dN[c], en = eN[c];
        const T t = sqrt(wv[c]);
        downdate(dn, en, __ldcg(p_rrow + c), a.tol3z, [&]() { return t; });
        dN[c] = dn;
        eN[c] = en;
      }
      __syncthreads();
    }
  }

  // rows above row0 are untouched but move with the column swaps
  for (size_t e = (size_t)blockIdx.x * kThreads + tid;
       e < (size_t)a.row0 * b; e += (size_t)G * kThreads) {
    const size_t r = e / b;
    const int c = (int)(e % b);
    a.W[e] = a.P[r * b + sig[c]];
  }
  if (a.in_smem)
    for (size_t e = tid; e < (size_t)nr * b; e += kThreads)
      a.W[(size_t)rlo * b + e] = slab[e];
  if (blockIdx.x == 0)
    for (int c = tid; c < b; c += kThreads) a.sigma[c] = sig[c];
}

// ------------------------------------------- the step kernels: helpers --

constexpr int kCols = 8;           // columns a warp holds in registers

// a[k] for a k only known at run time, without local memory
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int k) {
  T r = a[0];
#pragma unroll
  for (int q = 1; q < N; ++q)
    if (q == k) r = a[q];
  return r;
}

// x[j][k] for a row j only known at run time
template <typename T, int R, int C>
__device__ __forceinline__ T pick_row(const T (&x)[R][C], int j, int k) {
  T t = x[0][k];
#pragma unroll
  for (int q = 1; q < R; ++q)
    if (q == j) t = x[q][k];
  return t;
}

// The warp's best (value, index, tag) in torch.argmax's order, in every
// lane: a butterfly over a total order, so all lanes end with the same one.
template <typename T>
__device__ __forceinline__ void warp_best_all(T& v, int& i, int& tag) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    const int ot = __shfl_xor_sync(0xffffffffu, tag, off);
    if (ahead(ov, oi, v, i)) {
      v = ov;
      i = oi;
      tag = ot;
    }
  }
}

// Sum over the warp's lanes, the same bits in every lane (a butterfly:
// each pair adds the same two values).
template <typename T>
__device__ __forceinline__ T warp_sum_all(T v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Lanes exchange half of their kCols sums with the lane `off` away and keep
// the other half (the upper half in the lane with that bit set).
template <int H, typename T>
__device__ __forceinline__ void keep_half(T (&s)[kCols], int off) {
  const bool upper = threadIdx.x & off;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const T send = upper ? s[k] : s[k + H];
    const T keep = upper ? s[k + H] : s[k];
    s[k] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// The warp's column sums of s[k] (one partial per lane and column) in 9
// shuffles: lane t ends with the sum of column (t >> 2), the same bits in
// its group of 4 lanes. s is clobbered.
template <typename T>
__device__ __forceinline__ T warp_column_sums(T (&s)[kCols]) {
  keep_half<4>(s, 16);
  keep_half<2>(s, 8);
  keep_half<1>(s, 4);
  T t = s[0];
  t += __shfl_xor_sync(0xffffffffu, t, 1);
  t += __shfl_xor_sync(0xffffffffu, t, 2);
  return t;
}

// Sum over the G blocks of part[g * b + c], for lane t's column c (its
// group of 4 lanes reads every 4th block, in order, then adds the 4 sums
// by a butterfly), so every block gets the same bits. The loads of a lane
// are independent: one L2 round trip.
template <typename T>
__device__ __forceinline__ T grid_column_sum(const T* part, int G, int b,
                                             int c) {
  T acc = T(0);
  if (c < b) {
#pragma unroll 8
    for (int g = threadIdx.x & 3; g < G; g += 4)
      acc += __ldcg(part + (size_t)g * b + c);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// larfg's scalars from the column's squared norm on rows >= its head and
// the head xi: tau, the divisor of the tail and alpha (LAPACK semantics;
// a zero column gives tau 0 and alpha xi)
template <typename T>
struct Reflector {
  T tau, denom, alpha;
  __device__ __forceinline__ Reflector(T norm2, T xi) {
    const T normx = sqrt(norm2);
    alpha = xi >= T(0) ? -normx : normx;
    const T d = xi - alpha;
    const bool safe = fabs(d) > T(0);
    tau = safe ? (alpha - xi) / (alpha != T(0) ? alpha : T(1)) : T(0);
    if (!(normx > T(0))) {
      tau = T(0);
      alpha = xi;
    }
    denom = safe ? d : T(1);
  }
};

// ----------------------------------------------------------- K5 step --
//
// 8 warps a block, each holding 8 columns of the sketch in registers, a
// lane the rows lane + 32 j (j < RPL); a group of 4 lanes keeps the norms
// of one column. One grid exchange a step: every warp offers its best
// (value, index) and that column as it stands. After the barrier each
// block finds the best offer (warp w reads offers w G .. w G + G - 1, and
// the 8 warp results are compared in shared memory; the maximum under
// torch.argmax's total order does not depend on the order) and reads the
// winner's column once into shared memory; every warp then builds the
// reflector and applies it to its own columns. Offers are
// double-buffered by the step's parity, since a block may offer step
// l + 1 while a slower one still reads step l.

template <typename T>
struct SelectStepArgs {
  const T* Y;          // (d, n) row-major sketch
  const T* live;       // (n,) > 0 where the column may be chosen
  int64_t* chosen;     // (nsteps,) out
  T* slot;             // (2, 8 G, d) each warp's offered column
  T* part_val;         // (2, 8 G) its value
  int* part_idx;       // (2, 8 G) and its index
  int d, n, nsteps;
  T tol3z;
};

constexpr int kSelWarps = 8;
constexpr int kSelBlockCols = kSelWarps * kCols;

template <typename T, int RPL>
__global__ void __launch_bounds__(kSelWarps * 32)
qrcp_select_step_kernel(SelectStepArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T wv[kSelWarps], xcol[32 * RPL];
  __shared__ int wi[kSelWarps], ws[kSelWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int G = gridDim.x, d = a.d, n = a.n;
  const int S = G * kSelWarps;             // offers a step
  const int c0 = blockIdx.x * kSelBlockCols + w * kCols;
  const int mk = lane >> 2, mc = c0 + mk;  // this lane's column

  T x[RPL][kCols], s[kCols];
  unsigned avail = 0;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int c = c0 + k;
    const bool lv = c < n && a.live[c] > T(0);
    avail |= lv ? 1u << k : 0u;
    s[k] = T(0);
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int r = lane + 32 * j;
      x[j][k] = lv && r < d ? a.Y[(size_t)r * n + c] : T(0);
      s[k] += x[j][k] * x[j][k];
    }
  }
  T dn = sqrt(warp_column_sums(s)), en = dn;

  for (int l = 0; l < a.nsteps; ++l) {
    const int par = l & 1;
    // this warp's offer, the same in every lane; -2 loses to every column
    T bv = mc < n ? (avail >> mk & 1 ? dn : T(-1)) : T(-2);
    int bi = mc < n ? mc : INT_MAX, unused = 0;
    warp_best_all(bv, bi, unused);
    const int me = par * S + blockIdx.x * kSelWarps + w;
    T* col = a.slot + (size_t)me * d;
#pragma unroll
    for (int j = 0; j < RPL; ++j)
      if (lane + 32 * j < d) __stcg(col + lane + 32 * j, pick(x[j], bi - c0));
    if (lane == 0) {
      __stcg(a.part_val + me, bv);
      __stcg(a.part_idx + me, bi);
    }
    grid.sync();

    // the best offer: G of them a warp, all loads of a batch first (one L2
    // round trip), then the warps' results
    {
      T pv = T(-2);
      int p = INT_MAX, ps = 0;
      constexpr int kBatch = 8;
      for (int q0 = lane; q0 < G; q0 += 32 * kBatch) {
        T val[kBatch];
        int ix[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int o = par * S + w * G + q0 + 32 * q;
          val[q] = q0 + 32 * q < G ? __ldcg(a.part_val + o) : T(-2);
          ix[q] = q0 + 32 * q < G ? __ldcg(a.part_idx + o) : INT_MAX;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (ahead(val[q], ix[q], pv, p)) {
            pv = val[q];
            p = ix[q];
            ps = w * G + q0 + 32 * q;
          }
      }
      warp_best_all(pv, p, ps);
      if (lane == 0) {
        wv[w] = pv;
        wi[w] = p;
        ws[w] = ps;
      }
    }
    __syncthreads();
    T pv = wv[0];
    int p = wi[0], ps = ws[0];
#pragma unroll
    for (int q = 1; q < kSelWarps; ++q)
      if (ahead(wv[q], wi[q], pv, p)) {
        pv = wv[q];
        p = wi[q];
        ps = ws[q];
      }
    if (blockIdx.x == 0 && threadIdx.x == 0) a.chosen[l] = p;
    if (p >= c0 && p < c0 + kCols) avail &= ~(1u << (p - c0));
    const T* wcol = a.slot + (size_t)(par * S + ps) * d;
    for (int r = threadIdx.x; r < d; r += blockDim.x)
      xcol[r] = __ldcg(wcol + r);
    __syncthreads();

    // larfg on the winner's column, head at row l
    T v[RPL];
    T s2 = T(0);
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int r = lane + 32 * j;
      v[j] = r < d ? xcol[r] : T(0);
      if (r >= l) s2 += v[j] * v[j];
    }
    s2 = warp_sum_all(s2);
    const T xi = __shfl_sync(0xffffffffu, pick(v, l >> 5), l & 31);
    const Reflector<T> h(s2, xi);
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int r = lane + 32 * j;
      v[j] = r > l ? v[j] / h.denom : (r == l ? T(1) : T(0));
    }

    // apply H = I - tau v v^T to this warp's available columns
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      s[k] = T(0);
#pragma unroll
      for (int j = 0; j < RPL; ++j)
        if (lane + 32 * j >= l) s[k] += v[j] * x[j][k];
    }
    const T tw = h.tau * warp_column_sums(s);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const T twk = __shfl_sync(0xffffffffu, tw, 4 * k);
      if (avail >> k & 1) {
#pragma unroll
        for (int j = 0; j < RPL; ++j)
          if (lane + 32 * j >= l) x[j][k] -= v[j] * twk;
      }
    }
    // Drmac downdate of this lane's column from its row l and its exact
    // trailing norm (the sum is cheap beside a branch around shuffles)
    T rk[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      rk[k] = __shfl_sync(0xffffffffu, pick_row(x, l >> 5, k), l & 31);
      s[k] = T(0);
#pragma unroll
      for (int j = 0; j < RPL; ++j)
        if (lane + 32 * j > l) s[k] += x[j][k] * x[j][k];
    }
    const T t2 = warp_column_sums(s);
    if (avail >> mk & 1)
      downdate(dn, en, pick(rk, mk), a.tol3z, [&]() { return sqrt(t2); });
  }
}

// ----------------------------------------------------------- K6 step --
//
// 16 warps a block over 32 RPL rows of the panel (from row0 on), each warp
// holding 8 columns of them in registers, a lane the rows lane + 32 j.
// Two grid exchanges a step:
//   A (before step l): every block's column sums of squares of its rows
//     >= i = row0 + l, and row i itself from its owner. They give the
//     Drmac downdate of step l - 1 (the exact trailing norms, and row
//     i - 1's R entries as row i - 1 minus tau w), step l's pivot, its
//     larfg norm and its head, all computed by every block alike;
//   B: the partial dot products v^T W of step l, whose sums give the
//     rank-1 update; the sums of squares of the updated rows > i and row
//     i + 1 then go out as step l + 1's exchange A.
// Pivoting swaps nothing: a logical column map (lg: physical -> logical,
// ph: logical -> physical) decides ties as the swapped panel would, and
// the columns are written to their logical places once at the end.

template <typename T>
struct PanelStepArgs {
  const T* P;          // (m, b) row-major panel
  T* W;                // (m, b) out, packed
  T* taus;             // (b,) out
  int64_t* sigma;      // (b,) out
  T* part;             // (S, b) dots, (S, b) sums of squares, (b,) a row
  int m, b, row0, pivot;
  int slabs;           // S: blocks that hold rows; the others only copy
  T tol3z;
};

constexpr int kPanelWarps = 16;
constexpr int kPanelMaxB = kPanelWarps * kCols;   // 128

// The steps of a block that holds rows row0 + 32 RPL blockIdx.x on; it
// passes 2 b - 1 grid barriers
template <typename T, int RPL>
__device__ __forceinline__ void panel_steps(const PanelStepArgs<T>& a,
                                            cg::grid_group& grid) {
  __shared__ T Ss[kPanelMaxB], Hs[kPanelMaxB], vs[32 * RPL];
  __shared__ T bval[kPanelWarps];
  __shared__ int blog[kPanelWarps], bphys[kPanelWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int G = a.slabs, b = a.b, m = a.m;
  const int rlo = a.row0 + blockIdx.x * 32 * RPL;
  const int c0 = w * kCols;
  const int mk = lane >> 2, mc = c0 + mk;  // the column this lane reduces
  int lgm = mc;                        // and its logical position
  T* p_dot = a.part;
  T* p_sq = p_dot + (size_t)G * b;
  T* p_row = p_sq + (size_t)G * b;

  T x[RPL][kCols];
  unsigned live = 0;                   // this warp's columns not yet chosen
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    live |= c0 + k < b ? 1u << k : 0u;
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int r = rlo + lane + 32 * j;
      x[j][k] = r < m && c0 + k < b ? a.P[(size_t)r * b + c0 + k] : T(0);
    }
  }
  // exchange A of step 0: rows >= row0, row row0 from block 0
  {
    T s[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      s[k] = T(0);
#pragma unroll
      for (int j = 0; j < RPL; ++j) s[k] += x[j][k] * x[j][k];
    }
    const T t = warp_column_sums(s);
    if ((lane & 3) == 0 && mc < b)
      __stcg(p_sq + (size_t)blockIdx.x * b + mc, t);
    if (blockIdx.x == 0 && lane == 0)
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (c0 + k < b) __stcg(p_row + c0 + k, x[0][k]);
  }
  grid.sync();

  T dn = T(0), en = T(0), prev_h = T(0), prev_tw = T(0);
  for (int l = 0; l < b; ++l) {
    const int i = a.row0 + l;
    // A: ||x[i:]||^2 and x_i of every column (this lane's column mc)
    const T S = grid_column_sum(p_sq, G, b, mc);
    const T H = mc < b ? __ldcg(p_row + mc) : T(0);
    if (a.pivot) {
      if (l == 0) {
        dn = sqrt(S);
        en = dn;
      } else if (live >> (lane >> 2) & 1) {
        const T t = sqrt(S);
        downdate(dn, en, prev_h - prev_tw, a.tol3z, [&]() { return t; });
      }
    }
    if ((lane & 3) == 0 && mc < b) {
      Ss[mc] = S;
      Hs[mc] = H;
    }
    // this warp's candidate: the first logical position of its largest
    // norm among the columns not yet chosen
    if (a.pivot) {
      T bv = mc < b && live >> mk & 1 ? dn : T(-2);
      int bl = mc < b && live >> mk & 1 ? lgm : INT_MAX, bp = mc;
      warp_best_all(bv, bl, bp);
      if (lane == 0) {
        bval[w] = bv;
        blog[w] = bl;
        bphys[w] = bp;
      }
    }
    __syncthreads();
    // pivot: the best of the warps' candidates, in every warp alike
    int p = l, lp = l;
    if (a.pivot) {
      T bv = lane < kPanelWarps ? bval[lane] : T(-2);
      int bl = lane < kPanelWarps ? blog[lane] : INT_MAX;
      int bp = lane < kPanelWarps ? bphys[lane] : 0;
      warp_best_all(bv, bl, bp);
      p = bp;
      lp = bl;
      // swap logical positions l and lp
      if (mc == p)
        lgm = l;
      else if (lgm == l)
        lgm = lp;
    }
    const Reflector<T> h(Ss[p], Hs[p]);
    // the owner of column p packs it (alpha at row i, v below) and shares v
    if (p >= c0 && p < c0 + kCols) {
      const int kp = p - c0;
#pragma unroll
      for (int j = 0; j < RPL; ++j) {
        const int r = rlo + lane + 32 * j;
        const T xv = pick(x[j], kp);
        const T vv = r > i ? xv / h.denom : (r == i ? T(1) : T(0));
        vs[lane + 32 * j] = vv;
        const T packed = r > i ? vv : (r == i ? h.alpha : xv);
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          if (k == kp) x[j][k] = packed;
      }
      live &= ~(1u << kp);
    }
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x == 0) a.taus[l] = h.tau;
    if (l + 1 == b) break;
    T v[RPL];
#pragma unroll
    for (int j = 0; j < RPL; ++j) v[j] = vs[lane + 32 * j];

    // B: w_c = tau v^T W[:, c] over the rows >= i
    T s[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      s[k] = T(0);
#pragma unroll
      for (int j = 0; j < RPL; ++j)
        if (rlo + lane + 32 * j >= i) s[k] += v[j] * x[j][k];
    }
    const T dot = warp_column_sums(s);
    if ((lane & 3) == 0 && mc < b)
      __stcg(p_dot + (size_t)blockIdx.x * b + mc, dot);
    grid.sync();
    const T tw = h.tau * grid_column_sum(p_dot, G, b, mc);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const T twk = __shfl_sync(0xffffffffu, tw, 4 * k);
      if (live >> k & 1) {
#pragma unroll
        for (int j = 0; j < RPL; ++j)
          if (rlo + lane + 32 * j >= i) x[j][k] -= v[j] * twk;
      }
    }
    prev_h = H;
    prev_tw = tw;

    // exchange A of step l + 1: rows > i, and row i + 1 from its owner
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      s[k] = T(0);
#pragma unroll
      for (int j = 0; j < RPL; ++j)
        if (rlo + lane + 32 * j > i) s[k] += x[j][k] * x[j][k];
    }
    const T t = warp_column_sums(s);
    if ((lane & 3) == 0 && mc < b)
      __stcg(p_sq + (size_t)blockIdx.x * b + mc, t);
    const int lr = i + 1 - rlo;
    if (lr >= 0 && lr < 32 * RPL && lane == (lr & 31))
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (c0 + k < b) __stcg(p_row + c0 + k, pick_row(x, lr >> 5, k));
    grid.sync();
  }
  // each column to its logical place
  int lgk[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    lgk[k] = __shfl_sync(0xffffffffu, lgm, 4 * k);
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = rlo + lane + 32 * j;
    if (r < m)
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (c0 + k < b) a.W[(size_t)r * b + lgk[k]] = x[j][k];
  }
  if (blockIdx.x == 0 && (lane & 3) == 0 && mc < b) a.sigma[lgm] = mc;
}

template <typename T, int RPL>
__global__ void __launch_bounds__(kPanelWarps * 32, 1)
qrcp_panel_step_kernel(PanelStepArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int sig[kPanelMaxB];
  const int b = a.b;
  if ((int)blockIdx.x < a.slabs)
    panel_steps<T, RPL>(a, grid);
  else      // a block without rows keeps step with the barriers
    for (int q = 0; q < 2 * b - 1; ++q) grid.sync();
  grid.sync();

  // rows above row0 are untouched but move with the pivots: every block
  // gathers its share, several loads in flight a thread
  for (int c = threadIdx.x; c < b; c += blockDim.x)
    sig[c] = (int)__ldcg(a.sigma + c);
  __syncthreads();
  const T* __restrict__ src = a.P;
  T* __restrict__ dst = a.W;
  const size_t total = (size_t)a.row0 * b;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  constexpr int kBurst = 8;
  for (size_t e0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       e0 < total; e0 += kBurst * stride) {
    T t[kBurst];
#pragma unroll
    for (int q = 0; q < kBurst; ++q) {
      const size_t e = e0 + q * stride;
      if (e < total) t[q] = src[e - e % b + sig[e % b]];
    }
#pragma unroll
    for (int q = 0; q < kBurst; ++q) {
      const size_t e = e0 + q * stride;
      if (e < total) dst[e] = t[q];
    }
  }
}

// ------------------------------------------------------------ launch --

struct Device {
  int sms = 0, optin = 0;
  cudaError_t err = cudaSuccess;
  Device() {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
};

// Blocks of `kernel` that fit on the card at once with `smem` bytes each
// (0 on error); sets the kernel's dynamic shared memory limit first.
template <typename K>
int co_resident(K kernel, size_t smem, const Device& dev) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int per = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads,
                                                    smem) != cudaSuccess)
    return 0;
  return per * dev.sms;
}

template <typename T>
T tol3z() {
  return (T)std::sqrt((double)std::numeric_limits<T>::epsilon());
}

// work: the wrapper's workspace, (d*n + 3*n + d + kMaxGrid) values of T
// followed by kMaxGrid ints
template <typename T>
int launch_select(const void* Y, const void* live, void* chosen, void* work,
                  int d, int n, int nsteps, int force_global, void* stream) {
  const Device dev;
  if (dev.err != cudaSuccess) return (int)dev.err;
  const size_t sz = sizeof(T);
  const size_t fixed = (size_t)(d + kThreads + 4) * sz + kThreads * sizeof(int);
  if (fixed > (size_t)dev.optin) return (int)cudaErrorInvalidValue;
  auto kernel = qrcp_select_coop_kernel<T>;
  SelectArgs<T> a;
  T* w = (T*)work;
  a.Y = (const T*)Y;
  a.live = (const T*)live;
  a.chosen = (int64_t*)chosen;
  a.gW = w;
  a.gcol = w + (size_t)d * n;
  a.xbuf = a.gcol + 3 * (size_t)n;
  a.part_val = a.xbuf + d;
  a.part_idx = (int*)(a.part_val + kMaxGrid);
  a.d = d;
  a.n = n;
  a.nsteps = nsteps;
  a.tol3z = tol3z<T>();

  // the shared slab: d padded rows of ncol columns, then dN, eN, avail
  auto slab_bytes = [&](int nc) {
    return ((size_t)d * (nc + kPad) + 3 * (size_t)nc) * sz;
  };
  int ncol = kSlab;
  while (ncol >= 16 && fixed + slab_bytes(ncol) > (size_t)dev.optin)
    ncol -= 16;
  int grid = (n + ncol - 1) / std::max(ncol, 1);
  size_t smem = fixed + slab_bytes(std::max(ncol, 0));
  a.in_smem = !force_global && ncol >= 16 && grid <= kMaxGrid &&
              grid <= co_resident(kernel, smem, dev);
  if (!a.in_smem) {
    smem = fixed;
    const int cap = std::min(co_resident(kernel, smem, dev), kMaxGrid);
    if (cap < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid = std::min(cap, (n + kSlab - 1) / kSlab);
    ncol = (n + grid - 1) / grid;
  }
  a.ncol = ncol;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(grid), dim3(kThreads), args, smem,
      (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// part: the wrapper's workspace, kMaxGrid * (2 b + 1) + b + 1 values of T
template <typename T>
int launch_panel(const void* P, void* W, void* taus, void* sigma, void* part,
                 int m, int b, int row0, int pivot, int force_global,
                 void* stream) {
  const Device dev;
  if (dev.err != cudaSuccess) return (int)dev.err;
  const size_t sz = sizeof(T);
  const size_t fixed = (size_t)(3 * b + std::max(b, kThreads) + 4) * sz +
                       (size_t)b * sizeof(int);
  if (fixed > (size_t)dev.optin) return (int)cudaErrorInvalidValue;
  auto kernel = qrcp_panel_coop_kernel<T>;
  PanelArgs<T> a;
  a.P = (const T*)P;
  a.W = (T*)W;
  a.taus = (T*)taus;
  a.sigma = (int64_t*)sigma;
  a.part = (T*)part;
  a.m = m;
  a.b = b;
  a.row0 = row0;
  a.pivot = pivot;
  a.tol3z = tol3z<T>();

  const int M = m - row0;
  const long fit = ((long)dev.optin - (long)fixed) / (long)(b * sz);
  int rows = (int)std::min((long)kPanelRows, fit);
  int grid = rows >= 1 ? (M + rows - 1) / rows : 0;
  size_t smem = fixed + (size_t)std::max(rows, 0) * b * sz;
  a.in_smem = !force_global && rows >= 1 && grid <= kMaxGrid &&
              grid <= co_resident(kernel, smem, dev);
  if (!a.in_smem) {
    smem = fixed;
    const int cap = std::min(co_resident(kernel, smem, dev), kMaxGrid);
    if (cap < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid = std::min(cap, (M + kPanelRows - 1) / kPanelRows);
    rows = (M + grid - 1) / grid;
  }
  a.rows_per = rows;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(grid), dim3(kThreads), args, smem,
      (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The step kernels' grid for a shape, or 0 where they cannot take it (too
// many columns or rows for the registers, or more blocks than fit at once)
template <typename K>
int fits(K kernel, int threads, int grid, const Device& dev) {
  int per = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, 0)
      != cudaSuccess)
    return 0;
  return grid >= 1 && grid <= per * dev.sms && grid <= kMaxGrid ? grid : 0;
}

// rows a lane holds in K6's step kernel: 256 rows a block in f32, 128 in f64
template <typename T>
constexpr int kPanelRPL = sizeof(T) == 4 ? 8 : 4;

// The blocks that hold rows of the panel (0 where the shape does not fit)
// and the whole grid: more blocks, up to what fits, where the rows above
// row0 are many, for the copy at the end (some 8 values a thread)
template <typename T>
int panel_step_grid(int m, int b, int row0, const Device& dev,
                    int* slabs = nullptr) {
  constexpr int rows = 32 * kPanelRPL<T>;
  constexpr int threads = kPanelWarps * 32;
  if (b < 1 || b > kPanelMaxB || row0 < 0 || row0 + b > m) return 0;
  const int S = fits(qrcp_panel_step_kernel<T, kPanelRPL<T>>, threads,
                     (m - row0 + rows - 1) / rows, dev);
  if (slabs) *slabs = S;
  if (S < 1) return 0;
  int per = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, qrcp_panel_step_kernel<T, kPanelRPL<T>>, threads, 0);
  const long copy = ((long)row0 * b + 8L * threads - 1) / (8L * threads);
  return (int)std::max<long>(S, std::min<long>(
      std::min(per * dev.sms, kMaxGrid), copy));
}

// part: the wrapper's workspace, (2 grid + 1) b values of T
template <typename T>
int launch_panel_step(const void* P, void* W, void* taus, void* sigma,
                      void* part, int m, int b, int row0, int pivot,
                      void* stream) {
  const Device dev;
  if (dev.err != cudaSuccess) return (int)dev.err;
  int slabs = 0;
  const int grid = panel_step_grid<T>(m, b, row0, dev, &slabs);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  PanelStepArgs<T> a;
  a.slabs = slabs;
  a.P = (const T*)P;
  a.W = (T*)W;
  a.taus = (T*)taus;
  a.sigma = (int64_t*)sigma;
  a.part = (T*)part;
  a.m = m;
  a.b = b;
  a.row0 = row0;
  a.pivot = pivot;
  a.tol3z = tol3z<T>();
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)qrcp_panel_step_kernel<T, kPanelRPL<T>>, dim3(grid),
      dim3(kPanelWarps * 32), args, 0, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// K5's step kernel for d rows (a lane holds 2, 5 or 8 of them), or null
template <typename T>
auto select_step_kernel(int d) -> void (*)(SelectStepArgs<T>) {
  if (d < 1) return nullptr;
  if (d <= 64) return qrcp_select_step_kernel<T, 2>;
  if (d <= 160) return qrcp_select_step_kernel<T, 5>;
  if (d <= 256) return qrcp_select_step_kernel<T, 8>;
  return nullptr;
}

template <typename T>
int select_step_grid(int d, int n, const Device& dev) {
  const auto kernel = select_step_kernel<T>(d);
  return kernel && n >= 1
             ? fits(kernel, kSelWarps * 32,
                    (n + kSelBlockCols - 1) / kSelBlockCols, dev)
             : 0;
}

// work: the wrapper's workspace, 16 G (d + 1) values of T then 16 G ints,
// G = ceil(n / 64)
template <typename T>
int launch_select_step(const void* Y, const void* live, void* chosen,
                       void* work, int d, int n, int nsteps, void* stream) {
  const Device dev;
  if (dev.err != cudaSuccess) return (int)dev.err;
  const int grid = select_step_grid<T>(d, n, dev);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  SelectStepArgs<T> a;
  a.Y = (const T*)Y;
  a.live = (const T*)live;
  a.chosen = (int64_t*)chosen;
  const size_t offers = 2 * (size_t)grid * kSelWarps;
  a.slot = (T*)work;
  a.part_val = a.slot + offers * d;
  a.part_idx = (int*)(a.part_val + offers);
  a.d = d;
  a.n = n;
  a.nsteps = nsteps;
  a.tol3z = tol3z<T>();
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)select_step_kernel<T>(d), dim3(grid),
      dim3(kSelWarps * 32), args, 0, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

int rl_qrcp_select_pivots_coop_f32(const void* Y, const void* live,
                                   void* chosen, void* work, int d, int n,
                                   int nsteps, int force_global,
                                   void* stream) {
  return launch_select<float>(Y, live, chosen, work, d, n, nsteps,
                              force_global, stream);
}

int rl_qrcp_select_pivots_coop_f64(const void* Y, const void* live,
                                   void* chosen, void* work, int d, int n,
                                   int nsteps, int force_global,
                                   void* stream) {
  return launch_select<double>(Y, live, chosen, work, d, n, nsteps,
                               force_global, stream);
}

int rl_qrcp_panel_coop_f32(const void* P, void* W, void* taus,
                           void* sigma, void* part, int m, int b,
                           int row0, int pivot, int force_global,
                           void* stream) {
  return launch_panel<float>(P, W, taus, sigma, part, m, b, row0, pivot,
                             force_global, stream);
}

int rl_qrcp_panel_coop_f64(const void* P, void* W, void* taus,
                           void* sigma, void* part, int m, int b,
                           int row0, int pivot, int force_global,
                           void* stream) {
  return launch_panel<double>(P, W, taus, sigma, part, m, b, row0, pivot,
                              force_global, stream);
}

int rl_qrcp_select_pivots_f32(const void* Y, const void* live, void* chosen,
                              void* work, int d, int n, int nsteps,
                              void* stream) {
  return launch_select_step<float>(Y, live, chosen, work, d, n, nsteps,
                                   stream);
}

int rl_qrcp_select_pivots_f64(const void* Y, const void* live, void* chosen,
                              void* work, int d, int n, int nsteps,
                              void* stream) {
  return launch_select_step<double>(Y, live, chosen, work, d, n, nsteps,
                                    stream);
}

int rl_qrcp_panel_f32(const void* P, void* W, void* taus, void* sigma,
                      void* part, int m, int b, int row0, int pivot,
                      void* stream) {
  return launch_panel_step<float>(P, W, taus, sigma, part, m, b, row0, pivot,
                                  stream);
}

int rl_qrcp_panel_f64(const void* P, void* W, void* taus, void* sigma,
                      void* part, int m, int b, int row0, int pivot,
                      void* stream) {
  return launch_panel_step<double>(P, W, taus, sigma, part, m, b, row0,
                                   pivot, stream);
}

// The step kernels' grid for a shape, 0 where the *_coop kernels take it
int rl_qrcp_select_pivots_grid_f32(int d, int n) {
  const Device dev;
  return dev.err == cudaSuccess ? select_step_grid<float>(d, n, dev) : 0;
}

int rl_qrcp_select_pivots_grid_f64(int d, int n) {
  const Device dev;
  return dev.err == cudaSuccess ? select_step_grid<double>(d, n, dev) : 0;
}

int rl_qrcp_panel_grid_f32(int m, int b, int row0) {
  const Device dev;
  return dev.err == cudaSuccess ? panel_step_grid<float>(m, b, row0, dev) : 0;
}

int rl_qrcp_panel_grid_f64(int m, int b, int row0) {
  const Device dev;
  return dev.err == cudaSuccess ? panel_step_grid<double>(m, b, row0, dev)
                                : 0;
}

}  // extern "C"
