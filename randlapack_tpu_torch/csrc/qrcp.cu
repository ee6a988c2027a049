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
// one SM cannot hold: at the main-path shapes the f32 sketch is
// 138 x 8192 x 4 B = 4.5 MB and the f32 panel 8192 x 128 x 4 B = 4 MB,
// against 227 KB of shared memory per block (3.6 MB for a 16-block
// cluster). So each is ONE persistent cooperative kernel: the array is cut
// into slabs (K5: ranges of columns; K6: ranges of rows >= row0), every
// block keeps its slab in dynamic shared memory across all steps, and the
// steps are separated by grid-wide barriers (cooperative_groups
// grid.sync()). Device memory sees only the per-step partials. Where the
// slabs do not fit on the co-resident blocks, the same code runs with the
// slab in device memory (the kernel's output or workspace) instead.
//
// Every block reduces the per-step partials in the same fixed order with
// the same instructions, so the pivot, the reflector and the downdated
// norms are bit-identical in all blocks and no block has to broadcast
// them. Pivot ties resolve as torch.argmax does: NaN first, then the
// larger value, then the lower index; unavailable columns score -1.
//
// What bounds them on an H100: the latency of each step's chain of
// dependent phases, not flops or bytes. K5 does about 4 (d - l) flops per
// available column and step (~0.3 GFLOP per call at 138 x 8192 x 128
// steps, ~4 us at the 67 TFLOP/s fp32 peak), K6 about 4 (m - row0) b^2 / 2
// (~0.27 GFLOP at 8192 x 128), against 2 (K5) or 3 (K6) grid barriers,
// the partials' L2 round trips and the block's own loops per step, 128
// steps a call. Measured on the card, a block's loop over its slab cost
// more than the barriers' cross-block part, so the slabs are small (K5:
// 64 columns a block, each column's rows split over 4 lanes; K6: 64 rows
// a block; ~128 blocks at the main shapes) and the cross-block reductions
// are spread over a warp's lanes. Fewer barriers per step (a look-ahead
// pivot, or reusing K6's trailing-norm reduction as the next column norm)
// are later work.

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

// ---------------------------------------------------------------- K5 --

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
qrcp_select_kernel(SelectArgs<T> a) {
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

// ---------------------------------------------------------------- K6 --

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
qrcp_panel_kernel(PanelArgs<T> a) {
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
  auto kernel = qrcp_select_kernel<T>;
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
  auto kernel = qrcp_panel_kernel<T>;
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

}  // namespace

extern "C" {

int rl_qrcp_select_pivots_f32(const void* Y, const void* live, void* chosen,
                              void* work, int d, int n, int nsteps,
                              int force_global, void* stream) {
  return launch_select<float>(Y, live, chosen, work, d, n, nsteps,
                              force_global, stream);
}

int rl_qrcp_select_pivots_f64(const void* Y, const void* live, void* chosen,
                              void* work, int d, int n, int nsteps,
                              int force_global, void* stream) {
  return launch_select<double>(Y, live, chosen, work, d, n, nsteps,
                               force_global, stream);
}

int rl_qrcp_panel_f32(const void* P, void* W, void* taus, void* sigma,
                      void* part, int m, int b, int row0, int pivot,
                      int force_global, void* stream) {
  return launch_panel<float>(P, W, taus, sigma, part, m, b, row0, pivot,
                             force_global, stream);
}

int rl_qrcp_panel_f64(const void* P, void* W, void* taus, void* sigma,
                      void* part, int m, int b, int row0, int pivot,
                      int force_global, void* stream) {
  return launch_panel<double>(P, W, taus, sigma, part, m, b, row0, pivot,
                              force_global, stream);
}

}  // extern "C"
