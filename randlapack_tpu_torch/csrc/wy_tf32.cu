// The TF32 form ("high") of the masked WY trailing-update kernels, for
// Hopper (sm_90a). It replaces the two Pallas TPU kernels of
// randlapack_tpu/ops/pallas_wy.py in trailing mode "high" (the routing of
// pallas_wy.py:58-88, masked_vt_a_mixed / a_minus_vz_masked_mixed):
//
//   masked_vt_a        (pallas_wy.py:91)   W = V^T (A * mask)
//       V (m,b), A (m,w), mask (w,) -> W (b,w)
//   a_minus_vz_masked  (pallas_wy.py:134)  A <- A - (V Z) * mask, in place
//       A (m,w), V (m,k), Z (k,w), mask (w,)
//
// with every product one TF32 product: each operand rounded to TF32 (to
// nearest, ties away) and the sums kept in fp32, as ops/wy.py's
// masked_vt_a_tf32_reference / a_minus_vz_masked_tf32_reference compute it.
//
// What bounds them on an H100. a_minus_vz_masked: operations, 2 m k w
// flops at 495 TFLOP/s in TF32 (0.28 ms at m = w = 8192, k = 1024) against
// one read and one write of A (0.16 ms). masked_vt_a: bytes, one read of A
// (0.085 ms at m = w = 8192, b = 256), against 2 m b w flops (0.069 ms).
//
// The design rounds the small operands once a call, streams the big one
// once, and hands stages over by mbarriers:
//
// - Pre-pass (tf32_tiles_kernel). V, Z^T (a_minus_vz_masked) and V^T
//   (masked_vt_a) are rounded to TF32 once a call and written as tiles
//   ready for wgmma: 128 rows (output rows or columns) x BK = 32 of the
//   reduction per tile, K-major in unswizzled core matrices (tc.cuh's
//   layout), zeros past the edges, one 16 KB block per (row tile, stage).
//   A stage of such an operand is then one contiguous bulk copy, and
//   nothing is converted after it arrives. The wrapper allocates the tiles
//   (torch.empty); the kernels allocate nothing.
// - Roles and ring (wy_tf32_kernel). Warpgroup 0 produces (setmaxnreg.dec
//   to 40): it keeps a ring of kStages stages full, each stage handed over
//   by an mbarrier pair: full (the producer's arrivals, with the byte count
//   of its bulk copies, which complete it) and empty (one arrival from each
//   of the 8 consumer warps once its wgmma has read the stage).
//   Warpgroups 1 and 2 consume (setmaxnreg.inc to 232), 64 rows of a
//   128 x 128 output tile each: wait for full, issue the stage's four
//   wgmma.m64n128k8, wait, release the stage, fold. No block barrier and
//   no proxy fence a stage.
// - a_minus_vz_masked: both wgmma operands come from shared memory (the
//   warpgroup's 64-row half of the V tile, the Z^T tile), two 16 KB bulk
//   copies a stage issued by one thread; the rest of the producer
//   warpgroup leaves at once. A is read and written once, in the
//   epilogue: each consumer thread loads its 16 x 16 bytes of the item's A
//   tile into registers kLead stages before the item's end (streaming
//   loads), so they arrive while the tensor cores work; the stores
//   (streaming too) go out while the next item's stages are in the ring.
//   The items run in groups of kGroupK2 row tiles, so that the operand
//   tiles the 132 blocks read at once stay in L2.
// - masked_vt_a computes W^T = (A * mask)^T V. A, the 256 MB operand, is
//   the wgmma register operand: the producer warpgroup copies its raw fp32
//   stage (32 rows of the reduction x 128 columns) into a padded [k][w]
//   tile with 16-byte cp.async copies, each thread's arrival on full
//   following its copies (cp.async.mbarrier.arrive; 512-byte bulk copies,
//   one a row, are paced by the copy engine's cost per copy); each
//   consumer thread reads its fragment with ld.shared while the stage
//   before is on the tensor cores, then multiplies it by mask[w] and
//   rounds it (cvt.rna) in registers; V^T's rounded tile is the
//   shared operand, one bulk copy. So A is never rewritten into shared
//   memory, and the two column tiles of W^T (b = 256) that read the same
//   A stage are neighbouring work items, run at once, so the second read
//   is served by L2. The reduction is split into parts where the output
//   has too few tiles to fill the card (ops/wy.py's masked_vt_a_splits),
//   each part written to `part`, and tc.cuh's add_parts_kernel adds them
//   in index order: no float atomics, two launches are bit-equal. The
//   epilogue writes W from the transposed tile.
// - Accumulator restart, as in the other forms: the tensor cores add with
//   truncation, so every `chunk` stages (ops/wy.py's CHUNK) the wgmma
//   accumulator restarts from zero (scale-d 0) after it is added with FADD
//   into a second set of fp32 registers. 64 + 64 accumulator registers a
//   thread set the tile at 64 x 128 a warpgroup. The two warpgroups wait
//   for the same stages but their wgmma run one after the other on the
//   tensor cores, so one folds while the other multiplies. (Tried and
//   slower or no faster at the main shapes, so not used: two running sets,
//   a chunk's fold behind the next chunk's wgmma; masked_vt_a's stage as
//   two 64-column wgmma groups, the next stage's first half issued while
//   this stage's second half runs; a_minus_vz_masked's stores spread over
//   the next item's stages.)
// - Persistent blocks, one a multiprocessor, walk the work items (output
//   tiles; x parts for masked_vt_a); the producer runs ahead across items,
//   so an item's epilogue overlaps the next item's loads.
//
// Where the time goes at the main shapes (tools/wy_tf32_anatomy.py, which
// times copies of this kernel with the wgmma, the loads or the epilogue
// taken out): the loads and the products each take most of the kernel's
// time on their own, and a_minus_vz_masked's epilogue (A read and written
// once) adds about a fifth. A stage brings 32 KB into shared memory and
// the wgmma read 48 KB from it (a_minus_vz_masked; masked_vt_a: 32 KB,
// and 16 KB of fragment loads), about 160 bytes a clock at the tensor
// cores' TF32 rate where shared memory serves 128, so at this tile the
// products stay under ~80 % of that rate. Clusters of two blocks sharing
// the Z^T (V^T) tile by multicast, a quarter less traffic from L2, were
// no faster, and are not used.
//
// Non-finite values: the mask is multiplied, not used to skip, so a mask of
// 0 over Inf gives NaN as A * mask does; rounding keeps Inf and NaN; the
// finite/non-finite pattern of the output is the plain version's.
//
// Shapes: any m, b, k. The epilogue's 16-byte accesses and masked_vt_a's
// A copies need A (and masked_vt_a's W and parts, a_minus_vz_masked's
// mask) 16-byte aligned and w % 4 == 0; the entry points refuse anything
// else (cudaErrorInvalidValue), and the wrapper hands them zero-padded
// aligned copies, as for the other forms.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "tc.cuh"

namespace {

constexpr int kTileRows = 128;       // rows of a rounded operand tile
constexpr int BM = 128, BN = 128;    // output tile (wgmma's M x N) of a block
constexpr int kTileFloats = kTileRows * BK;   // one stage of a tile: 16 KB
constexpr int kStages = 6;
constexpr int kThreads = 384;        // producer warpgroup, two consumers
constexpr int NT = BN / 8;           // 8-column groups across the tile
constexpr int LDA = BM + 8;          // row length of masked_vt_a's raw A
                                     // stage [k][w]: a fragment load's 32
                                     // addresses on 32 banks
constexpr int kRawFloats = BK * LDA;
// a_minus_vz_masked's items in groups of this many row tiles: the 132
// items that run at once then read 16 tiles of V and ~9 of Z^T (12 MB),
// which stay in L2, where a row of items would read all of Z^T
constexpr int kGroupK2 = 16;
// a_minus_vz_masked loads an item's A tile (16-byte loads into registers)
// this many stages before the item's end, so that the epilogue finds it
constexpr int kLead = 8;

template <bool kVtA>
__host__ __device__ constexpr int stage_floats() {
  return kTileFloats + (kVtA ? kRawFloats : kTileFloats);
}

template <bool kVtA>
constexpr size_t smem_bytes() {
  return (size_t)kStages * stage_floats<kVtA>() * sizeof(float) +
         2 * kStages * sizeof(uint64_t);
}

// x rounded to TF32 as ops/wy.py's _tf32_rna: half a unit added to the
// sign-magnitude bit pattern, the low 13 bits cleared (to nearest, ties
// away; a carry into the exponent is the right power of two or Inf); NaN
// is kept as it is
__device__ __forceinline__ float tf32_round(float x) {
  if (x != x) return x;              // NaN
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// the same rounding by cvt.rna (one instruction; NaN stays NaN)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d (this warpgroup's 64 x 128) = a (64x8, shared) * b (8x128, shared) +
// (keep ? d : 0); both K-major core matrices; tf32 in, fp32 accumulate,
// asynchronous
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[64], uint64_t a,
                                              uint64_t b, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(keep));
}

// after wgmma_wait_all: the accumulator's later reads stay after the wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(d[e]) :: "memory");
}

// The pre-pass: out = the tiles of X (R x K, X(r, q) = src[r sr + q sq])
// rounded to TF32. Tile (it, s) holds rows [128 it, 128 it + 128) x
// reduction [32 s, 32 s + 32) at float offset (it S + s) 4096, its core
// matrix (r / 8, q / 4) 32 floats long at ((r / 8) 8 + q / 4) 32, entry
// (r % 8) 4 + q % 4 in it; zeros past R and K. One 16-byte output a thread,
// the threads in the order of the output.
__global__ void __launch_bounds__(256)
tf32_tiles_kernel(const float* __restrict__ src, float4* __restrict__ out,
                  int R, int K, long long sr, long long sq, int S,
                  size_t n4) {
  const size_t f = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n4) return;
  const size_t tile = f / (kTileFloats / 4);
  const int within = (int)(f % (kTileFloats / 4));
  const int r = (int)(tile / S) * kTileRows + (within / 64) * 8 + within % 8;
  const int q0 = (int)(tile % S) * BK + ((within / 8) % 8) * 4;
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = (r < R && q0 + e < K)
               ? tf32_round(src[(long long)r * sr + (long long)(q0 + e) * sq])
               : 0.f;
  out[f] = make_float4(v[0], v[1], v[2], v[3]);
}

int launch_tf32_tiles(const float* src, float* out, int R, int K,
                      long long sr, long long sq, cudaStream_t stream) {
  const int S = (K + BK - 1) / BK;
  const size_t n4 =
      (size_t)((R + kTileRows - 1) / kTileRows) * S * (kTileFloats / 4);
  if (n4 == 0) return 0;
  tf32_tiles_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      src, (float4*)out, R, K, sr, sq, S, n4);
  return (int)cudaGetLastError();
}

// Where a block is in its list of work: item `item` (a 128 x 128 output
// tile of one part of the reduction), rows m0.., columns n0.., the part's
// reduction from kbeg, nk stages long.
struct Item {
  int item, nk, m0, n0, kbeg;
};

// acc[i][j] = sum_q P(i, q) Q(q, j) over 128 x 128 tiles, TF32 products.
//   kVtA (masked_vt_a, M = w, N = b, K = m): P(i, q) = A[q][i] mask[i], A
//       raw (K x M, row length M); Q from `qt`, V^T's tiles (N rows); part
//       z of the reduction (kper long) goes to out (N x M) + z N M,
//       transposed: out[j][i].
//   else (a_minus_vz_masked, M = m, N = w, K = k): P from `pt`, V's tiles
//       (M rows); Q from `qt`, Z^T's tiles (N rows); out (M x N) <- out -
//       acc * mask[j], in place.
template <bool kVtA>
__global__ void __launch_bounds__(kThreads, 1)
wy_tf32_kernel(const float* __restrict__ pt, const float* __restrict__ qt,
               const float* __restrict__ mask, float* out, int M, int N,
               int K, int kper, int splits, int chunk) {
  constexpr int kStage = stage_floats<kVtA>();
  extern __shared__ __align__(128) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kVtA ? 129 : 1);
      mbar_init(empty + s, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int S = (K + BK - 1) / BK;          // stages of the whole reduction
  const int ntx = (N + BN - 1) / BN, mtx = (M + BM - 1) / BM;
  const int tiles = ntx * mtx;
  const int items = tiles * splits;
  // items in groups of `group` row tiles, in a group the rows fastest, so
  // the items that run at once share few operand tiles (masked_vt_a: the
  // column tiles fastest, so both column tiles of an A stage run at once)
  constexpr int group = kVtA ? 1 : kGroupK2;
  auto enter = [&](Item& c, int item) {
    c.item = item;
    const int z = item / tiles, r = item - z * tiles;
    const int grp = r / (group * ntx), rr = r - grp * group * ntx;
    const int rows = min(group, mtx - grp * group);
    c.m0 = (grp * group + rr % rows) * BM;
    c.n0 = (rr / rows) * BN;
    c.kbeg = z * kper;
    c.nk = (min(K, c.kbeg + kper) - c.kbeg + BK - 1) / BK;   // >= 1
  };

  if (tid < 128) {
    // ---- producer: warp 0 (masked_vt_a: the whole warpgroup) keeps the
    // ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (!kVtA && tid >= 32) return;
    int slot = 0;
    uint32_t parity = 1;                    // the stages start empty
    Item c;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      enter(c, item);
      for (int kt = 0; kt < c.nk; ++kt) {
        mbar_wait(empty + slot, parity);
        float* st = smem + slot * kStage;
        const size_t sg = (size_t)(c.kbeg / BK + kt);
        const float* qsrc = qt + ((size_t)(c.n0 / BN) * S + sg) * kTileFloats;
        if (tid == 0) {
          // the rounded tiles: Z^T's and V's, or V^T's
          mbar_arrive_expect(full + slot, (kVtA ? 1 : 2) * kTileFloats *
                                              (int)sizeof(float));
          bulk_load(st, qsrc, kTileFloats * (int)sizeof(float), full + slot);
          if (!kVtA)
            bulk_load(st + kTileFloats,
                      pt + ((size_t)(c.m0 / BM) * S + sg) * kTileFloats,
                      kTileFloats * (int)sizeof(float), full + slot);
        }
        if (kVtA) {
          // A's rows [k0, k0 + BK) x columns [m0, m0 + 128), 16 bytes a
          // copy, 8 a thread (bulk copies of its 512-byte rows are paced
          // by the copy engine's per-copy cost); what is past the
          // reduction or M is not copied. Each thread's arrival on full
          // follows its copies.
          const int k0 = c.kbeg + kt * BK;
          const int kend = min(K, c.kbeg + kper);
#pragma unroll
          for (int i = 0; i < BK * BM / 4 / 128; ++i) {
            const int e = tid + i * 128;
            const int r = e / (BM / 4), c4 = (e % (BM / 4)) * 4;
            if (k0 + r < kend && c.m0 + c4 < M)
              cp_async16(st + kTileFloats + r * LDA + c4,
                         pt + (size_t)(k0 + r) * M + c.m0 + c4, 16);
          }
          cp_async_arrive_noinc(full + slot);
        }
        if (++slot == kStages) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2, 64 rows of the tile each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = lane >> 2, t = lane & 3;
  const int wg = (tid - 128) >> 7;
  const int wm = wg * 64 + ((tid >> 5) & 3) * 16;   // this warp's rows

  // a thread's share of its warpgroup's 64 x 128 accumulator: for the
  // 8-column group c, rows g and g+8 of its warp, columns 8c+2t and
  // 8c+2t+1, as [4c] (g, 2t), [4c+1] (g, 2t+1), [4c+2] (g+8, 2t), [4c+3]
  // (g+8, 2t+1)
  float acc[4 * NT];        // sums of whole chunks, added with FADD
  float part[4 * NT];       // the running chunk, added to by the wgmma
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e) acc[e] = part[e] = 0.f;
  int since = 0;            // stages in the running chunk
  int slot = 0;
  uint32_t parity = 0;
  Item c;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    enter(c, item);
    // masked_vt_a: the mask of this thread's two fragment rows (w), 0 and
    // invalid past M
    float mk[2] = {0.f, 0.f};
    bool rv[2] = {false, false};
    if (kVtA) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = c.m0 + wm + g + 8 * h;
        rv[h] = i < M;
        if (rv[h]) mk[h] = mask[i];
      }
    }
    // a_minus_vz_masked's epilogue: lane pairs (t, t^1) trade halves of
    // each 8-column group, so that the even lane holds row g, the odd lane
    // row g+8, each 4 consecutive columns (N % 4 == 0: all four or none).
    // Their A values are loaded kLead stages before the item's end, while
    // the tensor cores still work.
    const bool odd = t & 1;
    const int ei = c.m0 + wm + g + (odd ? 8 : 0);
    const int ej = c.n0 + (t & ~1) * 2;
    float* erow = out + (size_t)ei * N + ej;
    float4 ax[NT];
    // masked_vt_a: a stage's raw A fragments, [q][e]: row g + 8(e&1), k
    // 8q + t + 4(e>>1), read while the stage before is on the tensor cores
    float araw[BK / 8][4];
    auto load_raw = [&](const float* st) {
      const float* sa = st + kTileFloats;
#pragma unroll
      for (int q = 0; q < BK / 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          araw[q][e] = sa[(q * 8 + t + (e >> 1) * 4) * LDA + wm + g +
                          (e & 1) * 8];
    };
    for (int kt = 0; kt < c.nk; ++kt) {
      if (!kVtA && kt == max(0, c.nk - kLead)) {
#pragma unroll
        for (int cc = 0; cc < NT; ++cc)
          if (ei < M && ej + cc * 8 < N)
            ax[cc] = __ldcs(reinterpret_cast<const float4*>(erow + cc * 8));
      }
      if (!kVtA || kt == 0) mbar_wait(full + slot, parity);
      const float* st = smem + slot * kStage;
      uint32_t ah[BK / 8][4];
      if (kVtA) {
        // the A fragments, masked and rounded to TF32; rows past M and the
        // reduction's end (stale shared memory) are 0
        if (kt == 0) load_raw(st);
        const int kv = min(K, c.kbeg + kper) - (c.kbeg + kt * BK);
#pragma unroll
        for (int q = 0; q < BK / 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ah[q][e] = (q * 8 + t + (e >> 1) * 4 < kv && rv[e & 1])
                           ? tf32_rna(araw[q][e] * mk[e & 1])
                           : 0u;
      }
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < BK / 8; ++q) {
        // 8 of k are two core matrices; a chunk's first product starts
        // the accumulator from zero
        const uint64_t db = b_descriptor(st + 2 * q * kCoreFloats);
        if constexpr (kVtA) {
          wgmma_tf32(part, ah[q], db, q > 0 || since > 0);
        } else {
          const uint64_t da = b_descriptor(
              st + kTileFloats + wg * (BM / 2) * BK + 2 * q * kCoreFloats);
          wgmma_tf32_ss(part, da, db, q > 0 || since > 0);
        }
      }
      wgmma_commit();
      if (kVtA && kt + 1 < c.nk) {
        // while the tensor cores run: the next stage's raw fragments
        const int next = slot + 1 == kStages ? 0 : slot + 1;
        mbar_wait(full + next, next == 0 ? parity ^ 1 : parity);
        load_raw(smem + next * kStage);
      }
      wgmma_wait_all();
      fence_acc(part);
      if constexpr (kVtA) release_frag(ah, ah);
      if (lane == 0) mbar_arrive(empty + slot);
      if (++slot == kStages) {
        slot = 0;
        parity ^= 1;
      }
      const bool last = kt == c.nk - 1;
      if (++since == chunk || last) {
        since = 0;
#pragma unroll
        for (int e = 0; e < 4 * NT; ++e) acc[e] += part[e];
      }
    }

    if constexpr (kVtA) {
      // W (or its part) from the transposed tile: out[j][i]; the 8 lanes g
      // of one t store 8 consecutive i of a row of W
      float* dst = out + (size_t)(c.kbeg / kper) * M * N;
#pragma unroll
      for (int cc = 0; cc < NT; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = c.m0 + wm + g + (e >> 1) * 8;
          const int j = c.n0 + cc * 8 + 2 * t + (e & 1);
          if (i < M && j < N) dst[(size_t)j * M + i] = acc[4 * cc + e];
        }
    } else {
#pragma unroll
      for (int cc = 0; cc < NT; ++cc) {
        float* v = acc + 4 * cc;
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
#pragma unroll
      for (int cc = 0; cc < NT; ++cc)
        if (ei < M && ej + cc * 8 < N) {
          const float4 mj =
              *reinterpret_cast<const float4*>(mask + ej + cc * 8);
          __stcs(reinterpret_cast<float4*>(erow + cc * 8),
                 make_float4(ax[cc].x - acc[4 * cc] * mj.x,
                             ax[cc].y - acc[4 * cc + 1] * mj.y,
                             ax[cc].z - acc[4 * cc + 2] * mj.z,
                             ax[cc].w - acc[4 * cc + 3] * mj.w));
        }
    }
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) acc[e] = 0.f;
  }
}

template <bool kVtA>
int launch_wy_tf32(const float* pt, const float* qt, const float* mask,
                   float* out, int M, int N, int K, int kper, int splits,
                   int chunk, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wy_tf32_kernel<kVtA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<kVtA>());
  if (err != cudaSuccess) return (int)err;
  const long long items =
      (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM) * splits;
  if (items >= INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  wy_tf32_kernel<kVtA><<<grid, kThreads, smem_bytes<kVtA>(), stream>>>(
      pt, qt, mask, out, M, N, K, kper, splits,
      chunk > 0 ? chunk : INT32_MAX);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The pre-pass alone: `out` (the tiles of ceil(R/128) x ceil(K/32) stages,
// 4096 floats each, 16-byte aligned) = X rounded to TF32, X(r, q) =
// src[r sr + q sq] (strides in floats). Refuses a misaligned `out`.
int rl_tf32_tiles_f32(const void* src, void* out, int R, int K,
                      long long sr, long long sq, void* stream) {
  if (!aligned16(out) || R < 0 || K < 0) return (int)cudaErrorInvalidValue;
  return launch_tf32_tiles((const float*)src, (float*)out, R, K, sr, sq,
                           (cudaStream_t)stream);
}

// W = V^T (A * mask), one TF32 product: V^T rounded into `vt` (the tiles
// of b rows x m, as rl_tf32_tiles_f32), then the ring kernel. `splits` > 1
// splits the reduction into that many parts, written to `part` (splits, b,
// w) and added in index order; `chunk` is the number of 32-deep stages the
// wgmma accumulator runs before it is folded with FADD (0: never). A, W,
// `vt` and (with splits > 1) `part` must be 16-byte aligned and w % 4 == 0
// (else cudaErrorInvalidValue).
int rl_masked_vt_a_tf32_f32(const void* V, const void* A, const void* mask,
                            void* W, void* part, void* vt, int m, int b,
                            int w, int splits, int chunk, void* stream) {
  if (w % 4 || splits < 1 || splits > 65535 || !aligned16(A) ||
      !aligned16(W) || !aligned16(vt) || (splits > 1 && !aligned16(part)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_tf32_tiles((const float*)V, (float*)vt, b, m, 1, b, s);
  if (err != 0) return err;
  // each part a whole number of stages, and none of them empty
  const int kper = ((m + splits - 1) / splits + BK - 1) / BK * BK;
  splits = (m + kper - 1) / kper;
  err = launch_wy_tf32<true>((const float*)A, (const float*)vt,
                             (const float*)mask,
                             (float*)(splits > 1 ? part : W), w, b, m, kper,
                             splits, chunk, s);
  if (err != 0 || splits == 1) return err;
  const size_t n4 = (size_t)b * w / 4;
  add_parts_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      (const float4*)part, (float4*)W, n4, splits);
  return (int)cudaGetLastError();
}

// A <- A - (V Z) * mask in place, one TF32 product: V and Z^T rounded into
// `vr` (m rows x k) and `zt` (w rows x k), then the ring kernel (`chunk` as
// above). A, mask, `vr` and `zt` must be 16-byte aligned and w % 4 == 0
// (else cudaErrorInvalidValue).
int rl_a_minus_vz_masked_tf32_f32(void* A, const void* V, const void* Z,
                                  const void* mask, void* vr, void* zt,
                                  int m, int k, int w, int chunk,
                                  void* stream) {
  if (w % 4 || !aligned16(A) || !aligned16(mask) || !aligned16(vr) ||
      !aligned16(zt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_tf32_tiles((const float*)V, (float*)vr, m, k, k, 1, s);
  if (err == 0)
    err = launch_tf32_tiles((const float*)Z, (float*)zt, w, k, 1, w, s);
  if (err != 0) return err;
  return launch_wy_tf32<false>((const float*)vr, (const float*)zt,
                               (const float*)mask, (float*)A, m, w, k, k, 1,
                               chunk, s);
}

}  // extern "C"
