// The ring forms of the masked WY trailing-update kernels, for Hopper
// (sm_90a): the TF32 form ("high") and the bf16 forms ("default",
// "bf16_3x_emul") of both kernels. They replace the two Pallas TPU kernels
// of randlapack_tpu/ops/pallas_wy.py in those trailing modes (the routing
// of pallas_wy.py:58-88, masked_vt_a_mixed / a_minus_vz_masked_mixed):
//
//   masked_vt_a        (pallas_wy.py:91)   W = V^T (A * mask)
//       V (m,b), A (m,w), mask (w,) -> W (b,w)
//   a_minus_vz_masked  (pallas_wy.py:134)  A <- A - (V Z) * mask, in place
//       A (m,w), V (m,k), Z (k,w), mask (w,)
//
// The forms (the kernel's kForm), as ops/wy.py's plain versions compute
// them:
//   kFormTf32    one TF32 product: each operand rounded to TF32 (to
//                nearest, ties away), fp32 sums (*_tf32_reference);
//   kFormBf16    one bf16 product: each operand rounded to bf16 (to nearest
//                even), fp32 sums (a_minus_vz_masked_bf16_reference);
//   kFormBf16x3  three bf16 products of the halves hi = bf16(x) and
//                lo = bf16(x - hi), lo*hi + hi*lo + hi*hi with lo*lo
//                dropped, fp32 sums (the JAX package's bf16_3x_matmul,
//                pallas_wy.py:37; a_minus_vz_masked_bf16x3_reference).
//
// What bounds them on an H100. a_minus_vz_masked at m = w = 8192, k = 1024:
// operations, 2 m k w flops, 0.28 ms in TF32 at 495 TFLOP/s, 0.14 ms in
// bf16 at 989 and 0.42 ms for three bf16 products, against one read and
// one write of A (0.16 ms; bf16 is bound by these bytes). masked_vt_a at
// m = w = 8192, b = 256: one read of A (0.085 ms) against 2 m b w flops
// (0.069 ms in TF32, 0.035 ms in bf16: bound by the bytes), or 0.104 ms
// for three bf16 products (bound by the operations).
//
// The design rounds the small operands once a call, streams the big one
// once, and hands stages over by mbarriers:
//
// - Pre-pass (tf32_tiles_kernel, bf16_tiles_kernel). V, Z^T
//   (a_minus_vz_masked) and V^T (masked_vt_a) are rounded once a call and
//   written as tiles ready for wgmma: 128 rows (output rows or columns) x
//   BK = 32 of the reduction per tile, zeros past the edges, one block per
//   (row tile, stage): 16 KB of TF32; 8 KB of bf16, or 16 KB holding the
//   hi tile and then the lo tile for bf16x3. A stage of such an operand is
//   then one contiguous bulk copy, and nothing is converted after it
//   arrives. Both operands are K-major, in unswizzled core matrices of 8
//   rows x 16 bytes of the reduction (tc.cuh's layout; 4 TF32 or 8 bf16
//   values of k). 16-bit wgmma could also read an MN-major tile through
//   its transpose bits, but the ring moves a whole block per stage either
//   way, so the layout costs the ring nothing; K-major lets one pre-pass
//   layout, one descriptor and the TF32 form's addressing serve V and Z^T
//   in every form. The wrapper allocates the tiles (torch.empty); the
//   kernels allocate nothing. bf16 is rounded in integer arithmetic, a NaN
//   written as 0x7FC0, so the tiles are bit for bit ops/wy.py's
//   bf16_tiles_reference on either device.
// - Roles and ring (wy_ring_kernel). Warpgroup 0 produces (setmaxnreg.dec
//   to 40; masked_vt_a's bf16 forms: warpgroups 0 and 1): it keeps a ring
//   of stages full, each stage handed over by an mbarrier pair: full (the
//   producer's arrivals, with the byte count of its bulk copies, which
//   complete it) and empty (one arrival from each of the 8 consumer warps
//   once its wgmma has read the stage). The ring holds 6 stages of 32 KB
//   (TF32, bf16x3) or 12 of 16 KB (bf16); masked_vt_a's bf16 forms keep 8
//   of 16 KB or 4 of 32 KB beside their raw A ring (10 or 5 in a pair).
//   The last two warpgroups consume (setmaxnreg.inc to 232; 216 beside two
//   producer warpgroups), 64 rows of a 128 x 128 output tile each: wait
//   for full, issue the stage's wgmma, wait, release the stage, fold. No
//   block barrier a stage but among masked_vt_a's bf16 producers, and no
//   proxy fence but theirs (below).
// - a_minus_vz_masked: both wgmma operands come from shared memory (the
//   warpgroup's 64-row half of the V tile, the Z^T tile), two bulk copies
//   a stage issued by one thread; the rest of the producer warpgroup
//   leaves at once. A stage is four wgmma.m64n128k8 (TF32), two
//   wgmma.m64n128k16 (bf16) or six (bf16x3: lo*hi, hi*lo, hi*hi for each
//   16 of k, as csrc/wy.cu orders them). A is read and written once, in
//   the epilogue: each consumer thread loads its 16 x 16 bytes of the
//   item's A tile into registers kLead stages before the item's end
//   (streaming loads), so they arrive while the tensor cores work; the
//   stores (streaming too) go out while the next item's stages are in the
//   ring. The items run in groups of kGroupK2 row tiles, so that the
//   operand tiles the 132 blocks read at once stay in L2.
// - masked_vt_a computes W^T = (A * mask)^T V, V^T's rounded tile the
//   shared operand, one bulk copy a stage. In the TF32 form A, the 256 MB
//   operand, is the wgmma register operand: the producer warpgroup copies
//   its raw fp32 stage (32 rows of the reduction x 128 columns) into a
//   padded [k][w] tile with 16-byte cp.async copies, each thread's arrival
//   on full following its copies (cp.async.mbarrier.arrive; 512-byte bulk
//   copies, one a row, are paced by the copy engine's cost per copy); each
//   consumer thread reads its fragment with ld.shared while the stage
//   before is on the tensor cores, then multiplies it by mask[w] and
//   rounds it (cvt.rna) in registers, so A is never rewritten into shared
//   memory; the two column tiles of W^T (b = 256) that read the same A
//   stage are neighbouring work items, run at once, so the second read is
//   served by L2. In the bf16 forms two producer warpgroups round A
//   instead, so that the consumers' chain a stage is only wait, issue,
//   wait, fold, as in a_minus_vz_masked: each producer warp copies 8 rows
//   x 32 or 64 columns of the raw stage into the block's raw ring (4
//   stages; 16-byte cp.async, zero-filled past the edges, 3 stages ahead),
//   multiplies them by the mask, rounds them (bf16x3: splits them) and
//   writes them into the stage's K-major A tile set(s), the pre-pass's
//   layout; after each producer's fence for the tensor cores
//   (fence.proxy.async) and a barrier among them, one thread arrives on
//   full. At b in (128, 256] the two column tiles of W^T run on the two
//   blocks of a cluster (kPair): each block copies and rounds half of the
//   tile's 128 columns and bulk-copies its half of the rounded tile set(s)
//   to the same place in the other block, whose full barrier counts the
//   bytes; the empty barriers count the consumer warps of both blocks (the
//   protocol of csrc/gaussian_sketch.cu). A block so reads a quarter less
//   from L2 a stage and rounds half as much. A stage is then
//   a_minus_vz_masked's two (six) wgmma.m64n128k16 with the A tile in V's
//   place. With no A tile to hold for an epilogue, a consumer has room for
//   two sets of running sums (3 x 64 registers): at wy.CHUNK = 1 the
//   stages fill them in turn and a stage's products are issued before the
//   previous stage's are waited for (wgmma.wait_group 1), so a fold runs
//   while the tensor cores work (other chunks use one set; the products of
//   a chunk stay in flight until its last stage). In every form A is read
//   once from device memory. The reduction is split into parts where the
//   output has too few tiles to fill the card (ops/wy.py's
//   masked_vt_a_splits), each part written to `part`, and tc.cuh's
//   add_parts_kernel adds them in index order: no float atomics, two
//   launches are bit-equal. The epilogue writes W from the transposed
//   tile.
// - Accumulator restart, in every form: the tensor cores add with
//   truncation, so every `chunk` stages (ops/wy.py's CHUNK) the wgmma
//   accumulator restarts from zero (scale-d 0) after it is added with FADD
//   into a second set of fp32 registers. The two sets, 64 + 64 registers a
//   thread, set the tile at 64 x 128 a warpgroup (a 64 x 256 tile would
//   want 256 accumulator registers a thread, past the 232 a consumer has)
//   and so at 128 x 128 a block; the bf16 forms keep the TF32 form's tile.
//   The two warpgroups wait for the same stages but their wgmma run one
//   after the other on the tensor cores, so one folds while the other
//   multiplies. (Tried and slower or no faster at the main shapes, so not
//   used: two running sets, a chunk's fold behind the next chunk's wgmma,
//   in the TF32 form and again in all a_minus_vz_masked forms with the A
//   tile staged in shared memory to free the registers (ptxas spills in
//   the consumers, which there also hold the epilogue's A values; the
//   bf16 forms of masked_vt_a hold none and use two sets); masked_vt_a's
//   stage as two 64-column wgmma groups, the
//   next stage's first half issued while this stage's second half runs;
//   a_minus_vz_masked's stores spread over the next item's stages.)
// - Persistent blocks, one a multiprocessor, walk the work items (output
//   tiles; x parts for masked_vt_a); the producer runs ahead across items,
//   so an item's epilogue overlaps the next item's loads.
//
// Where the time goes at the main shapes (tools/wy_ring_anatomy.py, which
// times copies of this kernel with the wgmma, the loads or the epilogue
// taken out): in the TF32 form the loads and the products each take most
// of the kernel's time on their own, and a_minus_vz_masked's epilogue (A
// read and written once) adds about a fifth. A TF32 stage brings 32 KB
// into shared memory and the wgmma read 48 KB from it (a_minus_vz_masked;
// masked_vt_a: 32 KB, and 16 KB of fragment loads), about 160 bytes a
// clock at the tensor cores' TF32 rate where shared memory serves 128, so
// at this tile the products stay under ~80 % of that rate. Clusters of two
// blocks sharing the Z^T (V^T) tile by multicast, a quarter less traffic
// from L2, were no faster, and are not used. A bf16 stage brings half the
// bytes of a TF32 one for half the tensor-core time, a bf16x3 stage the
// same bytes for one and a half times it; in both bf16 forms the loads
// matter little (left out, the kernel is hardly faster): each consumer
// warpgroup's chain a stage (wait for the stage, issue, wait for the
// products, fold) sets the pace, and the epilogue adds about a fifth.
//
// Non-finite values: the mask is multiplied, not used to skip, so a mask of
// 0 over Inf gives NaN as A * mask does; rounding keeps Inf and NaN (a bf16
// lo half of Inf is NaN, as in the plain version); the finite/non-finite
// pattern of the output is the plain version's.
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

// the forms of the ring kernel (its kForm)
constexpr int kFormTf32 = 0, kFormBf16 = 1, kFormBf16x3 = 2;

constexpr int kTileRows = 128;       // rows of a rounded operand tile
constexpr int BM = 128, BN = 128;    // output tile (wgmma's M x N) of a block
constexpr int kTileFloats = kTileRows * BK;   // one stage of a tile: 16 KB
                                              // of TF32, 8 KB of bf16
constexpr int NT = BN / 8;           // 8-column groups across the tile
constexpr int LDA = BM + 8;          // row length of masked_vt_a's raw A
                                     // stage [k][w]: a fragment load's 32
                                     // addresses on 32 banks
constexpr int kRawFloats = BK * LDA;
// a_minus_vz_masked's items in groups of this many row tiles: the 132
// items that run at once then read 16 tiles of V and ~9 of Z^T (12 MB of
// TF32), which stay in L2, where a row of items would read all of Z^T
constexpr int kGroupK2 = 16;
// a_minus_vz_masked loads an item's A tile (16-byte loads into registers)
// this many stages before the item's end, so that the epilogue finds it
constexpr int kLead = 8;
// a bf16 tile's core matrices: 8 rows x 8 values of k (128 bytes), BK / 8
// of them along k (the stride to the next 8 rows)
constexpr int kCoreNBf16 = (BK / 8) * kCoreFloats * 4;
// masked_vt_a's bf16 forms: the producer's ring of raw A stages (32 rows of
// the reduction x the block's columns: 128, or 64 in a pair), filled this
// many stages ahead of the rounding, less one
constexpr int kRawStages = 4;

// bytes of one operand's (row tile, stage) block: every tile set of it
template <int kForm>
__host__ __device__ constexpr int op_bytes() {
  return kForm == kFormTf32 ? kTileFloats * 4
                            : kTileFloats * 2 * (kForm == kFormBf16x3 ? 2 : 1);
}

// masked_vt_a's bf16 forms round A in the producer warpgroups
template <bool kVtA, int kForm>
__host__ __device__ constexpr bool rounds_a() {
  return kVtA && kForm != kFormTf32;
}

// producer threads (one warpgroup; masked_vt_a's bf16 forms two), then two
// consumer warpgroups
template <bool kVtA, int kForm>
__host__ __device__ constexpr int producer_threads() {
  return rounds_a<kVtA, kForm>() ? 256 : 128;
}

// a stage of the ring: the rounded tile set(s) of Z^T (V^T), then those of
// V (the rounded A), or masked_vt_a TF32's raw A stage
template <bool kVtA, int kForm>
__host__ __device__ constexpr int stage_bytes() {
  return op_bytes<kForm>() +
         (kVtA && kForm == kFormTf32 ? kRawFloats * 4 : op_bytes<kForm>());
}

// columns of A a block of masked_vt_a's bf16 forms copies and rounds: all
// 128 of its tile, or its half in a pair (kPair)
template <bool kPair>
__host__ __device__ constexpr int round_cols() {
  return kPair ? BM / 2 : BM;
}

template <bool kVtA, int kForm, bool kPair>
__host__ __device__ constexpr int raw_bytes() {
  return rounds_a<kVtA, kForm>() ? kRawStages * BK * round_cols<kPair>() * 4
                                 : 0;
}

// stages of the ring: ~192 KB of shared memory in every form, the raw A
// ring of masked_vt_a's bf16 forms (64 KB, 32 KB in a pair) included
template <bool kVtA, int kForm, bool kPair>
__host__ __device__ constexpr int ring_stages() {
  return kForm == kFormTf32
             ? 6
             : (192 * 1024 - raw_bytes<kVtA, kForm, kPair>()) /
                   stage_bytes<kVtA, kForm>();
}

template <bool kVtA, int kForm, bool kPair>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)ring_stages<kVtA, kForm, kPair>() *
             stage_bytes<kVtA, kForm>() +
         raw_bytes<kVtA, kForm, kPair>() +
         2 * ring_stages<kVtA, kForm, kPair>() * sizeof(uint64_t);
}

// barrier `id` among the first n threads of the block
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
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

// x rounded to bf16, to nearest even, as its 16 bits (ops/wy.py's
// _bf16_bits): the carry of the rounding added to the sign-magnitude bit
// pattern (a carry into the exponent is the right power of two or Inf),
// a NaN written as 0x7FC0
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  if (x != x) return 0x7FC0u;
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

// wgmma's descriptor of a K-major, unswizzled operand at `p`: core
// matrices kCoreK bytes apart along k and `sbo` bytes apart along the
// rows, in units of 16 bytes
__device__ __forceinline__ uint64_t kmajor_descriptor(const void* p,
                                                      int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)(kCoreK >> 4) << 16 | (uint64_t)(sbo >> 4) << 32;
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

// the same for bf16: a (64x16, shared) * b (16x128, shared), both K-major
// (transpose bits 0)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[64], uint64_t a,
                                              uint64_t b, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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

// One 32-deep stage `st` of the bf16 forms on the tensor cores: d (this
// warpgroup's 64 x 128) += P Q^T over the stage, Q the stage's first block
// of tile sets (Z^T's, or V^T's), P this warpgroup's 64 rows of the second
// (V's, or the rounded A's); `keep` 0 starts d from zero. 16 of k are two
// core matrices of each tile set; bf16x3's lo sets lie 8 KB after the hi
// sets, and its products run lo*hi, hi*lo, hi*hi for each 16 of k, as
// csrc/wy.cu orders them.
template <int kForm>
__device__ __forceinline__ void bf16_stage_mma(float (&d)[64],
                                               const char* st, int wg,
                                               int keep) {
  constexpr int kLo = kTileFloats * 2;
  const char* ps = st + op_bytes<kForm>() + wg * (BM / 2) * BK * 2;
#pragma unroll
  for (int q = 0; q < BK / 16; ++q) {
    const int k = q > 0 || keep;
    const int off = 2 * q * kCoreFloats * 4;
    const uint64_t dq = kmajor_descriptor(st + off, kCoreNBf16);
    const uint64_t dp = kmajor_descriptor(ps + off, kCoreNBf16);
    if constexpr (kForm == kFormBf16x3) {
      wgmma_bf16_ss(d, kmajor_descriptor(ps + kLo + off, kCoreNBf16), dq, k);
      wgmma_bf16_ss(d, dp, kmajor_descriptor(st + kLo + off, kCoreNBf16), 1);
      wgmma_bf16_ss(d, dp, dq, 1);
    } else {
      wgmma_bf16_ss(d, dp, dq, k);
    }
  }
}

// masked_vt_a's epilogue: W (or part z of it, at out + z M N) from the
// transposed tile, out[j][i], for the 64 x 128 tile of a warpgroup at
// rows m0 + wm.. (i) and columns n0.. (j); the 8 lanes g of one t store 8
// consecutive i of a row of W
__device__ __forceinline__ void store_transposed(const float (&acc)[64],
                                                 float* dst, int M, int N,
                                                 int i0, int n0, int g,
                                                 int t) {
#pragma unroll
  for (int cc = 0; cc < NT; ++cc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + (e >> 1) * 8;
      const int j = n0 + cc * 8 + 2 * t + (e & 1);
      if (i < M && j < N) dst[(size_t)j * M + i] = acc[4 * cc + e];
    }
}

// The TF32 pre-pass: out = the tiles of X (R x K, X(r, q) = src[r sr + q
// sq]) rounded to TF32. Tile (it, s) holds rows [128 it, 128 it + 128) x
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

// The bf16 pre-pass: the same tiles of X rounded to bf16 (bf16_bits), and
// with kSplit also the tiles of the lo halves bf16(x - hi), the lo tile of
// each (row tile, stage) right after its hi tile. A tile of one set holds
// 4096 bf16 values: its core matrix (r / 8, q / 8) 64 values long at
// ((r / 8) 4 + q / 8) 64, entry (r % 8) 8 + q % 8 in it; zeros past R and
// K. One 16-byte output of each set a thread, the threads in the order of
// the output.
template <bool kSplit>
__global__ void __launch_bounds__(256)
bf16_tiles_kernel(const float* __restrict__ src, uint4* __restrict__ out,
                  int R, int K, long long sr, long long sq, int S,
                  size_t n8) {
  constexpr int kRows16 = kTileFloats / 8;     // 16-byte rows of a tile set
  const size_t f = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n8) return;
  const size_t tile = f / kRows16;
  const int within = (int)(f % kRows16);
  const int r = (int)(tile / S) * kTileRows + (within / 32) * 8 + within % 8;
  const int q0 = (int)(tile % S) * BK + ((within / 8) % 4) * 8;
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t hb[2], lb[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = q0 + 2 * e + j;
      const float x =
          (r < R && q < K) ? src[(long long)r * sr + (long long)q * sq] : 0.f;
      hb[j] = bf16_bits(x);
      lb[j] = kSplit ? bf16_bits(x - __uint_as_float(hb[j] << 16)) : 0u;
    }
    h[e] = hb[0] | hb[1] << 16;        // the lower k in the low half
    l[e] = lb[0] | lb[1] << 16;
  }
  uint4* dst = out + tile * (kSplit ? 2 : 1) * kRows16 + within;
  dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
  if (kSplit) dst[kRows16] = make_uint4(l[0], l[1], l[2], l[3]);
}

int launch_bf16_tiles(const float* src, void* out, int R, int K,
                      long long sr, long long sq, bool split,
                      cudaStream_t stream) {
  const int S = (K + BK - 1) / BK;
  const size_t n8 =
      (size_t)((R + kTileRows - 1) / kTileRows) * S * (kTileFloats / 8);
  if (n8 == 0) return 0;
  const unsigned grid = (unsigned)((n8 + 255) / 256);
  if (split)
    bf16_tiles_kernel<true><<<grid, 256, 0, stream>>>(
        src, (uint4*)out, R, K, sr, sq, S, n8);
  else
    bf16_tiles_kernel<false><<<grid, 256, 0, stream>>>(
        src, (uint4*)out, R, K, sr, sq, S, n8);
  return (int)cudaGetLastError();
}

// Where a block is in its list of work: item `item` (a 128 x 128 output
// tile of one part of the reduction), rows m0.., columns n0.., the part's
// reduction from kbeg, nk stages long.
struct Item {
  int item, nk, m0, n0, kbeg;
};

// acc[i][j] = sum_q P(i, q) Q(q, j) over 128 x 128 tiles, in the form kForm.
//   kVtA (masked_vt_a; M = w, N = b, K = m): P(i, q) = A[q][i] mask[i], A
//       raw (K x M, row length M); Q from `qt`, V^T's tiles (N rows); part
//       z of the reduction (kper long) goes to out (N x M) + z N M,
//       transposed: out[j][i].
//   else (a_minus_vz_masked, M = m, N = w, K = k): P from `pt`, V's tiles
//       (M rows); Q from `qt`, Z^T's tiles (N rows); out (M x N) <- out -
//       acc * mask[j], in place.
//   kPair (masked_vt_a's bf16 forms with N = 256, clusters of 2): the
//       blocks of a cluster take the two column tiles of the same rows of
//       W^T and share the rounded A tile, each copying and rounding half
//       of its columns.
template <bool kVtA, int kForm, bool kPair = false>
__global__ void __launch_bounds__(producer_threads<kVtA, kForm>() + 256, 1)
wy_ring_kernel(const float* __restrict__ pt, const float* __restrict__ qt,
               const float* __restrict__ mask, float* out, int M, int N,
               int K, int kper, int splits, int chunk) {
  constexpr bool kRound = rounds_a<kVtA, kForm>();
  static_assert(kRound || !kPair, "only masked_vt_a's bf16 forms pair");
  constexpr int kProd = producer_threads<kVtA, kForm>();
  constexpr int kStages = ring_stages<kVtA, kForm, kPair>();
  constexpr int kOp = op_bytes<kForm>();                 // bytes
  constexpr int kStage = stage_bytes<kVtA, kForm>() / 4;  // floats
  static_assert(smem_bytes<kVtA, kForm, kPair>() <= 232448,
                "the ring exceeds a block's shared memory");
  extern __shared__ __align__(128) float smem[];
  float* raw = smem + kStages * kStage;     // kRound: the raw A stages
  uint64_t* full = reinterpret_cast<uint64_t*>(
      raw + raw_bytes<kVtA, kForm, kPair>() / 4);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // kPair: this block's rank in its cluster, and the other block's
  const int rank = kPair ? cluster_rank() : 0, peer = 1 - rank;
  if (tid == 0) {
    // full: K2's and TF32's producer thread (masked_vt_a TF32: and the
    // producer's 128 cp.async arrivals); the bf16 forms' one arrival after
    // their producers' block barrier. empty: each consumer warp (of both
    // blocks in a pair)
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kVtA && !kRound ? kProd + 1 : 1);
      mbar_init(empty + s, kPair ? 16 : 8);
    }
    fence_mbar_init();
  }
  if constexpr (kPair)
    cluster_sync();
  else
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

  if (tid < kProd) {
    // ---- producer: warp 0 (masked_vt_a: the whole warpgroup, or both)
    // keeps the ring full
    if constexpr (kRound) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
      // masked_vt_a's bf16 forms: copy, round and hand over A. The block
      // takes columns [c0, c0 + kCols) of each item's A tile (a pair: its
      // half, c0 = 64 rank). Warp pw copies rows [q8, q8 + 8) (q8 = 8 (pw %
      // 4)) x columns [c0 + h, c0 + h + kCols / 2) (h = kCols / 2 (pw / 4))
      // of each raw A stage into `raw` (16-byte cp.async, zero-filled past
      // the part's end and M), kRawStages - 1 stages ahead, then multiplies
      // them by the mask, rounds them (bf16x3: splits them) and writes them
      // into the stage's A tile set(s): lane l takes columns h + l + 32 j
      // (j < kCols / 64), its 8 values of k one 16-byte row of a core
      // matrix, so that the warp's loads and stores meet no bank conflict.
      // Thread 0 first posts the stage's bytes (V^T's tile sets, and in a
      // pair the other block's half of the A tile) and bulk-copies V^T's
      // tile sets; after the producers' fences and a barrier among them it
      // arrives on full, and in a pair bulk-copies the block's half of the
      // A tile set(s) to the same place in the other block, counted there
      // by full.
      constexpr int kCols = round_cols<kPair>();
      constexpr int kLanes = kCols / 8;     // lanes a row of a warp's copy
      constexpr int kHalf = kTileRows / 2 * BK * 2;   // bytes, a pair's half
      const int c0 = kPair ? rank * kCols : 0;
      const int q8 = 8 * ((tid >> 5) & 3);
      const int h = kCols / 2 * (tid >> 7);
      Item ld;                              // the stage the copies are at
      int lkt = 0;
      enter(ld, blockIdx.x);
      auto next = [&]() {
        if (++lkt == ld.nk) {
          lkt = 0;
          ld.item += gridDim.x;
          if (ld.item < items) enter(ld, ld.item);
        }
      };
      auto copy_raw = [&](int r) {
        const int k0 = ld.kbeg + lkt * BK + q8 + lane / kLanes;
        const int kend = min(K, ld.kbeg + kper);
        const int col = ld.m0 + c0 + h + 4 * (lane % kLanes);
        float* dst = raw + (r * BK + q8 + lane / kLanes) * kCols + h +
                     4 * (lane % kLanes);
#pragma unroll
        for (int e = 0; e < 8; e += 32 / kLanes) {
          const bool ok = k0 + e < kend && col < M;
          cp_async16(dst + e * kCols,
                     ok ? pt + (size_t)(k0 + e) * M + col : pt, ok ? 16 : 0);
        }
      };
      // the raw stage rs, times the mask of this thread's columns, into the
      // A tile set(s) of the ring stage st
      float mk[kCols / 64];
      auto round_stage = [&](char* st, int rs) {
        const float* src = raw + (rs * BK + q8) * kCols + h + lane;
        char* dst = st + kOp + q8 * 16;     // core matrices (., q8 / 8)
#pragma unroll
        for (int j = 0; j < kCols / 64; ++j) {
          const int i = c0 + h + lane + 32 * j;
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x0 = src[(2 * e) * kCols + 32 * j] * mk[j];
            const float x1 = src[(2 * e + 1) * kCols + 32 * j] * mk[j];
            if constexpr (kForm == kFormBf16x3)
              split_bf16(x0, x1, hi[e], lo[e]);
            else
              hi[e] = pack_bf16(x0, x1);
          }
          char* row = dst + (i / 8) * kCoreNBf16 + (i % 8) * 16;
          *reinterpret_cast<uint4*>(row) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          if constexpr (kForm == kFormBf16x3)
            *reinterpret_cast<uint4*>(row + kTileFloats * 2) =
                make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      };
      for (int r = 0; r < kRawStages - 1; ++r) {
        if (ld.item < items) {
          copy_raw(r);
          next();
        }
        cp_async_commit();
      }
      int slot = 0, rs = 0;
      uint32_t parity = 1;                  // the stages start empty
      Item c;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        enter(c, item);
#pragma unroll
        for (int j = 0; j < kCols / 64; ++j) {
          const int i = c.m0 + c0 + h + lane + 32 * j;
          mk[j] = i < M ? mask[i] : 0.f;
        }
        for (int kt = 0; kt < c.nk; ++kt) {
          __syncwarp();            // the warp has read raw stage rs - 1
          if (ld.item < items) {
            copy_raw(rs == 0 ? kRawStages - 1 : rs - 1);
            next();
          }
          cp_async_commit();
          cp_async_wait<kRawStages - 1>();
          __syncwarp();            // and the warp's copies of stage rs landed
          mbar_wait(empty + slot, parity);
          char* st = reinterpret_cast<char*>(smem + slot * kStage);
          if (tid == 0) {
            mbar_expect_tx(full + slot, kOp + (kPair ? kOp / 2 : 0));
            bulk_load(reinterpret_cast<float*>(st),
                      qt + ((size_t)(c.n0 / BN) * S + c.kbeg / BK + kt) *
                               (kOp / 4),
                      kOp, full + slot);
          }
          round_stage(st, rs);
          fence_proxy_async();
          bar_sync(1, kProd);      // the block's half (or tile) is written
          if (tid == 0) {
            mbar_arrive(full + slot);
            if constexpr (kPair) {
              char* mine = st + kOp + rank * kHalf;
              bulk_copy_to_block(reinterpret_cast<float*>(mine), kHalf,
                                 full + slot, peer);
              if constexpr (kForm == kFormBf16x3)
                bulk_copy_to_block(
                    reinterpret_cast<float*>(mine + kTileFloats * 2), kHalf,
                    full + slot, peer);
            }
          }
          rs = rs + 1 == kRawStages ? 0 : rs + 1;
          if (++slot == kStages) {
            slot = 0;
            parity ^= 1;
          }
        }
      }
      if constexpr (kPair) cluster_sync();  // no block leaves while the
      return;                               // other writes or arrives here
    }
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
        const float* qsrc = qt + ((size_t)(c.n0 / BN) * S + sg) * (kOp / 4);
        if (tid == 0) {
          // the rounded tiles: Z^T's and V's, or V^T's
          mbar_arrive_expect(full + slot, (kVtA ? 1 : 2) * kOp);
          bulk_load(st, qsrc, kOp, full + slot);
          if (!kVtA)
            bulk_load(st + kOp / 4,
                      pt + ((size_t)(c.m0 / BM) * S + sg) * (kOp / 4), kOp,
                      full + slot);
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
  if constexpr (kRound)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = lane >> 2, t = lane & 3;
  const int wg = (tid - kProd) >> 7;
  const int wm = wg * 64 + ((tid >> 5) & 3) * 16;   // this warp's rows

  // a thread's share of its warpgroup's 64 x 128 accumulator: for the
  // 8-column group c, rows g and g+8 of its warp, columns 8c+2t and
  // 8c+2t+1, as [4c] (g, 2t), [4c+1] (g, 2t+1), [4c+2] (g+8, 2t), [4c+3]
  // (g+8, 2t+1)
  float acc[4 * NT];        // sums of whole chunks, added with FADD
  float part[4 * NT];       // the running chunk, added to by the wgmma
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e) acc[e] = part[e] = 0.f;
  int slot = 0;
  uint32_t parity = 0;
  Item c;

  if constexpr (kRound) {
    // masked_vt_a's bf16 forms: both operands in shared memory. At chunk
    // 1 the stages' sums go to `part` and `other` in turn, and each
    // stage's products are issued before the previous stage's are waited
    // for (wgmma.wait_group 1), whose fold then runs while the tensor
    // cores work. Other chunks take `part` alone: a chunk's products stay
    // in flight, each stage released once its own are in, and the chunk
    // is folded after its last.
    float other[4 * NT];
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) other[e] = 0.f;
    // the next stage: wait for it, issue its products into d; returns its
    // slot
    auto issue = [&](float (&d)[4 * NT], int keep) {
      mbar_wait(full + slot, parity);
      wgmma_fence();
      const char* st = reinterpret_cast<const char*>(smem + slot * kStage);
      bf16_stage_mma<kForm>(d, st, wg, keep);
      wgmma_commit();
      const int s = slot;
      if (++slot == kStages) {
        slot = 0;
        parity ^= 1;
      }
      return s;
    };
    auto release = [&](int s) {
      if (lane == 0) {
        mbar_arrive(empty + s);
        if constexpr (kPair) mbar_arrive_remote(empty + s, peer);
      }
    };
    auto fold = [&](float (&d)[4 * NT]) {
      fence_acc(d);
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) acc[e] += d[e];
    };
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      enter(c, item);
      if (chunk == 1) {
        // stage kt's sums in part (kt even) or other (kt odd)
        int sp = issue(part, 0), so = 0;
        for (int kt = 1; kt < c.nk; kt += 2) {
          so = issue(other, 0);
          wgmma_wait<1>();
          fold(part);
          release(sp);
          if (kt + 1 == c.nk) break;
          sp = issue(part, 0);
          wgmma_wait<1>();
          fold(other);
          release(so);
        }
        wgmma_wait<0>();
        if (c.nk & 1) {
          fold(part);
          release(sp);
        } else {
          fold(other);
          release(so);
        }
      } else {
        int since = 0, held = -1;   // a slot whose products may be pending
        for (int kt = 0; kt < c.nk; ++kt) {
          const int s = issue(part, since > 0);
          const bool ends = ++since == chunk || kt == c.nk - 1;
          if (ends)
            wgmma_wait<0>();
          else
            wgmma_wait<1>();
          if (held >= 0) release(held);       // its products are in
          held = s;
          if (ends) {
            since = 0;
            fold(part);
            release(s);
            held = -1;
          }
        }
      }
      store_transposed(acc, out + (size_t)(c.kbeg / kper) * M * N, M, N,
                       c.m0 + wm, c.n0, g, t);
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) acc[e] = 0.f;
    }
    if constexpr (kPair) cluster_sync();
    return;
  }

  int since = 0;            // stages in the running chunk
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
      if constexpr (kForm == kFormTf32) {
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
      } else {
        bf16_stage_mma<kForm>(part, reinterpret_cast<const char*>(st), wg,
                              since > 0);
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
      store_transposed(acc, out + (size_t)(c.kbeg / kper) * M * N, M, N,
                       c.m0 + wm, c.n0, g, t);
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

// Persistent blocks, one a multiprocessor, as many as there are items;
// kPair: clusters of 2, as many as the card holds at once (asked of the
// driver once a device) or as there are pairs of items
template <bool kVtA, int kForm, bool kPair = false>
int launch_wy_ring(const float* pt, const float* qt, const float* mask,
                   float* out, int M, int N, int K, int kper, int splits,
                   int chunk, cudaStream_t stream) {
  auto* kernel = wy_ring_kernel<kVtA, kForm, kPair>;
  constexpr int kSmem = (int)smem_bytes<kVtA, kForm, kPair>();
  constexpr int kBlock = producer_threads<kVtA, kForm>() + 256;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long items =
      (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM) * splits;
  if (items >= INT32_MAX) return (int)cudaErrorInvalidValue;
  chunk = chunk > 0 ? chunk : INT32_MAX;
  if constexpr (!kPair) {
    const int grid = (int)(items < sms ? items : sms);
    kernel<<<grid, kBlock, kSmem, stream>>>(pt, qt, mask, out, M, N, K,
                                            kper, splits, chunk);
    return (int)cudaGetLastError();
  } else {
    constexpr int kDevices = 64;
    static int known[kDevices] = {};         // clusters the card holds
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.blockDim = dim3(kBlock);
    cfg.gridDim = dim3(sms / 2 * 2);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int pairs = dev >= 0 && dev < kDevices ? known[dev] : 0;
    if (pairs < 1) {
      err = cudaOccupancyMaxActiveClusters(&pairs, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (pairs < 1) return (int)cudaErrorLaunchOutOfResources;
      if (dev >= 0 && dev < kDevices) known[dev] = pairs;
    }
    cfg.gridDim = dim3(2 * (int)(items / 2 < pairs ? items / 2 : pairs));
    return (int)cudaLaunchKernelEx(&cfg, kernel, pt, qt, mask, out, M, N, K,
                                   kper, splits, chunk);
  }
}

// a_minus_vz_masked in the bf16 form kForm: V and Z^T rounded into `vr`
// and `zt` (bf16x3: hi and lo tiles), then the ring kernel
template <int kForm>
int a_minus_vz_masked_bf16_ring(void* A, const void* V, const void* Z,
                                const void* mask, void* vr, void* zt, int m,
                                int k, int w, int chunk, void* stream) {
  if (w % 4 || !aligned16(A) || !aligned16(mask) || !aligned16(vr) ||
      !aligned16(zt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr bool split = kForm == kFormBf16x3;
  int err = launch_bf16_tiles((const float*)V, vr, m, k, k, 1, split, s);
  if (err == 0)
    err = launch_bf16_tiles((const float*)Z, zt, w, k, 1, w, split, s);
  if (err != 0) return err;
  return launch_wy_ring<false, kForm>((const float*)vr, (const float*)zt,
                                      (const float*)mask, (float*)A, m, w, k,
                                      k, 1, chunk, s);
}

// masked_vt_a in the form kForm: V^T rounded into `vt` (its TF32 or bf16
// tiles, bf16x3 hi and lo), then the ring kernel, then (splits > 1) the
// parts added in index order
template <int kForm>
int masked_vt_a_ring(const void* V, const void* A, const void* mask,
                     void* W, void* part, void* vt, int m, int b, int w,
                     int splits, int chunk, void* stream) {
  if (w % 4 || splits < 1 || splits > 65535 || !aligned16(A) ||
      !aligned16(W) || !aligned16(vt) || (splits > 1 && !aligned16(part)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = kForm == kFormTf32
                ? launch_tf32_tiles((const float*)V, (float*)vt, b, m, 1, b,
                                    s)
                : launch_bf16_tiles((const float*)V, vt, b, m, 1, b,
                                    kForm == kFormBf16x3, s);
  if (err != 0) return err;
  // each part a whole number of stages, and none of them empty
  const int kper = ((m + splits - 1) / splits + BK - 1) / BK * BK;
  splits = (m + kper - 1) / kper;
  float* dst = (float*)(splits > 1 ? part : W);
  // the bf16 forms at b in (128, 256]: the two column tiles of W^T in
  // clusters of 2 that share the rounded A
  if constexpr (kForm != kFormTf32)
    err = (b + BN - 1) / BN == 2
              ? launch_wy_ring<true, kForm, true>(
                    (const float*)A, (const float*)vt, (const float*)mask,
                    dst, w, b, m, kper, splits, chunk, s)
              : launch_wy_ring<true, kForm>(
                    (const float*)A, (const float*)vt, (const float*)mask,
                    dst, w, b, m, kper, splits, chunk, s);
  else
    err = launch_wy_ring<true, kForm>((const float*)A, (const float*)vt,
                                      (const float*)mask, dst, w, b, m,
                                      kper, splits, chunk, s);
  if (err != 0 || splits == 1) return err;
  const size_t n4 = (size_t)b * w / 4;
  add_parts_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      (const float4*)part, (float4*)W, n4, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The TF32 pre-pass alone: `out` (the tiles of ceil(R/128) x ceil(K/32)
// stages, 4096 floats each, 16-byte aligned) = X rounded to TF32, X(r, q)
// = src[r sr + q sq] (strides in floats). Refuses a misaligned `out`.
int rl_tf32_tiles_f32(const void* src, void* out, int R, int K,
                      long long sr, long long sq, void* stream) {
  if (!aligned16(out) || R < 0 || K < 0) return (int)cudaErrorInvalidValue;
  return launch_tf32_tiles((const float*)src, (float*)out, R, K, sr, sq,
                           (cudaStream_t)stream);
}

// The bf16 pre-pass alone: `out` (the tiles as above, 4096 bf16 each; with
// `split` the hi and the lo tile of each, 16-byte aligned) = X rounded to
// bf16 (and its lo halves). Refuses a misaligned `out`.
int rl_bf16_tiles_f32(const void* src, void* out, int R, int K,
                      long long sr, long long sq, int split, void* stream) {
  if (!aligned16(out) || R < 0 || K < 0) return (int)cudaErrorInvalidValue;
  return launch_bf16_tiles((const float*)src, out, R, K, sr, sq, split != 0,
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
  return masked_vt_a_ring<kFormTf32>(V, A, mask, W, part, vt, m, b, w,
                                     splits, chunk, stream);
}

// The same in one bf16 product: `vt` holds V^T's bf16 tiles (4096 values a
// tile, as rl_bf16_tiles_f32 without split); A is masked and rounded as
// the kernel reads it. The same conditions.
int rl_masked_vt_a_bf16_f32(const void* V, const void* A, const void* mask,
                            void* W, void* part, void* vt, int m, int b,
                            int w, int splits, int chunk, void* stream) {
  return masked_vt_a_ring<kFormBf16>(V, A, mask, W, part, vt, m, b, w,
                                     splits, chunk, stream);
}

// The same in three bf16 products: `vt` holds hi and lo tiles (twice the
// values, as rl_bf16_tiles_f32 with split).
int rl_masked_vt_a_bf16x3_f32(const void* V, const void* A, const void* mask,
                              void* W, void* part, void* vt, int m, int b,
                              int w, int splits, int chunk, void* stream) {
  return masked_vt_a_ring<kFormBf16x3>(V, A, mask, W, part, vt, m, b, w,
                                       splits, chunk, stream);
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
  return launch_wy_ring<false, kFormTf32>((const float*)vr, (const float*)zt,
                                          (const float*)mask, (float*)A, m,
                                          w, k, k, 1, chunk, s);
}

// The same in one bf16 product: `vr` and `zt` hold the bf16 tiles (4096
// values a tile, as rl_bf16_tiles_f32 without split); the same conditions.
int rl_a_minus_vz_masked_bf16_f32(void* A, const void* V, const void* Z,
                                  const void* mask, void* vr, void* zt,
                                  int m, int k, int w, int chunk,
                                  void* stream) {
  return a_minus_vz_masked_bf16_ring<kFormBf16>(A, V, Z, mask, vr, zt, m, k,
                                                w, chunk, stream);
}

// The same in three bf16 products: `vr` and `zt` hold hi and lo tiles
// (twice the values, as rl_bf16_tiles_f32 with split).
int rl_a_minus_vz_masked_bf16x3_f32(void* A, const void* V, const void* Z,
                                    const void* mask, void* vr, void* zt,
                                    int m, int k, int w, int chunk,
                                    void* stream) {
  return a_minus_vz_masked_bf16_ring<kFormBf16x3>(A, V, Z, mask, vr, zt, m,
                                                  k, w, chunk, stream);
}

}  // extern "C"
