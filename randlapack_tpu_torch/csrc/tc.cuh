// What the tensor-core kernels of this directory share (wy.cu: K1/K2,
// wy_ring.cu: their ring forms, gaussian_sketch.cu: K7, kernel_matmat.cu:
// K4's wide body): the fp32 -> TF32 hi/lo split, cp.async and fence
// wrappers, the mbarrier and bulk-copy wrappers of the producer/consumer
// rings, wgmma.mma_async.m64n128k8 (tf32 in, fp32 accumulate) with the
// guard that keeps its register operand live until the wait and the fence
// that keeps the accumulator's reads after it, and its shared-memory
// descriptor for a K-major operand in unswizzled core matrices, the fp32
// -> bf16 packing and hi/lo split, the pass that adds the parts of a split
// reduction in index order, and the cluster helpers (mapped addresses,
// remote arrivals, bulk copies between blocks, the cluster barrier). Every
// kernel that includes this walks its reduction in stages of BK = 32 and
// keeps a K-major operand of a stage as 128 x BK TF32 values in core
// matrices of 8 rows x 16 bytes of k (128 contiguous bytes each, kCoreK
// bytes to the next one along k, kCoreN along the rows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int BK = 32;               // reduction depth of a stage
constexpr int kCoreFloats = 32;
constexpr int kCoreK = kCoreFloats * 4;                 // bytes to the next
constexpr int kCoreN = (BK / 4) * kCoreFloats * 4;      // core along k, n

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` (0 or 16) are read, the rest is zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// arrives at `bar` once this thread's cp.async copies so far have landed;
// the arrival is one of the barrier's initial count
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// makes this thread's shared-memory stores visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the barriers this thread initialised visible to the copy engine
// and to the other threads (before the block's first barrier)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// arrives at this block's `bar`
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// arrives at this block's `bar` and tells it to wait for `bytes` more of
// bulk copies as well
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// tells this block's `bar` to wait for `bytes` more of bulk copies, without
// arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// `src` to this block's shared `dst` by the copy engine; `bar` counts them
// as they land
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- thread-block clusters

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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// waits until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 values (13 zero low bits),
// both rounded to nearest, ties away. hi by cvt.rna, which keeps NaN and
// Inf. lo by the same rounding in integer arithmetic (half a unit added
// to the sign-magnitude bit pattern, the low bits cleared), which costs
// less than a second cvt; it garbles only a NaN, and lo is NaN only where
// hi is NaN or Inf and carries the non-finite value on its own.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return (uint32_t)__bfloat16_as_ushort(v.x) |
         ((uint32_t)__bfloat16_as_ushort(v.y) << 16);
}

// a and b rounded to bf16, to nearest even, as one register: a in the low
// half (the lower k of a fragment's pair)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return bf16x2_bits(__floats2bfloat162_rn(a, b));
}

// hi = bf16(x), lo = bf16(x - hi) for x = a and b, packed as pack_bf16:
// the split of the JAX package's bf16_3x_matmul. Inf gives hi = Inf and
// lo = NaN there too.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// wgmma's descriptor of a K-major, unswizzled B operand at `p`: core
// matrices kCoreK bytes apart along k (the leading offset) and kCoreN
// bytes apart along n (the stride offset), all in units of 16 bytes
__device__ __forceinline__ uint64_t b_descriptor(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)(kCoreK >> 4) << 16 | (uint64_t)(kCoreN >> 4) << 32;
}

// d (this warpgroup's 64 x 128) = a (64x8, registers: a warp's 16 rows in
// mma.m16n8k8's A layout) * b (8x128, shared) + (keep ? d : 0); tf32 in,
// fp32 accumulate, asynchronous
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

// after wgmma_wait_all: the accumulator's later reads stay after the wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(d[e]) :: "memory");
}

// Called right after wgmma_wait_all on a stage's TF32 A fragments: the
// tensor cores read them from these registers until the wait, which the
// compiler cannot know, so they stay live (and out of reuse) up to here.
__device__ __forceinline__ void release_frag(const uint32_t (&ah)[BK / 8][4],
                                             const uint32_t (&al)[BK / 8][4]) {
#pragma unroll
  for (int q = 0; q < BK / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("" :: "r"(ah[q][e]), "r"(al[q][e]) : "memory");
}

// W = part[0] + part[1] + ... in index order, 4 floats a thread
__global__ void __launch_bounds__(256)
add_parts_kernel(const float4* __restrict__ part, float4* __restrict__ W,
                 size_t n4, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* p = part + i;
  float4 s = *p;
  for (int z = 1; z < splits; ++z) {
    p += n4;
    s.x += p->x;
    s.y += p->y;
    s.z += p->z;
    s.w += p->w;
  }
  W[i] = s;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
