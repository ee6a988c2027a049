// What the tensor-core kernels of this directory share (wy.cu: K1/K2,
// gaussian_sketch.cu: K7): the fp32 -> TF32 hi/lo split, cp.async and
// fence wrappers, wgmma.mma_async.m64n128k8 (tf32 in, fp32 accumulate) with
// its shared-memory descriptor for a K-major operand in unswizzled core
// matrices, and the pass that adds the parts of a split reduction in index
// order. Every kernel that includes this walks its reduction in stages of
// BK = 32 and keeps the split right operand of a stage as BK x 128 TF32
// values in core matrices of 8 columns x 16 bytes of k (128 contiguous
// bytes each, kCoreK bytes to the next one along k, kCoreN along n).

#pragma once

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

// makes this thread's shared-memory stores visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
