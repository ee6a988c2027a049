"""Where the time of K1/K2's ring kernels goes, on the card.

    python3 tools/wy_ring_anatomy.py

Builds copies of randlapack_tpu_torch/csrc/wy_ring.cu (with nvcc, into
build/anatomy/) whose kernel takes a flag that leaves out a part of the
work: the wgmma (the ring and the epilogue run, the tensor cores do not),
the loads (the producer arrives on each stage without copying it; the
products run on whatever the ring holds), the epilogue, the fold of the
accumulator, K1's fragment work (TF32: the consumers' loads of A's
fragments from shared memory, the rounding stays; bf16 forms: the
producers' masking, rounding and stores of the A tile), and the loads
with the fold or the fragment work, and all of these at once (what is
left is the hand-over of the stages); and for K1's bf16 forms at b 256
the unpaired kernel (one block a column tile, as at other b) in place of
the pair of blocks that shares the rounded A. Times each copy at the main shapes
(K1 in all three forms: V 8192x256, A 8192x8192; K2 in all three: k 1024,
8192x8192) by CUDA events, beside the kernel itself, each ring form of
both kernels in turns with its earlier form ("tf32_wy", "bf16_wy",
"bf16x3_wy") and the pre-passes alone. Then a probe of the card's copy
rates into shared memory: cp.async.bulk of 16 KB and of 512 bytes, and
16-byte cp.async, from a window that stays in L2 (24 MB) and from one that
does not (1 GiB). Prints one line per measurement, with the card's name and power
limit first. Results change nothing; the numbers are for PERF.md.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from randlapack_tpu_torch import _build  # noqa: E402
from randlapack_tpu_torch.ops import wy  # noqa: E402

OUT = ROOT / "build" / "anatomy"
FLAGS = {"full": 0, "no wgmma": 1, "no loads": 2, "no epilogue": 4,
         "no fold": 8, "no fragment work (K1)": 16,
         "no loads, no fold": 2 | 8,
         "no loads, no fragment work (K1)": 2 | 16,
         "no loads, no fold, no fragment work (K1)": 2 | 8 | 16,
         "no wgmma, no loads, no fragment work (K1)": 1 | 2 | 16,
         "no wgmma, no loads, no fold, no fragment work (K1)": 1 | 2 | 8 | 16,
         "unpaired (K1 bf16)": 32}

PROBE = r"""
#include "tc.cuh"
constexpr int kSt = 6, kStageBytes = 32768;
__device__ __forceinline__ long long stage_offset(int it, long long window) {
  return ((long long)(blockIdx.x + (long long)it * gridDim.x) * kStageBytes) %
         window;
}
// a ring of 32 KB stages filled by `chunk`-byte bulk copies (warp 0: lane 0
// posts the byte count, the 32 lanes copy) and emptied by warp 1
__global__ void __launch_bounds__(64, 1)
probe_bulk(const float* src, long long window, int chunk, int iters) {
  extern __shared__ __align__(128) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSt * kStageBytes / 4);
  uint64_t* empty = full + kSt;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    fence_mbar_init();
  }
  __syncthreads();
  int slot = 0;
  uint32_t par = 0;
  for (int it = 0; it < iters; ++it) {
    float* st = smem + slot * kStageBytes / 4;
    if (tid < 32) {
      mbar_wait(empty + slot, par ^ 1);
      const long long off = stage_offset(it, window);
      if (lane == 0) mbar_arrive_expect(full + slot, kStageBytes);
      __syncwarp();
      for (int c = lane; c < kStageBytes / chunk; c += 32)
        bulk_load(st + c * chunk / 4, src + (off + c * chunk) / 4, chunk,
                  full + slot);
    } else {
      mbar_wait(full + slot, par);
      if (lane == 0) mbar_arrive(empty + slot);
    }
    if (++slot == kSt) { slot = 0; par ^= 1; }
  }
}
// the same ring filled by 16-byte cp.async of all 256 threads, kSt - 1
// stages ahead, a block barrier a stage
__global__ void __launch_bounds__(256, 1)
probe_cp_async(const float* src, long long window, int iters) {
  extern __shared__ __align__(128) float smem[];
  auto load = [&](int it) {
    const long long off = stage_offset(it, window);
    float* st = smem + (it % kSt) * kStageBytes / 4;
    for (int c = threadIdx.x; c < kStageBytes / 16; c += 256)
      cp_async16(st + c * 4, src + off / 4 + c * 4, 16);
    cp_async_commit();
  };
  for (int s = 0; s < kSt - 1; ++s) load(s);
  for (int it = 0; it < iters; ++it) {
    if (it + kSt - 1 < iters) load(it + kSt - 1); else cp_async_commit();
    cp_async_wait<kSt - 1>();
    __syncthreads();
  }
}
extern "C" int run_probe(const void* src, long long window, int chunk,
                         int iters, int grid, void* stream) {
  const int bytes = kSt * kStageBytes + 2 * kSt * 8;
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk) {
    cudaFuncSetAttribute(probe_bulk,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    probe_bulk<<<grid, 64, bytes, s>>>((const float*)src, window, chunk,
                                       iters);
  } else {
    cudaFuncSetAttribute(probe_cp_async,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    probe_cp_async<<<grid, 256, bytes, s>>>((const float*)src, window,
                                            iters);
  }
  return (int)cudaGetLastError();
}
"""


def patch(s: str, old: str, new: str) -> str:
    if s.count(old) != 1:
        raise RuntimeError(f"wy_ring.cu holds {old!r} {s.count(old)} times, "
                           f"not once")
    return s.replace(old, new)


def flagged_source() -> str:
    """wy_ring.cu with a `flags` kernel argument (set by rl_set_flags)."""
    s = (ROOT / "randlapack_tpu_torch" / "csrc" / "wy_ring.cu").read_text()
    s = patch(s, "namespace {\n", "namespace {\nint g_flags = 0;\n")
    s = patch(s, "int K, int kper, int splits, int chunk) {",
              "int K, int kper, int splits, int chunk, int flags) {")
    s = patch(s, "kper, splits, chunk);\n    return (int)cudaGetLastError();",
              "kper, splits, chunk, g_flags);\n    return (int)cudaGetLastError();")
    s = patch(s, "kper, splits, chunk);\n  }\n}",
              "kper, splits, chunk, g_flags);\n  }\n}")
    # TF32 and K2: the producer arrives without copying
    s = patch(s, "\n        mbar_wait(empty + slot, parity);\n",
              "\n        mbar_wait(empty + slot, parity);\n"
              "        if (flags & 2) {\n"
              "          if (kVtA || tid == 0) mbar_arrive(full + slot);\n"
              "          if (kVtA && tid == 0) mbar_arrive(full + slot);\n"
              "          if (++slot == kStages) { slot = 0; parity ^= 1; }\n"
              "          continue;\n"
              "        }\n")
    s = patch(s, "      wgmma_fence();\n"
                 "      if constexpr (kForm == kFormTf32) {",
              "      if (!(flags & 1)) {\n      wgmma_fence();\n"
              "      if constexpr (kForm == kFormTf32) {")
    s = patch(s, "      wgmma_commit();\n      if (kVtA && kt + 1 < c.nk) {",
              "      wgmma_commit();\n      }\n      if (kVtA && kt + 1 < c.nk) {")
    s = patch(s, "if (!kVtA && kt == max(0, c.nk - kLead)) {",
              "if (!kVtA && !(flags & 4) && kt == max(0, c.nk - kLead)) {")
    s = patch(s, "    if constexpr (kVtA) {\n      store_transposed(",
              "    if (flags & 4) {\n    } else if constexpr (kVtA) {\n"
              "      store_transposed(")
    s = patch(s, "        for (int e = 0; e < 4 * NT; ++e) acc[e] += part[e];",
              "        for (int e = 0; e < 4 * NT; ++e)\n"
              "          if (!(flags & 8)) acc[e] += part[e];")
    s = patch(s, "          araw[q][e] = sa[(q * 8 + t + (e >> 1) * 4) * LDA",
              "          araw[q][e] = (flags & 16) ? 1.f : "
              "sa[(q * 8 + t + (e >> 1) * 4) * LDA")
    # K1's bf16 forms: the producer's copies and rounding, the consumers'
    # products, fold and epilogue
    s = patch(s, "          copy_raw(r);", "          if (!(flags & 2)) copy_raw(r);")
    s = patch(s, "            copy_raw(rs == 0",
              "            if (!(flags & 2)) copy_raw(rs == 0")
    s = patch(s, "            mbar_expect_tx(full + slot, kOp + (kPair ? kOp / 2 : 0));\n"
                 "            bulk_load(",
              "            mbar_expect_tx(full + slot, ((flags & 2) ? 0 : kOp) + "
              "(kPair ? kOp / 2 : 0));\n"
              "            if (!(flags & 2)) bulk_load(")
    s = patch(s, "          round_stage(st, rs);",
              "          if (!(flags & 16)) round_stage(st, rs);")
    s = patch(s, "      bf16_stage_mma<kForm>(d, st, wg, keep);",
              "      if (!(flags & 1)) bf16_stage_mma<kForm>(d, st, wg, keep);")
    s = patch(s, "      for (int e = 0; e < 4 * NT; ++e) acc[e] += d[e];",
              "      for (int e = 0; e < 4 * NT; ++e)\n"
              "        if (!(flags & 8)) acc[e] += d[e];")
    s = patch(s, "g, t);\n#pragma unroll\n      for (int e = 0; e < 4 * NT; ++e) acc[e] = 0.f;",
              "g, t, flags);\n#pragma unroll\n      for (int e = 0; e < 4 * NT; ++e) acc[e] = 0.f;")
    s = patch(s, "                                                 int t) {\n",
              "                                                 int t, int flags = 0) {\n"
              "  if (flags & 4) return;\n")
    s = patch(s, "    err = (b + BN - 1) / BN == 2\n",
              "    err = (b + BN - 1) / BN == 2 && !(g_flags & 32)\n")
    return patch(s, 'extern "C" {\n',
                 'extern "C" {\nvoid rl_set_flags(int f) { g_flags = f; }\n')


def build() -> tuple:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "tc.cuh").write_text(
        (ROOT / "randlapack_tpu_torch" / "csrc" / "tc.cuh").read_text())
    (OUT / "wy_ring_flags.cu").write_text(flagged_source())
    (OUT / "probe.cu").write_text(PROBE)
    nvcc = _build._nvcc()
    jobs = [(name, subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
         str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for name in ("wy_ring_flags", "probe")]
    for name, job in jobs:
        log = job.communicate()[0]
        if job.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = ctypes.CDLL(str(OUT / "libwy_ring_flags.so"))
    for form in wy._RING_SETS:
        getattr(lib, f"rl_masked_vt_a_{form}_f32").argtypes = (
            [P] * 6 + [I] * 5 + [P])
        getattr(lib, f"rl_a_minus_vz_masked_{form}_f32").argtypes = (
            [P] * 6 + [I] * 4 + [P])
    lib.rl_set_flags.argtypes = [I]
    probe = ctypes.CDLL(str(OUT / "libprobe.so"))
    probe.run_probe.argtypes = [P, L, I, I, I, P]
    return lib, probe


def cuda_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("wy_ring_anatomy: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib, probe = build()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    m = w = 8192
    b, k = 256, 1024
    V = torch.randn(m, b, generator=g, device=dev)
    A = torch.randn(m, w, generator=g, device=dev)
    mk = (torch.rand(w, generator=g, device=dev) < 0.5).float()
    Vk = torch.randn(m, k, generator=g, device=dev)
    Z = torch.randn(k, w, generator=g, device=dev)
    W = torch.empty(b, w, device=dev)
    # V^T's tiles, the same bytes in every form (TF32: 4 bytes a value;
    # bf16x3: two sets of 2 bytes)
    vt = torch.empty(wy._tiles_floats(b, m), device=dev)
    # the tiles' scratch of the largest form (TF32: 4 bytes a value; bf16x3:
    # two sets of 2 bytes), shared by K2's forms
    vr = torch.empty(wy._tiles_floats(m, k), device=dev)
    zt = torch.empty(wy._tiles_floats(w, k), device=dev)
    none = torch.empty(0, device=dev)

    def k1(form):
        def run():
            err = getattr(lib, f"rl_masked_vt_a_{form}_f32")(
                V.data_ptr(), A.data_ptr(), mk.data_ptr(), W.data_ptr(),
                none.data_ptr(), vt.data_ptr(), m, b, w, 1, wy.CHUNK, stream)
            assert err == 0, err
        return run

    def k2(form):
        def run():
            err = getattr(lib, f"rl_a_minus_vz_masked_{form}_f32")(
                A.data_ptr(), Vk.data_ptr(), Z.data_ptr(), mk.data_ptr(),
                vr.data_ptr(), zt.data_ptr(), m, k, w, wy.CHUNK, stream)
            assert err == 0, err
        return run

    for name, fn, reps in (
            *((f"masked_vt_a {form} m=8192 b=256 w=8192", k1(form), 100)
              for form in wy._RING_SETS),
            *((f"a_minus_vz_masked {form} m=8192 k=1024 w=8192", k2(form),
               20) for form in wy._RING_SETS)):
        times = {}
        for what, flag in FLAGS.items():
            if "K1" in what and "masked_vt_a" not in name.split()[0]:
                continue
            if "bf16" in what and (" bf16" not in name
                                   or "masked_vt_a" not in name):
                continue
            lib.rl_set_flags(flag)
            times[what] = cuda_ms(fn, reps)
        lib.rl_set_flags(0)
        print(f"[anatomy] {name}: " + ", ".join(
            f"{what} {t:.4f} ms" for what, t in times.items()), flush=True)
    pre = {"V^T 256x8192": V.T, "V 8192x1024": Vk, "Z^T 8192x1024": Z.T}
    print("[anatomy] pre-pass alone (wrapper, host included): " + ", ".join(
        f"{name} tf32 {cuda_ms(lambda: wy.tf32_tiles(X), 50):.4f} ms, bf16 "
        f"{cuda_ms(lambda: wy.bf16_tiles(X), 50):.4f} ms, bf16 hi and lo "
        f"{cuda_ms(lambda: wy.bf16_tiles(X, True), 50):.4f} ms"
        for name, X in pre.items()), flush=True)
    for form in wy._RING_SETS:
        turns = [cuda_ms(fn, 100) for fn in (
            lambda: wy.masked_vt_a_form(V, A, mk, f"{form}_wy"),
            lambda: wy.masked_vt_a_form(V, A, mk, form),
            lambda: wy.masked_vt_a_form(V, A, mk, form),
            lambda: wy.masked_vt_a_form(V, A, mk, f"{form}_wy"))]
        print(f"[anatomy] masked_vt_a in turns: {form} "
              f"{(turns[1] + turns[2]) / 2:.4f} ms, {form}_wy "
              f"{(turns[0] + turns[3]) / 2:.4f} ms", flush=True)
        turns = [cuda_ms(fn, 20) for fn in (
            lambda: wy.a_minus_vz_masked_form(A, Vk, Z, mk, f"{form}_wy"),
            lambda: wy.a_minus_vz_masked_form(A, Vk, Z, mk, form),
            lambda: wy.a_minus_vz_masked_form(A, Vk, Z, mk, form),
            lambda: wy.a_minus_vz_masked_form(A, Vk, Z, mk, f"{form}_wy"))]
        print(f"[anatomy] a_minus_vz_masked in turns: {form} "
              f"{(turns[1] + turns[2]) / 2:.4f} ms, {form}_wy "
              f"{(turns[0] + turns[3]) / 2:.4f} ms", flush=True)
    del V, A, Vk, Z, vr, zt
    src = torch.zeros(1 << 28, device=dev)       # 1 GiB
    iters = 2048
    for window in (24 << 20, 1 << 30):
        rates = []
        for chunk, what in ((16384, "bulk 16 KB"), (512, "bulk 512 B"),
                            (0, "cp.async 16 B")):
            t = cuda_ms(lambda: probe.run_probe(src.data_ptr(), window, chunk,
                                                iters, 132, stream), 3)
            rates.append(f"{what} {132 * iters * 32768 / (t * 1e9):.2f} "
                         f"TB/s")
        print(f"[anatomy] into shared memory from a {window >> 20} MB "
              f"window, 132 blocks: " + ", ".join(rates), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
