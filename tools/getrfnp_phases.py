"""Where the blocked K3 kernel's time goes, phase by phase, on the card.

    python3 tools/getrfnp_phases.py

Builds a copy of randlapack_tpu_torch/csrc/getrfnp.cu in which thread 0
reads clock64 after every block barrier (into build/getrfnp_phases/; the
kernel's arithmetic is unchanged), runs it on orthonormal matrices at
k 128 and 256 in f32 (the f32 library), and prints the SM cycles of each
phase: the copy of M into shared memory (when the whole matrix fits), P1
of the first panel, then for each panel P2 (rows of L21, columns of U12)
and P3 (the trailing update, with the next panel's P1 on warp 0 and the
finished panel's write-out), and the write-out of the last panel. Also
prints the card's SM clock and ptxas's report. Needs nvcc and a card.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from randlapack_tpu_torch import _build  # noqa: E402

NB, SMEM_MAX, TR = 32, 232448, 8


def stamped_source() -> str:
    src = (ROOT / "randlapack_tpu_torch/csrc/getrfnp.cu").read_text()
    head, flat = src.split("// ---- the earlier flat kernel")
    head = head.replace("namespace {", """__device__ unsigned long long g_stamps[4096];
__device__ int g_ns;
#define STAMP() do { if (threadIdx.x == 0) g_stamps[g_ns++] = clock64(); } while (0)
namespace {""", 1)
    head = head.replace("__syncthreads();", "__syncthreads(); STAMP();")
    head = head.replace("  const int tid = threadIdx.x;\n  const bool vec",
                        "  const int tid = threadIdx.x;\n  STAMP();\n"
                        "  const bool vec", 1)
    last = re.search(r"\n  for \(int e = tid; e < nl \* nl; e \+= kThreads\)"
                     r"\n.*?;\n", head, re.S)
    head = (head[:last.end()] + "  __syncthreads(); STAMP();\n"
            + head[last.end():])
    return head + "// ---- the earlier flat kernel" + flat + """
extern "C" int rl_stamps(unsigned long long* out, int* n) {
  cudaMemcpyFromSymbol(n, g_ns, sizeof(int));
  cudaMemcpyFromSymbol(out, g_stamps, sizeof(unsigned long long) * 4096);
  int zero = 0;
  return (int)cudaMemcpyToSymbol(g_ns, &zero, sizeof(int));
}
"""


def j_resident(k: int, esize: int) -> int:
    """pick_resident of the kernel."""
    def need(n):
        lt = -(-(n - NB) // TR) * TR if n > NB else 0
        return esize * (NB * (NB + 1) + NB * lt + n * (n + 1))
    j = 0
    while need(k - j) > SMEM_MAX:
        j += NB
    return j


def main() -> int:
    if not torch.cuda.is_available():
        print("getrfnp_phases: no CUDA device", file=sys.stderr)
        return 1
    out = ROOT / "build" / "getrfnp_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "getrfnp_stamped.cu"
    cu.write_text(stamped_source())
    so = cu.with_suffix(".so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(ROOT / "randlapack_tpu_torch/csrc"), "-o",
                        str(so), str(cu)], capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    print("ptxas:", "; ".join(ln.strip() for ln in (r.stdout + r.stderr)
                              .splitlines() if "registers" in ln))
    lib = ctypes.CDLL(str(so))
    lib.rl_getrfnp_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                           ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 4096)()
    n = ctypes.c_int()
    lib.rl_stamps(buf, ctypes.byref(n))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype, k in ((torch.float32, 128), (torch.float32, 256)):
        M = torch.linalg.qr(torch.randn(k, k, generator=g, device="cuda",
                                        dtype=dtype))[0].contiguous()
        F, s = torch.empty_like(M), torch.empty(k, device="cuda", dtype=dtype)
        best = None
        for _ in range(5):
            lib.rl_stamps(buf, ctypes.byref(n))
            lib.rl_getrfnp_f32(M.data_ptr(), F.data_ptr(), s.data_ptr(), k,
                               torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            lib.rl_stamps(buf, ctypes.byref(n))
            st = [buf[i] for i in range(n.value)]
            if best is None or st[-1] - st[0] < best[-1] - best[0]:
                best = st
        d = [b - a for a, b in zip(best, best[1:])]
        jr = j_resident(k, M.element_size())
        names = (["copy M in"] if jr == 0 else []) + ["P1 of panel 0"]
        for j in range(0, k - NB, NB):
            names += [f"P2 {j}", f"P3+P1 {j}"]
        names.append("last write-out")
        print(f"{str(dtype)[6:]} k {k} (shared memory from panel {jr}): "
              f"{best[-1] - best[0]} cycles; " + ", ".join(
                  f"{name} {c}" for name, c in zip(names, d)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
