"""Build and load the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The ``nvcc``
processes of all files run at once. A library goes into ``build/kernels/``
beside the package, named by its source, a hash of that source, the
shared ``*.cuh`` headers and the flags, so an unchanged file reuses its
library; ``nvcc``'s report (registers, shared memory and spills per
kernel, from ``-Xptxas -v``) is written beside it as ``<name>.log``.

Only the CUDA branches of the kernel wrappers import this module: the
package imports and its CPU tests run where there is no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_D, _U = ctypes.c_double, ctypes.c_uint
_WY_SIMT = [_P, _P, _P, _P, _I, _I, _I, _P]
_KMM_SIMT = [_P, _P, _P, _P, _P, _I, _I, _I, _D, _I, _P]
_SKETCH_SIMT = [_P, _P, _I, _I, _I, _U, _U, _D, _P]
# C entry points: name -> argtypes (every pointer and the stream as void*)
# of its _f32 and _f64 forms, or a dict suffix -> argtypes where the two
# differ or one is missing
_SIGNATURES = {
    # f32, tensor cores: (V, A, mask, W, part, m, b, w, splits, chunk, stream)
    # f64, SIMT: (V, A, mask, W, m, b, w, stream)
    "rl_masked_vt_a": {"_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                       "_f64": _WY_SIMT},
    # f32, tensor cores: (A, V, Z, mask, m, k, w, chunk, stream)
    # f64, SIMT: (A, V, Z, mask, m, k, w, stream)
    "rl_a_minus_vz_masked": {"_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
                             "_f64": _WY_SIMT},
    # the f32 SIMT kernels, with the f64 forms' arguments
    "rl_masked_vt_a_simt": {"_f32": _WY_SIMT},
    "rl_a_minus_vz_masked_simt": {"_f32": _WY_SIMT},
    # (M, F, s, k, stream)
    "rl_getrfnp": [_P, _P, _P, _I, _P],
    # (Y, live, chosen, work, d, n, nsteps, force_global, stream)
    "rl_qrcp_select_pivots": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (P, W, taus, sigma, part, m, b, row0, pivot, force_global, stream)
    "rl_qrcp_panel": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # f32, tensor cores: (X, V, scratch, out, d, n, s, 1/(2 sigma^2), splits,
    #                      stream)
    # f64, SIMT: (X, V, norms, part, out, d, n, s, 1/(2 sigma^2), splits,
    #             stream)
    "rl_kernel_matmat": {"_f32": [_P, _P, _P, _P, _I, _I, _I, _D, _I, _P],
                         "_f64": _KMM_SIMT},
    "rl_kernel_matmat_simt": {"_f32": _KMM_SIMT},
    # f32, tensor cores: (A, out, part, d, m, n, key0, key1, scale, splits,
    #                      chunk, stream)
    # f64, SIMT: (A, out, d, m, n, key0, key1, scale, stream)
    "rl_gaussian_sketch": {"_f32": [_P, _P, _P, _I, _I, _I, _U, _U, _D, _I,
                                    _I, _P],
                           "_f64": _SKETCH_SIMT},
    "rl_gaussian_sketch_simt": {"_f32": _SKETCH_SIMT},
    # () -> clusters of K7's tensor-core kernel the card holds at once
    "rl_gaussian_sketch_wave": {"": []},
}

_fns: dict | None = None
build_seconds: float | None = None   # wall time of this process's build
source_seconds: dict = {}            # source name -> its nvcc's wall time
                                     # (all start together)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): "
                           "the kernels need nvcc to build")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build() -> list[Path]:
    """Compile every source whose library does not exist yet, all in
    parallel. Returns the libraries' paths."""
    global build_seconds
    outs = [library_path(src) for src in _sources()]
    todo = [(src, out) for src, out in zip(_sources(), outs)
            if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    pending = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        with open(out.with_suffix(".log"), "w") as log:
            pending.append((src, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    source_seconds.clear()
    while pending:
        time.sleep(0.05)
        for job in [j for j in pending if j[3].poll() is not None]:
            pending.remove(job)
            src, out, tmp, proc = job
            source_seconds[src.name] = time.perf_counter() - t0
            if proc.returncode != 0:
                log = out.with_suffix(".log").read_text()
                failed.append(f"{out.name}: nvcc failed ({proc.returncode})"
                              f":\n{log[-4000:]}")
            else:
                os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def lib() -> dict:
    """The kernels' C entry points by name (``rl_…_f32``/``_f64``), the
    libraries built on first use."""
    global _fns
    if _fns is None:
        libs = [ctypes.CDLL(str(path)) for path in build()]
        fns = {}
        for name, sig in _SIGNATURES.items():
            if not isinstance(sig, dict):
                sig = {"_f32": sig, "_f64": sig}
            for suffix, argtypes in sig.items():
                found = [getattr(so, name + suffix) for so in libs
                         if hasattr(so, name + suffix)]
                if len(found) != 1:
                    raise RuntimeError(f"{name + suffix}: found in "
                                       f"{len(found)} kernel libraries")
                fn = found[0]
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name + suffix] = fn
        _fns = fns
    return _fns


def call(name: str, out, *args) -> None:
    """Launch ``name`` for ``out``'s dtype on ``out``'s device, on
    PyTorch's current stream there, with ``args`` (tensors become device
    pointers); raise if the launch was refused."""
    import torch
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}[out.dtype]
    fn = lib()[name + suffix]
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    with torch.cuda.device(out.device):
        err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}{suffix} launch failed with "
                           f"cudaError {err}")
