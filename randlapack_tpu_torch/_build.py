"""Build and load the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The ``nvcc``
processes of all files run at once. A library goes into ``build/kernels/``
beside the package, named by its source, a hash of that source, the
``*.cu`` files it includes, the shared ``*.cuh`` headers and the flags, so
an unchanged file reuses its library; ``nvcc``'s report (registers, shared memory and spills per
kernel, from ``-Xptxas -v``) is written beside it as ``<name>.log``. A
source that calls a CUDA library links it (``LINK_LIBS``: ``getrf.cu``,
cuSOLVER's LU), found through the toolkit's ``lib64``.

Only the CUDA branches of the kernel wrappers import this module for the
kernels: the package imports and its CPU tests run where there is no
``nvcc``. It also builds the host-side native Matrix Market reader and
writer (``native/fast_mm.cpp``, a CPython extension) with ``g++`` into
``build/native/``, keyed the same way, for ``extras.io``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_NATIVE_SRC = Path(__file__).resolve().parent / "native" / "fast_mm.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NATIVE_DIR = BUILD_DIR.parent / "native"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# libraries a source links beyond the CUDA runtime (found, at build and at
# load time, in the toolkit's own lib64): getrf.cu binds cuSOLVER's LU
LINK_LIBS = {"getrf.cu": ["cusolver"]}

_P, _I = ctypes.c_void_p, ctypes.c_int
_D, _U = ctypes.c_double, ctypes.c_uint
_L = ctypes.c_longlong
_WY_SIMT = [_P, _P, _P, _P, _I, _I, _I, _P]
_KMM_SIMT = [_P, _P, _P, _P, _P, _I, _I, _I, _D, _I, _P]
_SKETCH_SIMT = [_P, _P, _I, _I, _I, _U, _U, _D, _P]
_RING_K1 = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_RING_K2 = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
# C entry points: name -> argtypes (every pointer and the stream as void*)
# of its _f32 and _f64 forms, or a dict suffix -> argtypes where the two
# differ or one is missing
_SIGNATURES = {
    # f64, SIMT: (V, A, mask, W, m, b, w, stream)
    "rl_masked_vt_a": {"_f64": _WY_SIMT},
    # f64, SIMT: (A, V, Z, mask, m, k, w, stream)
    "rl_a_minus_vz_masked": {"_f64": _WY_SIMT},
    # f32, tensor cores, in the form `mode` (0 3xTF32, 1 TF32, 2 bf16,
    # 3 bf16x3): (V, A, mask, W, part, m, b, w, splits, chunk, mode, stream)
    "rl_masked_vt_a_mode": {"_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _P]},
    # (A, V, Z, mask, m, k, w, chunk, mode, stream)
    "rl_a_minus_vz_masked_mode": {"_f32": [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _I, _P]},
    # f32, the ring kernels (csrc/wy_ring.cu) in one TF32, one bf16 and
    # three bf16 products: (V, A, mask, W, part, vt, m, b, w, splits, chunk,
    # stream) and (A, V, Z, mask, vr, zt, m, k, w, chunk, stream), the
    # rounded tiles' scratch from the wrapper
    "rl_masked_vt_a_tf32": {"_f32": _RING_K1},
    "rl_masked_vt_a_bf16": {"_f32": _RING_K1},
    "rl_masked_vt_a_bf16x3": {"_f32": _RING_K1},
    "rl_a_minus_vz_masked_tf32": {"_f32": _RING_K2},
    "rl_a_minus_vz_masked_bf16": {"_f32": _RING_K2},
    "rl_a_minus_vz_masked_bf16x3": {"_f32": _RING_K2},
    # their pre-passes alone: (src, out, R, K, row stride, reduction
    # stride, stream); bf16 with `split` (0/1) before the stream
    "rl_tf32_tiles": {"_f32": [_P, _P, _I, _I, _L, _L, _P]},
    "rl_bf16_tiles": {"_f32": [_P, _P, _I, _I, _L, _L, _I, _P]},
    # the f32 SIMT kernels, with the f64 forms' arguments
    "rl_masked_vt_a_simt": {"_f32": _WY_SIMT},
    "rl_a_minus_vz_masked_simt": {"_f32": _WY_SIMT},
    # (M, F, s, k, stream): the blocked kernel and the earlier flat one
    "rl_getrfnp": [_P, _P, _P, _I, _P],
    "rl_getrfnp_flat": [_P, _P, _P, _I, _P],
    # step kernels: (Y, live, chosen, work, d, n, nsteps, stream)
    "rl_qrcp_select_pivots": [_P, _P, _P, _P, _I, _I, _I, _P],
    # (P, W, taus, sigma, part, m, b, row0, pivot, stream)
    "rl_qrcp_panel": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (d, n) / (m, b, row0) -> the step kernel's grid, 0: the shape takes
    # the cooperative kernel
    "rl_qrcp_select_pivots_grid": [_I, _I],
    "rl_qrcp_panel_grid": [_I, _I, _I],
    # cooperative kernels: (Y, live, chosen, work, d, n, nsteps,
    # force_global, stream)
    "rl_qrcp_select_pivots_coop": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (P, W, taus, sigma, part, m, b, row0, pivot, force_global, stream)
    "rl_qrcp_panel_coop": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # f32, tensor cores: (X, V, scratch, out, d, n, s, 1/(2 sigma^2), splits,
    #                      chunk, stream)
    # f64, SIMT: (X, V, norms, part, out, d, n, s, 1/(2 sigma^2), splits,
    #             stream)
    "rl_kernel_matmat": {"_f32": [_P, _P, _P, _P, _I, _I, _I, _D, _I, _I,
                                  _P],
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
    # cuSOLVER's getrf (csrc/getrf.cu, a library call, not a kernel):
    # (A, m, n, host int lwork, stream) and (A, work, ipiv, info, m, n,
    # stream), A column-major with lda m
    "rl_getrf_lwork": [_P, _I, _I, _P, _P],
    "rl_getrf": [_P, _P, _P, _P, _I, _I, _P],
}

_fns: dict | None = None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS
                                + LINK_LIBS.get(src.name, [])).encode())
    included = [_CSRC / name for name in
                re.findall(r'^#include "(\w+\.cu)"', src.read_text(), re.M)]
    for f in [src, *included, *sorted(_CSRC.glob("*.cuh"))]:
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


def _link_flags(src: Path, nvcc: str) -> list[str]:
    libs = LINK_LIBS.get(src.name, [])
    if not libs:
        return []
    lib64 = Path(nvcc).resolve().parent.parent / "lib64"
    return [f"-l{name}" for name in libs] + ["-Xlinker", f"-rpath={lib64}"]


def build() -> list[Path]:
    """Compile every source whose library does not exist yet, all in
    parallel: the set-up span ``nvcc``, with a span a source from the
    common start to its ``nvcc``'s end (``utils.timing.setup_spans``).
    Returns the libraries' paths."""
    outs = [library_path(src) for src in _sources()]
    todo = [(src, out) for src, out in zip(_sources(), outs)
            if not out.exists()]
    if not todo:
        return outs
    from .utils.timing import setup_span
    with setup_span("nvcc"):
        _compile(todo)
    return outs


def _compile(todo) -> None:
    from .utils.timing import add_setup_span
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter_ns()
    pending = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        with open(out.with_suffix(".log"), "w") as log:
            pending.append((src, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *_link_flags(src, nvcc), "-o", str(tmp),
                 str(src)],
                stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    while pending:
        time.sleep(0.05)
        for job in [j for j in pending if j[3].poll() is not None]:
            pending.remove(job)
            src, out, tmp, proc = job
            add_setup_span(src.name, t0, time.perf_counter_ns())
            if proc.returncode != 0:
                log = out.with_suffix(".log").read_text()
                failed.append(f"{out.name}: nvcc failed ({proc.returncode})"
                              f":\n{log[-4000:]}")
            else:
                os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def lib() -> dict:
    """The kernels' C entry points by name (``rl_…_f32``/``_f64``), the
    libraries built on first use: the set-up span ``setup.kernels`` (the
    sources' check, ``build``, the loads and the binding)."""
    global _fns
    if _fns is None:
        from .utils.timing import setup_span
        with setup_span("setup.kernels"):
            _fns = _load()
    return _fns


def _load() -> dict:
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
    return fns


def call(name: str, out, *args) -> None:
    """Launch ``name`` for ``out``'s dtype on ``out``'s device, on
    PyTorch's current stream there, with ``args`` (tensors become device
    pointers); raise if the launch was refused, and before it for a
    batched tensor or one that autograd would differentiate through."""
    import torch

    from .ops.util import require_kernel_operands
    require_kernel_operands(name, *args)
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}[out.dtype]
    fn = lib()[name + suffix]
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    with torch.cuda.device(out.device):
        err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}{suffix} launch failed with "
                           f"cudaError {err}")


def _native_flags() -> list[str]:
    import sysconfig

    import numpy
    return ["-O3", "-std=c++17", "-shared", "-fPIC",
            "-I" + sysconfig.get_paths()["include"],
            "-I" + numpy.get_include()]


def build_native() -> Path:
    """Compile ``native/fast_mm.cpp`` with ``g++`` unless its library
    exists (named by a hash of the source, the flags, which hold the
    Python and numpy headers' paths, and numpy's version). Returns the
    library's path; raises ``OSError`` when there is no ``g++`` and
    ``subprocess.CalledProcessError`` when it fails."""
    import sysconfig

    import numpy
    flags = _native_flags()
    h = hashlib.sha256(" ".join(flags + [numpy.__version__]).encode())
    h.update(_NATIVE_SRC.read_bytes())
    out = NATIVE_DIR / (f"fast_mm_{h.hexdigest()[:16]}"
                        + sysconfig.get_config_var("EXT_SUFFIX"))
    if not out.exists():
        NATIVE_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *flags, "-o", str(tmp), str(_NATIVE_SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def load_native():
    """The native Matrix Market module (``fast_mm_read``,
    ``fast_mm_write``), built on first use."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("_randlapack_native",
                                                  build_native())
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
