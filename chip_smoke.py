"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Builds the hand-written kernels from randlapack_tpu_torch/csrc/ (one
nvcc per source, all at once, sm_90a, into build/kernels/), holds each
against its plain PyTorch version at the shapes its path gives it, then
drives the port's paths — two factorizations of 8192×8192 f32 fast-decay
matrices, KRILL and the fused Gaussian sketch:

- BQRRP: bqrrp_factored with the headline configuration (b 256, 2 pivot
  candidates per slot, 2 stages, update defer 4), then bqrrp_q; the same
  factorization with K1/K2 pointed at their earlier SIMT kernels and at
  the tensor-core ones, in turns and under torch.profiler;
- HQRRP: hqrrp_lapack_format with bench.py's config 6 (b 128, update
  defer 4), then Q from the packed reflectors; hqrrp with its ``fail``
  flag and a phase breakdown, a CholQR-panel run and a small f64
  card-vs-CPU parity run;
- KRILL: krill_full_rpchol on a squared-exponential kernel operator over
  n points in 8 dimensions (bench.py's recipe: standardized Gaussian
  data, median-heuristic bandwidth, μ 1e-2, PCG tol 1e-5) at n 65536 with
  a rank-1024 RPCholesky preconditioner (a 17 GB kernel matrix, never
  stored), at bench.py's own n 8192 / k 256, and with four right-hand
  sides under per-column μ, each in f32 (gated on the backward error)
  and in f64 (gated on the true residual); a phase breakdown, the share
  of PCG's wall time the card is busy, both SVD routes timed on the
  factor and a small f64 card-vs-CPU parity run;
- the Gaussian sketch: ops.gaussian_sketch of a 131072×2048 matrix to
  2560 rows (CQRRPT's sketch size d = 1.25·n);
- the n 65536 KRILL solve and that sketch once more with K4 and K7 pointed
  at their earlier SIMT kernels and at the tensor-core ones, in turns.

Each path runs with the launch counts set to 0 just before it and read
just after, and is checked against the JAX test gates at f32 (residual,
orthogonality, permutation, launch counts). Every phase prints one line;
any failed gate raises, and the script exits non-zero. The last two
lines are a JSON summary of the kernels and the device line.
``--profile`` adds K5/K6 timings at fewer blocks and barriers and a
torch.profiler breakdown of one HQRRP factorization by kernel group (the
full table goes to chiprun_out/).

Exits non-zero, printing no result, when no CUDA device is available.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

N = 8192
EPS32 = float(torch.finfo(torch.float32).eps)
RES_GATE = 10 * EPS32 ** 0.75                 # tests/test_bqrrp_factored.py:95
ORTH_GATE = 10 * EPS32 ** 0.75 * math.sqrt(N)  # ... :96
NO_LAUNCHES = dict.fromkeys(
    ("masked_vt_a", "a_minus_vz_masked", "masked_vt_a_simt",
     "a_minus_vz_masked_simt", "getrfnp", "qrcp_select_pivots",
     "qrcp_panel", "kernel_matmat", "gaussian_sketch",
     "kernel_matmat_simt", "gaussian_sketch_simt"), 0)
EXPECTED_LAUNCHES = {**NO_LAUNCHES, "masked_vt_a": 32,
                     "a_minus_vz_masked": 8, "getrfnp": 32}
# HQRRP at 8192², b 128: 64 blocks, one K5 and one K6 launch each
HQRRP_LAUNCHES = {**NO_LAUNCHES, "qrcp_select_pivots": 64, "qrcp_panel": 64}
# KRILL, bench.py's recipe; the full-size run has 8× its n and 4× its k
KRILL_N, KRILL_K = 65536, 1024
# the sketch of CQRRPT at a 131072×2048 matrix: d = 1.25·n rows
SKETCH_M, SKETCH_N, SKETCH_D = 131072, 2048, 2560
KERNELS = {   # name -> (source, TPU kernel it replaces, path it runs on)
    "masked_vt_a": ("randlapack_tpu_torch/csrc/wy.cu",
                    "randlapack_tpu/ops/pallas_wy.py:91", "bqrrp"),
    "a_minus_vz_masked": ("randlapack_tpu_torch/csrc/wy.cu",
                          "randlapack_tpu/ops/pallas_wy.py:134", "bqrrp"),
    "getrfnp": ("randlapack_tpu_torch/csrc/getrfnp.cu",
                "randlapack_tpu/ops/pallas_lu.py:39", "bqrrp"),
    "qrcp_select_pivots": ("randlapack_tpu_torch/csrc/qrcp.cu",
                           "randlapack_tpu/ops/pallas_qrcp.py:50", "hqrrp"),
    "qrcp_panel": ("randlapack_tpu_torch/csrc/qrcp.cu",
                   "randlapack_tpu/ops/pallas_qrcp.py:195", "hqrrp"),
    "kernel_matmat": ("randlapack_tpu_torch/csrc/kernel_matmat.cu",
                      "randlapack_tpu/ops/pallas_kernels.py:48", "krill"),
    "gaussian_sketch": ("randlapack_tpu_torch/csrc/gaussian_sketch.cu",
                        "randlapack_tpu/ops/pallas_kernels.py:125", "op"),
}
# one H100 SXM, published peaks: fp32 outside the tensor cores, dense TF32
# on them, and HBM3
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_FP64 = 34e12          # outside the tensor cores (NVIDIA's data sheet)
PEAK_FP64_TENSOR = 67e12   # FP64 matrix products on them (the same sheet)
PEAK_BYTES = 3.35e12
# an f32 tensor-core result may be this many times further from the f64
# result (relative Frobenius error) than the library's fp32 product (K1,
# K2, K7) or the SIMT kernel (K4) is
F64_ERR_FACTOR = 4.0
SFU_PER_SM_CLOCK = 16      # special-function results per SM and clock (9.0)


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"gate failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def relf(x, ref) -> float:
    """Relative Frobenius distance of ``x`` from the f64 tensor ``ref``."""
    return float(torch.linalg.norm(x.double() - ref)
                 / torch.linalg.norm(ref))


def in_turns(old, new, reps: int) -> tuple:
    """Device milliseconds of ``old()`` and ``new()``, timed old, new,
    new, old within this one call; the mean of each pair."""
    t = [cuda_ms(fn, reps) for fn in (old, new, new, old)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds to launch one ``fn()``: the clock around ``reps``
    calls with no synchronize between them (the card's queue is never
    full at the sizes this is used for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def device_profile(fn):
    """``fn()`` under torch.profiler: its result, the wall seconds around
    a synchronize, and the device-side rows (kernels, memcpy, memset) as
    (name, ms, count), longest first."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA"
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    return out, wall, rows


def reset_counts():
    from randlapack_tpu_torch.ops import kernels, lu, qrcp, wy
    for counts in (wy.LAUNCHES, lu.LAUNCHES, qrcp.LAUNCHES,
                   kernels.LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_counts() -> dict:
    from randlapack_tpu_torch.ops import kernels, lu, qrcp, wy
    return {**wy.LAUNCHES, **lu.LAUNCHES, **qrcp.LAUNCHES,
            **kernels.LAUNCHES}


def sfu_rate() -> float:
    """Special-function results per second of this card: 16 per SM and
    clock (compute capability 9.0) at the SM count PyTorch reports and
    the maximum SM clock nvidia-smi reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_SM_CLOCK * sms * mhz * 1e6


def bound(flops: float, nbytes: float, special: float = 0.0,
          tensor: bool = False, product_flops: float = 0.0,
          f64: bool = False) -> dict:
    """The least time the card could take: the largest of the operations
    over the peak of their type (fp32, or fp64 with ``f64``), the
    special-function operations (exp) over the card's rate for them, and
    the bytes over the memory rate. With ``tensor`` (a plain matrix
    product) the operations take the lesser of flops over that peak and
    their time on the tensor cores: three TF32 products in fp32, which
    compute it to fp32 accuracy, or one FP64 product. That is the least
    time of any route that keeps the accuracy. ``product_flops`` are the
    flops of a matrix product inside a function that also does other work
    (K4's cross term): they are counted that way and added to the time of
    ``flops``."""
    peak = PEAK_FP64 if f64 else PEAK_FP32
    tensor_peak = PEAK_FP64_TENSOR if f64 else PEAK_TF32 / 3
    t_flops = flops / peak
    if tensor:
        t_flops = min(t_flops, flops / tensor_peak)
    t_flops += min(product_flops / peak, product_flops / tensor_peak)
    t_ops = max(t_flops, special / sfu_rate() if special else 0.0)
    t_bytes = nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def earlier_kernel_matmat_bound(work: dict) -> dict:
    """K4's bound as it was counted before the cross term moved to the
    tensor cores: all of its flops on FFMA."""
    return bound(work["flops"] + work["product_flops"], work["nbytes"],
                 work["special"])


def select_pivots_work(Y, nsteps, live):
    """Operations and bytes K5 needs on these inputs: the live columns'
    norms, then per step l the reflector (2(d−l)) and, on each column
    still available, v·W and the rank-1 update (4(d−l)); the exact
    trailing norms, taken only where cancellation asks, are not counted."""
    d, n = Y.shape
    L = int((live > 0).sum())
    flops = 2 * d * L + sum(2 * (d - l) + max(L - l - 1, 0) * 4 * (d - l)
                            for l in range(nsteps))
    nbytes = (d * n + n) * Y.element_size() + nsteps * 8
    return flops, nbytes


def panel_work(m, b, row0, esize):
    """Operations and bytes K6 needs: the column norms below row0, then
    per step l the column norm (2(M−l)) and, on each column right of l,
    v·W and the rank-1 update (4(M−l)), M = m − row0; the panel is read
    once and written once (W), with taus and sigma."""
    M = m - row0
    flops = 2 * M * b + sum(2 * (M - l) + 4 * (b - l - 1) * (M - l)
                            for l in range(b))
    return flops, 2 * m * b * esize + b * (esize + 8)


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, special-function rate "
          f"{sfu_rate():.3e}/s", flush=True)
    print(smi, flush=True)
    return smi


def phase_build() -> None:
    from randlapack_tpu_torch import _build
    t0 = time.perf_counter()
    paths = _build.build()
    _build.lib()
    regs = [f"{path.stem.split('_')[0][3:]}: " + ", ".join(
        ln.split(":", 1)[1].strip() for ln in
        path.with_suffix(".log").read_text().splitlines()
        if "registers" in ln) for path in paths]
    nvcc = ("reused" if _build.build_seconds is None
            else f"nvcc {_build.build_seconds:.2f} s, in parallel; each: "
            + ", ".join(f"{k} {v:.2f} s"
                        for k, v in _build.source_seconds.items())
            + f"; one after another would take "
            f"{sum(_build.source_seconds.values()):.2f} s or less")
    print(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.2f}"
          f" s ({nvcc}); ptxas: "
          f"{' | '.join(regs)}", flush=True)


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version: main-path shapes (timed,
    with the bound and, where one PyTorch call computes the function,
    that call's time) and one ragged case each."""
    from randlapack_tpu_torch.ops import kernels, lu, qr, qrcp, wy
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    f32 = torch.float32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=f32)

    def mask(w):
        return (torch.rand(w, generator=g, device=dev) < 0.5).to(f32)

    def spread(*shape):
        """Columns scaled by exp(-3·U): spread-out column norms, so the
        pivot order is decided above rounding level."""
        return randn(*shape) * torch.exp(
            -3 * torch.rand(shape[1], generator=g, device=dev))[None, :]

    out = {}
    chunks = (1, 2, 4, 16, 64, 0)
    # K1 masked_vt_a: V (8192, 256), A (8192, 8192) and stage 2's half
    # window, a ragged case and one long reduction. Beside the plain
    # version: the f64 product on the card, against which the kernel may
    # err at most F64_ERR_FACTOR times as much as torch.mm in fp32
    for m, b, w, timed in ((N, 256, N, True), (N, 256, N // 2, False),
                           (3000, 200, 1900, False),
                           (65536, 256, 2048, False)):
        V, A, mk = randn(m, b), randn(m, w), mask(w)
        gate(wy.takes_tensor_cores(V, A), "K1 operands off the tensor cores")
        W = wy.masked_vt_a(V, A, mk)
        Wp = wy.masked_vt_a_reference(V, A, mk)
        err = float((W - Wp).abs().max())
        gate(err <= 1e-4 * float(Wp.abs().max()),
             f"masked_vt_a {m}x{b}x{w}: max|d| {err}")
        gate(torch.equal(W, wy.masked_vt_a(V, A, mk)),
             f"masked_vt_a {m}x{b}x{w}: two launches differ")
        ref = V.double().T @ (A.double() * mk.double())
        e_new, e_lib = relf(W, ref), relf(torch.mm(V.T, A * mk), ref)
        e_simt = relf(wy.masked_vt_a_simt(V, A, mk), ref)
        e_emul = relf(W, wy.masked_vt_a_split_reference(V, A, mk).double())
        gate(e_new <= F64_ERR_FACTOR * e_lib,
             f"masked_vt_a {m}x{b}x{w}: error against f64 {e_new}, "
             f"torch.mm's {e_lib}")
        ms_simt, ms_new = in_turns(lambda: wy.masked_vt_a_simt(V, A, mk),
                                   lambda: wy.masked_vt_a(V, A, mk), 10)
        lib_ms = cuda_ms(lambda: torch.mm(V.T, A), 10)
        if timed:
            out["masked_vt_a"] = dict(
                max_abs_err=err, ms=ms_new,
                plain_ms=cuda_ms(
                    lambda: wy.masked_vt_a_reference(V, A, mk), 10),
                **bound(2 * m * b * w + m * w,
                        4 * (m * b + m * w + w + b * w), tensor=True),
                library_ms=lib_ms,
                library_call="torch.mm(V.T, A), unmasked",
                simt_ms=ms_simt, err_vs_f64=e_new, simt_err_vs_f64=e_simt,
                library_err_vs_f64=e_lib)
        print(f"[kernel] masked_vt_a m={m} b={b} w={w} ("
              f"{wy.masked_vt_a_splits(m, b, w, sms)} parts of m): max|d| "
              f"{err:.3e} (max|plain| {float(Wp.abs().max()):.3e}); relative "
              f"error against f64: kernel {e_new:.3e}, SIMT {e_simt:.3e}, "
              f"torch.mm fp32 {e_lib:.3e}; kernel against the three-product "
              f"emulation {e_emul:.3e}; two launches bit-equal; kernel "
              f"{ms_new:.4f} ms, SIMT {ms_simt:.4f} ms, torch.mm unmasked "
              f"{lib_ms:.4f} ms", flush=True)
        if m >= N and w != N // 2:
            sweep = [(c, relf(wy.masked_vt_a(V, A, mk, chunk=c), ref),
                      cuda_ms(lambda: wy.masked_vt_a(V, A, mk, chunk=c), 10))
                     for c in chunks]
            print(f"[kernel-chunk] masked_vt_a m={m} b={b} w={w}, stages of"
                  f" 32 per chunk (0: one chunk): error against f64, ms: "
                  + "; ".join(f"{c}: {e:.3e}, {t:.4f}" for c, e, t in sweep)
                  + f" (default {wy.CHUNK})", flush=True)
        del V, A, W, Wp, ref
    # K2 a_minus_vz_masked: A (8192, 8192), V (8192, 1024), Z (1024, 8192)
    # and stage 2's half window, and a ragged case
    for m, k, w, timed in ((N, 1024, N, True), (N, 1024, N // 2, False),
                           (3000, 200, 1900, False)):
        A, V, Z, mk = randn(m, w), randn(m, k), randn(k, w), mask(w)
        gate(wy.takes_tensor_cores(A, V, Z, mk),
             "K2 operands off the tensor cores")
        Ap = wy.a_minus_vz_masked_reference(A, V, Z, mk)
        Ak = wy.a_minus_vz_masked(A.clone(), V, Z, mk)
        err = float((Ak - Ap).abs().max())
        gate(err <= 1e-4 * float(Ap.abs().max()),
             f"a_minus_vz_masked {m}x{k}x{w}: max|d| {err}")
        gate(torch.equal(Ak, wy.a_minus_vz_masked(A.clone(), V, Z, mk)),
             f"a_minus_vz_masked {m}x{k}x{w}: two launches differ")
        ref = A.double() - (V.double() @ Z.double()) * mk.double()
        e_new = relf(Ak, ref)
        e_lib = relf(torch.addmm(A, V, Z * mk, alpha=-1.0), ref)
        e_simt = relf(wy.a_minus_vz_masked_simt(A.clone(), V, Z, mk), ref)
        e_emul = relf(Ak, wy.a_minus_vz_masked_split_reference(
            A, V, Z, mk).double())
        gate(e_new <= F64_ERR_FACTOR * e_lib,
             f"a_minus_vz_masked {m}x{k}x{w}: error against f64 {e_new}, "
             f"torch.addmm's {e_lib}")
        ms_simt, ms_new = in_turns(
            lambda: wy.a_minus_vz_masked_simt(Ak, V, Z, mk),
            lambda: wy.a_minus_vz_masked(Ak, V, Z, mk), 5)
        lib_ms = cuda_ms(lambda: Ak.addmm_(V, Z, alpha=-1.0), 5)
        if timed:
            out["a_minus_vz_masked"] = dict(
                max_abs_err=err, ms=ms_new,
                plain_ms=cuda_ms(
                    lambda: wy.a_minus_vz_masked_reference(A, V, Z, mk), 5),
                **bound(2 * m * k * w + 2 * m * w,
                        4 * (2 * m * w + m * k + k * w + w), tensor=True),
                library_ms=lib_ms,
                library_call="A.addmm_(V, Z, alpha=-1), unmasked",
                simt_ms=ms_simt, err_vs_f64=e_new, simt_err_vs_f64=e_simt,
                library_err_vs_f64=e_lib)
            sweep = [(c, relf(wy.a_minus_vz_masked(A.clone(), V, Z, mk,
                                                   chunk=c), ref))
                     for c in chunks]
            print(f"[kernel-chunk] a_minus_vz_masked m={m} k={k} w={w}, "
                  f"stages of 32 per chunk (0: one chunk): error against "
                  f"f64: " + "; ".join(f"{c}: {e:.3e}" for c, e in sweep)
                  + f" (default {wy.CHUNK})", flush=True)
        print(f"[kernel] a_minus_vz_masked m={m} k={k} w={w}: max|d| "
              f"{err:.3e} (max|plain| {float(Ap.abs().max()):.3e}); relative "
              f"error against f64: kernel {e_new:.3e}, SIMT {e_simt:.3e}, "
              f"torch.addmm fp32 {e_lib:.3e}; kernel against the "
              f"three-product emulation {e_emul:.3e}; two launches "
              f"bit-equal; kernel {ms_new:.4f} ms, SIMT {ms_simt:.4f} ms, "
              f"addmm_ unmasked {lib_ms:.4f} ms", flush=True)
        del A, V, Z, Ap, Ak, ref
    # K3 getrfnp: a 256x256 orthonormal block (and a ragged 200)
    for k, timed in ((256, True), (200, False)):
        M = torch.linalg.qr(randn(k, k))[0].contiguous()
        F, s = lu.getrfnp_cuda(M)
        Fp, sp = lu.getrfnp(M)
        err = float((F - Fp).abs().max())
        umin = float(torch.triu(F).diagonal().abs().min())
        gate(torch.equal(s, sp), f"getrfnp k={k}: sign vectors differ")
        gate(err <= 1e-4, f"getrfnp k={k}: max|dF| {err}")
        gate(umin >= 1 - 1e-5, f"getrfnp k={k}: min|u_jj| {umin}")
        if timed:
            out["getrfnp"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: lu.getrfnp_cuda(M), 20),
                plain_ms=cuda_ms(lambda: lu.getrfnp(M), 3, warmup=1),
                **bound(2 * k ** 3 / 3, 4 * (2 * k * k + k)),
                library_ms=None)
        print(f"[kernel] getrfnp k={k}: same s, max|dF| {err:.3e}, "
              f"min|u_jj| {umin:.6f}", flush=True)
    # K5 qrcp_select_pivots: the HQRRP sketch Y (138, 8192), 128 steps,
    # some columns retired (and a ragged case)
    for d, n, steps, timed in ((138, N, 128, True), (74, 1000, 64, False)):
        Y = spread(d, n)
        live = torch.ones(n, dtype=f32, device=dev)
        retired = torch.randperm(n, generator=g, device=dev)[:n // 8]
        live[retired] = 0.0
        ck = qrcp.qrcp_select_pivots_cuda(Y, steps, live)
        cp = qr.qrcp_select_pivots(Y, steps, live)
        gate(torch.equal(ck, cp), f"qrcp_select_pivots {d}x{n}: pivots "
             "differ from the plain version's")
        gate(not bool(torch.isin(ck, retired).any()),
             "qrcp_select_pivots chose a retired column")
        if timed:
            out["qrcp_select_pivots"] = dict(
                max_abs_err=float((ck - cp).abs().max()),
                ms=cuda_ms(lambda: qrcp.qrcp_select_pivots_cuda(
                    Y, steps, live), 10),
                plain_ms=cuda_ms(lambda: qr.qrcp_select_pivots(
                    Y, steps, live), 2, warmup=1),
                **bound(*select_pivots_work(Y, steps, live)),
                library_ms=None)
        print(f"[kernel] qrcp_select_pivots d={d} n={n} steps={steps} "
              f"({n // 8} retired): pivots equal", flush=True)
    # K6 qrcp_panel: the HQRRP panel (8192, 128) at row0 0 and 4096 (and
    # a ragged case)
    for m, b, r0, timed in ((N, 128, 0, True), (N, 128, 4096, False),
                            (1000, 100, 333, False)):
        P = spread(m, b)
        W, taus, sigma = qrcp.qrcp_panel_cuda(P, r0)
        Wp, _, tp, sp = qr.qrcp_panel(P, r0)
        err = float((W - Wp).abs().max())
        terr = float((taus - tp).abs().max())
        gate(torch.equal(sigma, sp), f"qrcp_panel {m}x{b} row0={r0}: "
             "sigma differs from the plain version's")
        gate(err <= 1e-4 * float(Wp.abs().max()) and terr <= 1e-4,
             f"qrcp_panel {m}x{b} row0={r0}: max|dW| {err}, "
             f"max|dtau| {terr}")
        if timed:
            out["qrcp_panel"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: qrcp.qrcp_panel_cuda(P, r0), 10),
                plain_ms=cuda_ms(lambda: qr.qrcp_panel(P, r0), 2,
                                 warmup=1),
                **bound(*panel_work(m, b, r0, 4)),
                library_ms=None)
        print(f"[kernel] qrcp_panel m={m} b={b} row0={r0}: sigma equal, "
              f"max|dW| {err:.3e} (max|plain| {float(Wp.abs().max()):.3e}),"
              f" max|dtau| {terr:.3e}", flush=True)
    # K4 kernel_matmat: KRILL's operator product at its three shapes, a
    # ragged case at d 17 (two k-steps) and one at d 70, which is past the
    # tensor-core kernel's 32 coordinates and takes the SIMT kernel.
    # Against the plain blocked version, and against the same in f64, where
    # the tensor-core kernel may err at most F64_ERR_FACTOR times as much as
    # the SIMT kernel; the n 65536, s 1 case is the full-size run's and is
    # timed, SIMT and new in turns
    bw = 3.8                     # about the median-heuristic value at d 8
    for d, n, s_, timed in ((8, KRILL_N, 1, True), (8, 8192, 4, False),
                            (8, 8192, 1, False), (17, 1000, 5, False),
                            (70, 1000, 5, False)):
        X, V = randn(d, n), randn(n, s_)
        bw_ = bw * math.sqrt(d / 8)
        before = dict(kernels.LAUNCHES)
        Ko = kernels.kernel_matmat(X, V, bw_)
        gate(kernels.LAUNCHES["kernel_matmat_simt"]
             - before["kernel_matmat_simt"] == int(d > 32),
             f"kernel_matmat d={d}: wrong body")
        Kp = kernels.kernel_matmat_reference(X, V, bw_, block=2048)
        err = float((Ko - Kp).abs().max())
        gate(err <= 1e-4 * float(Kp.abs().max()),
             f"kernel_matmat d={d} n={n} s={s_}: max|d| {err}")
        gate(torch.equal(Ko, kernels.kernel_matmat(X, V, bw_)),
             f"kernel_matmat d={d} n={n} s={s_}: two launches differ")
        ref = kernels.kernel_matmat_reference(X.double(), V.double(), bw_,
                                              block=2048)
        e_new, e_plain = relf(Ko, ref), relf(Kp, ref)
        e_simt = relf(kernels.kernel_matmat_simt(X, V, bw_), ref)
        e_emul = relf(Ko, kernels.kernel_matmat_split_reference(
            X, V, bw_, block=2048).double())
        gate(e_new <= F64_ERR_FACTOR * e_simt,
             f"kernel_matmat d={d} n={n} s={s_}: error against f64 {e_new}, "
             f"the SIMT kernel's {e_simt}")
        # the small shapes take 100 launches a turn: with fewer the host,
        # which launches a call in about 40 us, sets the time and not the card
        ms_simt, ms = in_turns(lambda: kernels.kernel_matmat_simt(X, V, bw_),
                               lambda: kernels.kernel_matmat(X, V, bw_),
                               10 if timed else 100)
        work = kernels.kernel_matmat_work(d, n, s_)
        bnd, old_bnd = bound(**work), earlier_kernel_matmat_bound(work)
        if timed:
            Xd, Vd = X.double(), V.double()
            ms64 = cuda_ms(lambda: kernels.kernel_matmat(Xd, Vd, bw_), 3)
            bnd64 = bound(**kernels.kernel_matmat_work(d, n, s_, 8),
                          f64=True)
            out["kernel_matmat"] = dict(
                max_abs_err=err, ms=ms,
                plain_ms=cuda_ms(lambda: kernels.kernel_matmat_reference(
                    X, V, bw_, block=2048), 2, warmup=1),
                **bnd, library_ms=None, simt_ms=ms_simt,
                earlier_bound_ms=old_bnd["bound_ms"], err_vs_f64=e_new,
                simt_err_vs_f64=e_simt, plain_err_vs_f64=e_plain,
                f64_ms=ms64, f64_bound_ms=bnd64["bound_ms"])
            print(f"[kernel] kernel_matmat f64 d={d} n={n} s={s_} (the SIMT "
                  f"kernel): {ms64:.4f} ms, bound {bnd64['bound_ms']:.4f} ms"
                  f" ({bnd64['bound_by']}: the cross term's 2d n^2 flops at "
                  f"{PEAK_FP64_TENSOR / 1e12:.0f} TFLOP/s, the tensor cores' "
                  f"FP64 peak, and (2s + 6) n^2 at {PEAK_FP64 / 1e12:.0f} "
                  f"TFLOP/s)", flush=True)
            del Xd, Vd
            # the sum over j in 1 to 16 parts: the blocks of the last wave
            split_of = kernels.kernel_matmat_splits
            try:
                sweep = []
                for z in (1, 2, 4, 8, 16):
                    kernels.kernel_matmat_splits = lambda n, s, z=z: z
                    sweep.append((z, cuda_ms(lambda: kernels.kernel_matmat(
                        X, V, bw_), 10)))
            finally:
                kernels.kernel_matmat_splits = split_of
            print(f"[kernel-splits] kernel_matmat d={d} n={n} s={s_}, parts "
                  f"of the sum over j ({-(-n // 256)} blocks each): ms: "
                  + "; ".join(f"{z}: {t:.4f}" for z, t in sweep)
                  + f" (launched: {split_of(n, s_)})", flush=True)
        else:
            us = host_us(lambda: kernels.kernel_matmat(X, V, bw_))
            us_simt = host_us(lambda: kernels.kernel_matmat_simt(X, V, bw_))
            print(f"[kernel-host] kernel_matmat d={d} n={n} s={s_}: the host "
                  f"launches a call in {us:.1f} us, one of the SIMT kernel in "
                  f"{us_simt:.1f} us", flush=True)
        print(f"[kernel] kernel_matmat d={d} n={n} s={s_} ("
              f"{kernels.kernel_matmat_splits(n, s_)} splits of j): max|d| "
              f"{err:.3e} (max|plain| {float(Kp.abs().max()):.3e}); relative "
              f"error against f64: kernel {e_new:.3e}, SIMT {e_simt:.3e}, "
              f"plain f32 {e_plain:.3e}; kernel against the split emulation "
              f"{e_emul:.3e}; two launches bit-equal; kernel {ms:.4f} ms, "
              f"SIMT {ms_simt:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}; earlier count {old_bnd['bound_ms']:.4f} "
              f"ms)", flush=True)
    # K4's diagonal: K(X, X)·I has K_ii = 1, and K is symmetric
    X = randn(8, 1024)
    Kd = kernels.kernel_matmat(X, torch.eye(1024, device=dev), bw)
    derr = float((Kd.diagonal() - 1).abs().max())
    gate(derr <= 1e-6, f"kernel_matmat: max|K_ii - 1| {derr}")
    print(f"[kernel] kernel_matmat of I (1024): max|K_ii - 1| {derr:.3e}, "
          f"max|K - K^T| {float((Kd - Kd.T).abs().max()):.3e}", flush=True)
    # K7 gaussian_sketch: CQRRPT's sketch (d = 1.25 n) of a 131072x2048
    # matrix (timed) and BQRRP's of an 8192x8192 one, against the plain
    # version (the same S, stored) and against the same product in f64,
    # where the kernel may err at most F64_ERR_FACTOR times as much as
    # torch.mm in fp32 on the stored S; the library pair is randn/sqrt(d)
    # and mm: two calls and a stored S of d*m*4 bytes
    for m, n, d, timed in ((SKETCH_M, SKETCH_N, SKETCH_D, True),
                           (N, N, 320, False), (1000, 300, 13, False)):
        A = randn(m, n)
        gate(wy.takes_tensor_cores(A), "K7 operand off the tensor cores")
        So = kernels.gaussian_sketch_cuda(A, d, 11)
        S = kernels.gaussian_sketch_matrix(d, m, 11, f32, dev)
        Sp = S @ A
        err = float((So - Sp).abs().max())
        gate(err <= 1e-4 * float(Sp.abs().max()),
             f"gaussian_sketch {m}x{n} d={d}: max|d| {err}")
        gate(torch.equal(So, kernels.gaussian_sketch_cuda(A, d, 11)),
             f"gaussian_sketch {m}x{n} d={d}: two launches differ")
        ref = S.double() @ A.double()
        e_new, e_lib = relf(So, ref), relf(Sp, ref)
        e_simt = relf(kernels.gaussian_sketch_simt(A, d, 11), ref)
        e_emul = relf(So, wy._three_products(S, A).double())
        gate(e_new <= F64_ERR_FACTOR * e_lib,
             f"gaussian_sketch {m}x{n} d={d}: error against f64 {e_new}, "
             f"torch.mm's {e_lib}")
        sweep = ([(c, relf(kernels.gaussian_sketch_cuda(A, d, 11, chunk=c),
                           ref),
                   cuda_ms(lambda: kernels.gaussian_sketch_cuda(
                       A, d, 11, chunk=c), 2, warmup=1))
                  for c in (1, 2, 4, 16, 0)] if timed else [])
        del So, Sp, S, ref
        ms_simt, ms = in_turns(
            lambda: kernels.gaussian_sketch_simt(A, d, 11),
            lambda: kernels.gaussian_sketch_cuda(A, d, 11), 3)
        bnd = bound(2 * d * m * n, 4 * (m * n + d * n), tensor=True)
        old_bnd = bound(2 * d * m * n, 4 * (m * n + d * n))

        def library():
            return torch.mm(torch.randn((d, m), generator=g, device=dev)
                            / math.sqrt(d), A)
        lib_ms = cuda_ms(library, 3, warmup=1)
        if timed:
            out["gaussian_sketch"] = dict(
                max_abs_err=err, ms=ms,
                plain_ms=cuda_ms(lambda: kernels.gaussian_sketch_reference(
                    A, d, 11), 1, warmup=0),
                **bnd, library_ms=lib_ms,
                library_call="torch.randn((d, m))/sqrt(d) then torch.mm: "
                "two calls and S stored, another stream",
                simt_ms=ms_simt, earlier_bound_ms=old_bnd["bound_ms"],
                err_vs_f64=e_new, simt_err_vs_f64=e_simt,
                library_err_vs_f64=e_lib)
            print(f"[kernel-chunk] gaussian_sketch m={m} n={n} d={d}, stages"
                  f" of 32 per chunk (0: one chunk): error against f64, ms: "
                  + "; ".join(f"{c}: {e:.3e}, {t:.4f}" for c, e, t in sweep)
                  + f" (default {wy.CHUNK})", flush=True)
        print(f"[kernel] gaussian_sketch m={m} n={n} d={d}: max|d| {err:.3e}"
              f"; relative error against f64: kernel {e_new:.3e}, SIMT "
              f"{e_simt:.3e}, torch.mm fp32 on the stored S {e_lib:.3e}; "
              f"kernel against the three-product emulation {e_emul:.3e}; two"
              f" launches bit-equal; kernel {ms:.4f} ms, SIMT {ms_simt:.4f} "
              f"ms, bound {bnd['bound_ms']:.4f} ms (by FFMA "
              f"{old_bnd['bound_ms']:.4f} ms), randn+mm {lib_ms:.4f} ms",
              flush=True)
        del A
    # K7 on the identity: out is S itself, from either kernel
    S5 = kernels.gaussian_sketch_matrix(512, 512, 5, f32, dev)
    eye = torch.eye(512, device=dev)
    err = float((kernels.gaussian_sketch_cuda(eye, 512, 5) - S5).abs().max())
    err_simt = float((kernels.gaussian_sketch_simt(eye, 512, 5) - S5
                      ).abs().max())
    gate(err <= 1e-6 and err_simt <= 1e-6,
         f"gaussian_sketch of I: max|dS| {err}, SIMT {err_simt}")
    print(f"[kernel] gaussian_sketch of I (512): max|dS| {err:.3e} against "
          f"the plain S (SIMT kernel {err_simt:.3e})", flush=True)
    for name, rec in out.items():
        lib = ("" if rec["library_ms"] is None else
               f", library {rec['library_ms']:.3f} ms "
               f"({rec['library_call']})")
        old = (f", earlier SIMT kernel {rec['simt_ms']:.4f} ms"
               if "simt_ms" in rec else "")
        print(f"[kernel-time] {name}: kernel {rec['ms']:.4f} ms{old}, plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}){lib}", flush=True)
    return out


def quality(A, fac):
    from randlapack_tpu_torch.drivers import bqrrp_q
    Q = bqrrp_q(fac)
    K = Q.shape[1]
    res = float(torch.linalg.norm(Q @ fac.R - A[:, fac.J])
                / torch.linalg.norm(A))
    orth = float(torch.linalg.norm(
        Q.T @ Q - torch.eye(K, dtype=Q.dtype, device=Q.device)))
    return Q, res, orth


def phase_main(dev, card: str) -> dict:
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import BQRRPConfig, bqrrp_factored
    from randlapack_tpu_torch.gen import fast_decay_matrix
    cfg = BQRRPConfig(block_size=256, pivot_candidates=2, stages=2,
                      update_defer=4)
    A, st = fast_decay_matrix(N, N, RNGState(0), device=dev)
    fac, _ = bqrrp_factored(A, cfg, st)            # warm-up
    times, counts = [], None
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        reset_counts()
        start.record()
        fac, _ = bqrrp_factored(A, cfg, st)
        end.record()
        torch.cuda.synchronize()
        counts = read_counts()
        gate(counts == EXPECTED_LAUNCHES,
             f"launches per factorization {counts} != {EXPECTED_LAUNCHES}")
        times.append(start.elapsed_time(end) / 1e3)
    t0 = time.perf_counter()
    Q, res, orth = quality(A, fac)
    torch.cuda.synchronize()
    tq = time.perf_counter() - t0
    t = min(times)
    gflops = 4.0 / 3.0 * N ** 3 / t / 1e9
    fail = bool(fac.fail)
    print(f"[main] bqrrp_factored {N}x{N} f32 b256/pc2/stages2/defer4 on "
          f"{card}: runs {[round(x, 4) for x in times]} s, best {t:.4f} s "
          f"= {gflops:.1f} GFLOP/s (4/3 n^3); bqrrp_q + checks {tq:.3f} s; "
          f"residual {res:.3e} (gate {RES_GATE:.2e}), orth {orth:.3e} "
          f"(gate {ORTH_GATE:.2e}), fail {fail}, rank {int(fac.rank)}, "
          f"launches/factorization {counts}", flush=True)
    gate(tuple(Q.shape) == (N, N) and tuple(fac.R.shape) == (N, N),
         "output shapes")
    gate(bool(torch.isfinite(Q).all() and torch.isfinite(fac.R).all()),
         "non-finite output")
    gate(torch.equal(torch.sort(fac.J).values,
                     torch.arange(N, device=dev)), "J is not a permutation")
    gate(res <= RES_GATE, f"residual {res}")
    gate(orth <= ORTH_GATE, f"orthogonality {orth}")
    gate(not fail, "fail flag raised")

    _, _, phases = bqrrp_factored(A, cfg, st, timing=True)
    print("[main-phases] " + ", ".join(f"{k} {v:.4f} s"
                                       for k, v in phases.items()),
          flush=True)
    return counts


def phase_old_vs_new(dev) -> None:
    """The 8192x8192 factorization with K1/K2 pointed at their earlier
    SIMT kernels and at the tensor-core ones: best-of-2 times in turns
    (old, new, new, old), then each under torch.profiler (wall time, the
    card's busy time, K1's and K2's share), with residual, orthogonality
    and whether both give the same J."""
    from pathlib import Path
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import BQRRPConfig, bqrrp_factored
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.ops import wy
    cfg = BQRRPConfig(block_size=256, pivot_candidates=2, stages=2,
                      update_defer=4)
    A, st = fast_decay_matrix(N, N, RNGState(0), device=dev)
    bodies = {"new": (wy.masked_vt_a, wy.a_minus_vz_masked),
              "simt": (wy.masked_vt_a_simt, wy.a_minus_vz_masked_simt)}
    expected = {
        "new": EXPECTED_LAUNCHES,
        "simt": {**EXPECTED_LAUNCHES, "masked_vt_a": 0,
                 "a_minus_vz_masked": 0, "masked_vt_a_simt": 32,
                 "a_minus_vz_masked_simt": 8}}

    def with_bodies(which, fn):
        try:
            wy.masked_vt_a, wy.a_minus_vz_masked = bodies[which]
            return fn()
        finally:
            wy.masked_vt_a, wy.a_minus_vz_masked = bodies["new"]

    def best_of_2(which):
        def run():
            bqrrp_factored(A, cfg, st)
            times = []
            for _ in range(2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                reset_counts()
                start.record()
                bqrrp_factored(A, cfg, st)
                end.record()
                torch.cuda.synchronize()
                gate(read_counts() == expected[which],
                     f"launches with the {which} kernels {read_counts()}")
                times.append(start.elapsed_time(end) / 1e3)
            return min(times)
        return with_bodies(which, run)

    turns = [(which, best_of_2(which))
             for which in ("simt", "new", "new", "simt")]
    print("[old-vs-new] bqrrp_factored 8192x8192 f32, best of 2, in turns: "
          + ", ".join(f"{which} {t:.4f} s" for which, t in turns),
          flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    facs = {}
    # under the profiler, once each
    for which in ("simt", "new"):
        (fac, _), wall, rows = with_bodies(which, lambda: device_profile(
            lambda: bqrrp_factored(A, cfg, st)))
        if which not in facs or wall < facs[which][1]:
            facs[which] = (fac, wall, rows)
    for which, (fac, wall, rows) in facs.items():
        busy = sum(ms for _, ms, _ in rows)
        gate(busy > 0, "the profiler saw no device time")
        k1 = sum(ms for key, ms, _ in rows if "wy_tc_kernel<true>" in key
                 or "wy_tc_kernel<(bool)1>" in key or "add_parts" in key
                 or "masked_vt_a_kernel" in key)
        k2 = sum(ms for key, ms, _ in rows if "wy_tc_kernel<false>" in key
                 or "wy_tc_kernel<(bool)0>" in key
                 or "a_minus_vz_masked_kernel" in key)
        gate(k1 > 0 and k2 > 0, f"K1/K2 not found in the profile: "
             f"{[key for key, _, _ in rows[:12]]}")
        (out / f"bqrrp_profile_{which}.txt").write_text(
            f"wall {wall:.4f} s, device {busy:.1f} ms, "
            f"{sum(c for *_, c in rows)} launches\n" + "\n".join(
                f"{ms:10.3f} ms {cnt:7d}  {key}" for key, ms, cnt in rows))
        _, res, orth = quality(A, fac)
        print(f"[old-vs-new] {which} under the profiler: "
              f"wall {wall:.4f} s, card busy {busy:.1f} ms "
              f"({100 * busy / 1e3 / wall:.1f} %, idle "
              f"{100 - 100 * busy / 1e3 / wall:.1f} %) in "
              f"{sum(c for *_, c in rows)} launches, K1 {k1:.1f} ms, K2 "
              f"{k2:.1f} ms; residual {res:.3e}, orth {orth:.3e}, fail "
              f"{bool(fac.fail)}; top: " + "; ".join(
                  f"{key[:48]} {ms:.1f} ms/{cnt}"
                  for key, ms, cnt in rows[:10]), flush=True)
        gate(res <= RES_GATE and orth <= ORTH_GATE and not bool(fac.fail),
             f"quality with the {which} kernels")
    fs, fn = facs["simt"][0], facs["new"][0]
    same = torch.equal(fs.J, fn.J)
    dR = float((fs.R - fn.R).abs().max() / fn.R.abs().max())
    print(f"[old-vs-new] J equal between the two: {same}; rel max|dR| "
          f"{dR:.3e}", flush=True)


def phase_remainder(dev) -> None:
    """A 3000x2000 f32 run: 7 full blocks plus a 208-wide remainder."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import BQRRPConfig, bqrrp_factored
    from randlapack_tpu_torch.gen import fast_decay_matrix
    cfg = BQRRPConfig(block_size=256, pivot_candidates=2, stages=2,
                      update_defer=4)
    A, st = fast_decay_matrix(3000, 2000, RNGState(1), device=dev)
    fac, _ = bqrrp_factored(A, cfg, st)
    _, res, orth = quality(A, fac)
    og = 10 * EPS32 ** 0.75 * math.sqrt(2000)
    print(f"[remainder] 3000x2000 f32: residual {res:.3e} (gate "
          f"{RES_GATE:.2e}), orth {orth:.3e} (gate {og:.2e}), fail "
          f"{bool(fac.fail)}", flush=True)
    gate(res <= RES_GATE and orth <= og and not bool(fac.fail),
         "remainder run quality")


def phase_small_vs_plain(dev) -> None:
    """Kernel path on the card against the plain path on the CPU, f64,
    same injected sketch: same pivots, same factors."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import (BQRRPConfig, bqrrp_factored,
                                              bqrrp_q)
    g = torch.Generator().manual_seed(3)
    A = torch.randn(640, 512, generator=g, dtype=torch.float64) \
        * torch.logspace(0, -6, 512, dtype=torch.float64)
    S = torch.randn(80, 640, generator=g, dtype=torch.float64) / math.sqrt(80)
    cfg = BQRRPConfig(block_size=64, pivot_candidates=2, stages=2,
                      update_defer=4)
    fg, _ = bqrrp_factored(A.to(dev), cfg, RNGState(0), sketch=S.to(dev))
    fc, _ = bqrrp_factored(A, cfg, RNGState(0), sketch=S)
    dR = float((fg.R.cpu() - fc.R).abs().max() / fc.R.abs().max())
    dQ = float((bqrrp_q(fg).cpu() - bqrrp_q(fc)).abs().max())
    same_j = torch.equal(fg.J.cpu(), fc.J)
    print(f"[small-vs-plain] 640x512 f64 card vs CPU: J equal {same_j}, "
          f"rel max|dR| {dR:.3e}, max|dQ| {dQ:.3e}", flush=True)
    gate(same_j and dR <= 1e-10 and dQ <= 1e-10, "card path vs plain path")


def hqrrp_quality(A, packed, taus, R, J):
    from randlapack_tpu_torch.ops.householder import apply_reflectors
    Q = apply_reflectors(packed, taus)
    K = Q.shape[1]
    res = float(torch.linalg.norm(Q @ R - A[:, J]) / torch.linalg.norm(A))
    orth = float(torch.linalg.norm(
        Q.T @ Q - torch.eye(K, dtype=Q.dtype, device=Q.device)))
    return Q, res, orth


def phase_hqrrp(dev, card: str) -> dict:
    """HQRRP's main path: bench.py's config 6 through
    hqrrp_lapack_format, a warm-up and 2 timed runs, then Q from the
    packed reflectors."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import HQRRPConfig, hqrrp_lapack_format
    from randlapack_tpu_torch.gen import fast_decay_matrix
    cfg = HQRRPConfig(block_size=128, update_defer=4)
    A, st = fast_decay_matrix(N, N, RNGState(7), device=dev)
    out = hqrrp_lapack_format(A, cfg, st)              # warm-up
    times, counts = [], None
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        reset_counts()
        start.record()
        out = hqrrp_lapack_format(A, cfg, st)
        end.record()
        torch.cuda.synchronize()
        counts = read_counts()
        gate(counts == HQRRP_LAUNCHES,
             f"launches per factorization {counts} != {HQRRP_LAUNCHES}")
        times.append(start.elapsed_time(end) / 1e3)
    packed, taus, R, J, _ = out
    t0 = time.perf_counter()
    Q, res, orth = hqrrp_quality(A, packed, taus, R, J)
    torch.cuda.synchronize()
    tq = time.perf_counter() - t0
    t = min(times)
    print(f"[hqrrp] hqrrp_lapack_format {N}x{N} f32 b128/defer4 on {card}: "
          f"runs {[round(x, 4) for x in times]} s, best {t:.4f} s = "
          f"{4.0 / 3.0 * N ** 3 / t / 1e9:.1f} GFLOP/s (4/3 n^3); Q + checks"
          f" {tq:.3f} s; residual {res:.3e} (gate {RES_GATE:.2e}), orth "
          f"{orth:.3e} (gate {ORTH_GATE:.2e}), launches/factorization "
          f"{counts}", flush=True)
    gate(tuple(Q.shape) == (N, N) and tuple(R.shape) == (N, N),
         "output shapes")
    gate(bool(torch.isfinite(Q).all() and torch.isfinite(R).all()),
         "non-finite output")
    gate(torch.equal(torch.sort(J).values, torch.arange(N, device=dev)),
         "J is not a permutation")
    gate(res <= RES_GATE, f"residual {res}")
    gate(orth <= ORTH_GATE, f"orthogonality {orth}")
    return counts


def phase_hqrrp_phases(dev) -> None:
    """hqrrp (which also returns ``fail``) through the kernels, then a
    timing=True phase breakdown; a CUDA tensor refuses the plain route
    ("never")."""
    import warnings
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import HQRRPConfig, hqrrp
    from randlapack_tpu_torch.gen import fast_decay_matrix
    A, st = fast_decay_matrix(N, N, RNGState(7), device=dev)
    cfg = HQRRPConfig(block_size=128, update_defer=4)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    Q, R, J, rank, fail, _ = hqrrp(A, cfg, st)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    res = float(torch.linalg.norm(Q @ R - A[:, J]) / torch.linalg.norm(A))
    gate(not bool(fail), "hqrrp: fail flag raised")
    gate(res <= RES_GATE, f"hqrrp: residual {res}")
    gate(counts["qrcp_select_pivots"] == counts["qrcp_panel"] == 64,
         f"hqrrp: launches {counts}")
    print(f"[hqrrp-q] hqrrp {N}x{N} f32: {secs:.4f} s (host clock, explicit"
          f" Q included), residual {res:.3e}, fail {bool(fail)}, rank "
          f"{int(rank)}, K5/K6 launches {counts['qrcp_select_pivots']}/"
          f"{counts['qrcp_panel']}", flush=True)
    try:
        hqrrp(A, HQRRPConfig(block_size=128, pallas_qrcp="never",
                             pallas_panel="never"), st)
        refused = False
    except NotImplementedError:
        refused = True
    gate(refused, "a CUDA tensor took the plain route")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # timing=True runs eager blocks
        *_, phases = hqrrp(A, HQRRPConfig(block_size=128, update_defer=4),
                           st, timing=True)
    print("[hqrrp-phases] (eager blocks) " + ", ".join(
        f"{k} {v:.4f} s" for k, v in phases.items()), flush=True)


def phase_hqrrp_cholqr(dev) -> None:
    """CholQR panels at 3000x2000 on the card: 15 full blocks of 128 and
    an 80-wide remainder, each panel through orhr_col and so K3."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import HQRRPConfig, PanelQR, hqrrp
    from randlapack_tpu_torch.gen import fast_decay_matrix
    A, st = fast_decay_matrix(3000, 2000, RNGState(1), device=dev)
    reset_counts()
    Q, R, J, _, fail, _ = hqrrp(
        A, HQRRPConfig(block_size=128, panel_qr=PanelQR.cholqr), st)
    torch.cuda.synchronize()
    counts = read_counts()
    res = float(torch.linalg.norm(Q @ R - A[:, J]) / torch.linalg.norm(A))
    orth = float(torch.linalg.norm(
        Q.T @ Q - torch.eye(2000, dtype=Q.dtype, device=dev)))
    og = 10 * EPS32 ** 0.75 * math.sqrt(2000)
    print(f"[hqrrp-cholqr] 3000x2000 f32 cholqr panels: residual {res:.3e}"
          f" (gate {RES_GATE:.2e}), orth {orth:.3e} (gate {og:.2e}), fail "
          f"{bool(fail)}, launches {counts}", flush=True)
    gate(res <= RES_GATE and orth <= og and not bool(fail),
         "cholqr-panel run quality")
    gate(counts["getrfnp"] == 16 and counts["qrcp_select_pivots"] == 16
         and counts["qrcp_panel"] == 0, f"cholqr-panel launches {counts}")


def phase_hqrrp_small_vs_plain(dev) -> None:
    """HQRRP through the kernels on the card against the plain versions on
    the CPU, f64, same injected sketch operator: same pivots, same
    factors."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import HQRRPConfig, hqrrp_lapack_format
    g = torch.Generator().manual_seed(4)
    A = torch.randn(640, 512, generator=g, dtype=torch.float64) \
        * torch.logspace(0, -6, 512, dtype=torch.float64)
    G = 2 * torch.rand(74, 640, generator=g, dtype=torch.float64) - 1
    cfg = HQRRPConfig(block_size=64, update_defer=4)
    reset_counts()
    pg, tg, Rg, Jg, _ = hqrrp_lapack_format(A.to(dev), cfg, RNGState(0),
                                            sketch=G.to(dev))
    torch.cuda.synchronize()
    counts = read_counts()
    pc, tc, Rc, Jc, _ = hqrrp_lapack_format(A, cfg, RNGState(0), sketch=G)
    dR = float((Rg.cpu() - Rc).abs().max() / Rc.abs().max())
    dP = float((pg.cpu() - pc).abs().max() / pc.abs().max())
    same_j = torch.equal(Jg.cpu(), Jc)
    print(f"[hqrrp-small-vs-plain] 640x512 f64 card vs CPU: J equal "
          f"{same_j}, rel max|dR| {dR:.3e}, rel max|dpacked| {dP:.3e}, "
          f"card launches K5/K6 {counts['qrcp_select_pivots']}/"
          f"{counts['qrcp_panel']}", flush=True)
    gate(same_j and dR <= 1e-10 and dP <= 1e-10,
         "HQRRP card path vs plain path")
    gate(counts["qrcp_select_pivots"] == counts["qrcp_panel"] == 8,
         f"small run launches {counts}")


def krill_problem(n, s, mus, dev, dtype=torch.float32, seed=11):
    """bench.py's KRILL recipe: n standardized Gaussian points in 8
    dimensions, the bandwidth by the median heuristic on the first 256,
    Gaussian right-hand sides."""
    from randlapack_tpu_torch.pdkernels import (SquaredExpKernelLinOp,
                                                standardize_dataset)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    # drawn in f32 and then cast, so an f64 run solves the f32 run's system
    X = standardize_dataset(torch.randn((8, n), generator=g,
                                        device=dev).to(dtype))
    sub = X[:, :256]
    d2 = ((sub[:, :, None] - sub[:, None, :]) ** 2).sum(0)
    bw = float(torch.sqrt(torch.median(d2[d2 > 0])))
    H = torch.randn((n, s), generator=g, device=dev).to(dtype)
    return SquaredExpKernelLinOp(X, bw, mus, block=2048), H


def krill_run(tag, G, H, mus, k, max_iters, true_gate=None):
    """One krill_full_rpchol solve with the launch counts set to 0 before
    and read after; gates on convergence (PCG's own recursive residual),
    the launch counts and the true residual r = (K + μI)x − h, from one
    more kernel product made after the counts are read. In f32 the true
    residual is held to what f32 arithmetic can give — the normwise
    backward error |r| / (|K + μI|·|x|) at most one unit roundoff, with
    |K|₂ bounded below by |K·e|/|e| — because cond(K + μI)·eps32 is
    0.03–0.3 at these sizes; ``true_gate`` (the f64 run) holds |r|/|h|
    itself. Returns (counts, iters, seconds)."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import PCGConfig
    from randlapack_tpu_torch.drivers import KrillConfig, krill_full_rpchol
    cfg = KrillConfig(k=k, rpchol_block=64,
                      pcg=PCGConfig(tol=1e-5, max_iters=max_iters))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    Xs, hist, iters, _ = krill_full_rpchol(G, H, mus, cfg, RNGState(6))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    hist = hist.cpu()
    if iters >= max_iters:
        print(f"[{tag}] residual history: "
              f"{[f'{v:.2e}' for v in hist[:, 0].tolist()]}", flush=True)
    gate(iters < max_iters, f"{tag}: PCG did not converge in {max_iters}")
    gate(counts == {**NO_LAUNCHES, "kernel_matmat": iters + 1},
         f"{tag}: launches {counts} for {iters} iterations")
    final = (hist[iters] / hist[0]).tolist()
    gate(max(final) <= 1e-5, f"{tag}: recursive residual {final}")
    gate(bool(torch.isfinite(Xs).all()) and Xs.shape == H.shape,
         f"{tag}: solution shape or values")
    res = torch.linalg.norm(G.matmat(Xs) - H, dim=0)
    true = (res / torch.linalg.norm(H, dim=0)).tolist()
    ones = torch.ones((G.dim, 1), dtype=H.dtype, device=H.device)
    nrm_K = float(torch.linalg.norm(G.with_reg(False).matmat(ones))
                  / math.sqrt(G.dim))
    eps = float(torch.finfo(H.dtype).eps)
    backward = (res / ((nrm_K + G.mus.expand(H.shape[1]))
                       * torch.linalg.norm(Xs, dim=0)) / eps).tolist()
    if true_gate is None:
        gate(max(backward) <= 1.0, f"{tag}: backward error {backward} eps")
    else:
        gate(max(true) <= true_gate, f"{tag}: true residual {true}")
    print(f"[{tag}] krill_full_rpchol n={G.dim} d=8 s={H.shape[1]} "
          f"{str(H.dtype)[6:]} k={k} bandwidth {G.bandwidth:.3f}: {secs:.4f}"
          f" s, {iters} iterations, recursive residual "
          f"{[f'{v:.2e}' for v in final]}, true residual "
          f"{[f'{v:.2e}' for v in true]} = backward error "
          f"{[f'{v:.3f}' for v in backward]} eps (|K|_2 >= {nrm_K:.1f}), K4 "
          f"launches {counts['kernel_matmat']}", flush=True)
    return counts, iters, secs


def pcg_anatomy(tag, G, H, mus, k, max_iters) -> None:
    """Where a KRILL solve's time goes: the RPCholesky factor, its SVD by
    both routes (time and the orthogonality of U, which the spectral
    preconditioner rests on), then PCG on the host clock and under
    torch.profiler (the card's busy share of PCG's wall time, and K4's
    share of that). Last, what the two alternatives to the configuration
    give: PCG with the Gram/eigh route's preconditioner, and the residual
    trace of an RPCholesky factor of twice the rank."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import (PCGConfig, RPCholConfig, pcg,
                                            rp_cholesky)
    from randlapack_tpu_torch.linops import SpectralPrecond
    from randlapack_tpu_torch.ops.svd import svd_econ

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def orth(U):
        return float(torch.linalg.norm(U.T @ U - torch.eye(
            U.shape[1], dtype=U.dtype, device=U.device)))

    (F, _, _), t_chol = timed(lambda: rp_cholesky(
        G.with_reg(False), k, RPCholConfig(block_size=64), RNGState(6)))
    svd_econ(F[:4096], "gram_eigh"), svd_econ(F[:4096], "xla")   # warm up
    (Ug, sig_g, _), t_gram = timed(lambda: svd_econ(F, "gram_eigh"))
    (V, sig, _), t_xla = timed(lambda: svd_econ(F, "xla"))
    P = SpectralPrecond.prep(V, sig * sig, mus)
    cfg = PCGConfig(tol=1e-5, max_iters=max_iters)
    X0 = torch.zeros_like(H)
    (_, _, iters), t_pcg = timed(lambda: pcg(G, H, P, X0, cfg))
    _, t_prof, rows = device_profile(lambda: pcg(G, H, P, X0, cfg))
    busy = sum(ms for _, ms, _ in rows)
    pack = sum(ms for key, ms, _ in rows if "pack_kernel" in key)
    k4 = pack + sum(ms for key, ms, _ in rows if "kernel_matmat" in key
                    or "add_splits" in key)
    gate(busy > 0, f"{tag}: the profiler saw no device time")
    print(f"[{tag}] rp_cholesky {t_chol:.4f} s; svd_econ of F "
          f"{tuple(F.shape)}: torch.linalg.svd {t_xla:.4f} s (|UtU-I|_F "
          f"{orth(V):.2e}, sigma {float(sig[0]):.3e}..{float(sig[-1]):.3e}),"
          f" gram_eigh {t_gram:.4f} s (|UtU-I|_F {orth(Ug):.2e}); pcg "
          f"{t_pcg:.4f} s for {iters} iterations = "
          f"{1e3 * t_pcg / max(iters, 1):.3f} ms each (host clock); under "
          f"the profiler {t_prof:.4f} s, {sum(c for *_, c in rows)} device "
          f"launches, the card busy {busy:.2f} ms "
          f"({100 * busy / 1e3 / t_prof:.1f} %, idle "
          f"{100 - 100 * busy / 1e3 / t_prof:.1f} %), K4 {k4:.2f} ms "
          f"({100 * k4 / busy:.1f} % of busy; its prologue, which scales, "
          f"splits and packs X and V anew each launch, {pack:.3f} ms of "
          f"that)", flush=True)
    _, hist_g, it_g = pcg(G, H, SpectralPrecond.prep(Ug, sig_g * sig_g, mus),
                          X0, cfg)
    F2, _, _ = rp_cholesky(G.with_reg(False), 2 * k,
                           RPCholConfig(block_size=64), RNGState(6))
    print(f"[{tag}] alternatives: with gram_eigh's preconditioner pcg ran "
          f"{it_g} iterations to a recursive residual "
          f"{float(hist_g[it_g, 0] / hist_g[0, 0]):.2e}; trace of K - F F^T "
          f"at rank {k}: {float((1 - (F * F).sum(1)).sum()):.3e}, at rank "
          f"{2 * k}: {float((1 - (F2 * F2).sum(1)).sum()):.3e}", flush=True)


def phase_krill(dev) -> dict:
    """KRILL's runs — full size, bench.py's own size and per-column μ,
    each in f32 and in f64 — then the card against the CPU."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import KrillConfig, krill_full_rpchol
    mu = 1e-2
    for dtype in (torch.float32, torch.float64):           # warm-up
        Gw, Hw = krill_problem(2048, 1, mu, dev, dtype)
        krill_full_rpchol(Gw, Hw, mu, KrillConfig(k=128), RNGState(0))
    G, H = krill_problem(KRILL_N, 1, mu, dev)
    counts, _, _ = krill_run("krill", G, H, mu, KRILL_K, 200)
    pcg_anatomy("krill-phases", G, H, mu, KRILL_K, 200)
    # the same solve in f64, where the true residual can follow PCG's
    krill_run("krill-f64", *krill_problem(KRILL_N, 1, mu, dev, torch.float64),
              mu, KRILL_K, 200, true_gate=1e-4)
    G, H = krill_problem(8192, 1, mu, dev)
    krill_run("krill-8192", G, H, mu, 256, 100)
    pcg_anatomy("krill-8192-phases", G, H, mu, 256, 100)
    mus = [1e-1, 1e-2, 1e-2, 1e-3]
    krill_run("krill-4mu", *krill_problem(8192, 4, mus, dev), mus, 512, 200)
    f64 = torch.float64
    krill_run("krill-8192-f64", *krill_problem(8192, 1, mu, dev, f64), mu,
              256, 100, true_gate=1e-4)
    krill_run("krill-4mu-f64", *krill_problem(8192, 4, mus, dev, f64), mus,
              512, 200, true_gate=1e-4)
    phase_krill_small_vs_plain(dev)
    return counts


def phase_krill_small_vs_plain(dev) -> None:
    """KRILL through K4 on the card against the plain versions on the CPU,
    f64, one injected noise tensor: same pivots, same solution."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import PCGConfig, RPCholConfig, rp_cholesky
    from randlapack_tpu_torch.drivers import KrillConfig, krill_full_rpchol
    from randlapack_tpu_torch.pdkernels import SquaredExpKernelLinOp
    n, k, b = 1024, 128, 32
    Gc, Hc = krill_problem(n, 2, 1e-2, "cpu", torch.float64)
    Gg = SquaredExpKernelLinOp(Gc.X.to(dev), Gc.bandwidth, 1e-2)
    g = torch.Generator().manual_seed(8)
    noise = -torch.log(torch.empty((k // b, n), dtype=torch.float64)
                       .exponential_(generator=g))
    cfg = KrillConfig(k=k, rpchol_block=b,
                      pcg=PCGConfig(tol=1e-10, max_iters=300))
    _, pc, _ = rp_cholesky(Gc.with_reg(False), k, RPCholConfig(b),
                           RNGState(0), noise=noise)
    _, pg, _ = rp_cholesky(Gg.with_reg(False), k, RPCholConfig(b),
                           RNGState(0), noise=noise)
    reset_counts()
    Xg, _, ig, _ = krill_full_rpchol(Gg, Hc.to(dev), 1e-2, cfg, RNGState(0),
                                     noise=noise)
    torch.cuda.synchronize()
    counts = read_counts()
    Xc, _, ic, _ = krill_full_rpchol(Gc, Hc, 1e-2, cfg, RNGState(0),
                                     noise=noise)
    dX = float((Xg.cpu() - Xc).abs().max() / Xc.abs().max())
    same = torch.equal(pg.cpu(), pc)
    print(f"[krill-small-vs-plain] n={n} f64 card vs CPU: pivots equal "
          f"{same}, iterations {ig}/{ic}, rel max|dX| {dX:.3e}, card K4 "
          f"launches {counts['kernel_matmat']}", flush=True)
    gate(same and dX <= 1e-8, "KRILL card path vs plain path")
    gate(counts == {**NO_LAUNCHES, "kernel_matmat": ig + 1},
         f"small KRILL run launches {counts}")


def phase_sketch(dev) -> dict:
    """The fused Gaussian sketch through its entry point, at CQRRPT's
    sketch size on a 131072x2048 f32 matrix."""
    from randlapack_tpu_torch import ops
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    A = torch.randn((SKETCH_M, SKETCH_N), generator=g, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = ops.gaussian_sketch(A, SKETCH_D, 11)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    ratio = float(torch.linalg.norm(out) / torch.linalg.norm(A))
    again = torch.equal(out, ops.gaussian_sketch(A, SKETCH_D, 11))
    other = torch.allclose(out, ops.gaussian_sketch(A, SKETCH_D, 12))
    # S·Q for an orthonormal basis Q of 256 columns of A, A = QR: a
    # sketch of d rows distorts a 256-dimensional space by ~ sqrt(256/d)
    R = torch.linalg.qr(A[:, :256], mode="r")[1]
    sv = torch.linalg.svdvals(torch.linalg.solve_triangular(
        R, out[:, :256], upper=True, left=False))
    print(f"[sketch] gaussian_sketch {SKETCH_M}x{SKETCH_N} f32 to d="
          f"{SKETCH_D}: {secs:.4f} s, |SA|_F/|A|_F {ratio:.4f}, two runs "
          f"bit-equal {again}, another seed equal {other}, singular values "
          f"of S·Q (256 columns) in [{float(sv.min()):.3f}, "
          f"{float(sv.max()):.3f}], launches {counts}", flush=True)
    gate(tuple(out.shape) == (SKETCH_D, SKETCH_N)
         and bool(torch.isfinite(out).all()), "sketch shape or values")
    gate(abs(ratio - 1.0) < 0.1, f"sketch norm ratio {ratio}")
    gate(again and not other, "sketch determinism")
    gate(0.5 < float(sv.min()) and float(sv.max()) < 1.5,
         "sketch is not a subspace embedding")
    gate(counts == {**NO_LAUNCHES, "gaussian_sketch": 1},
         f"sketch launches {counts}")
    return counts


def krill_in_turns(dev, n, s, mus, k, reps) -> None:
    """One KRILL problem solved with K4 pointed at its earlier SIMT kernel
    and at the tensor-core one, in turns (old, new, new, old), the best of
    ``reps`` solves each; every solve is gated on its launch counts (one
    body only) and on convergence."""
    from randlapack_tpu_torch import RNGState, pdkernels
    from randlapack_tpu_torch.comps import PCGConfig
    from randlapack_tpu_torch.drivers import KrillConfig, krill_full_rpchol
    from randlapack_tpu_torch.ops import kernels
    G, H = krill_problem(n, s, mus, dev)
    cfg = KrillConfig(k=k, rpchol_block=64,
                      pcg=PCGConfig(tol=1e-5, max_iters=200))
    k4 = {"new": kernels.kernel_matmat, "simt": kernels.kernel_matmat_simt}

    def solve(which):
        best = None
        for _ in range(reps):
            try:
                pdkernels.kernel_matmat = k4[which]
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                Xs, hist, iters, _ = krill_full_rpchol(G, H, mus, cfg,
                                                       RNGState(6))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = read_counts()
            finally:
                pdkernels.kernel_matmat = k4["new"]
            name = "kernel_matmat" + ("" if which == "new" else "_simt")
            gate(counts == {**NO_LAUNCHES, name: iters + 1},
                 f"KRILL with the {which} K4: launches {counts}")
            final = float((hist[iters] / hist[0]).max())
            gate(iters < 200 and final <= 1e-5,
                 f"KRILL with the {which} K4: {iters} iterations, {final}")
            best = secs if best is None else min(best, secs)
        return best, iters, Xs

    solve("new")                                           # warm-up
    runs = [(which, *solve(which)) for which in ("simt", "new", "new", "simt")]
    dX = float(torch.linalg.norm(runs[0][3] - runs[1][3])
               / torch.linalg.norm(runs[0][3]))
    print(f"[old-vs-new] krill_full_rpchol n={n} s={s} k={k} f32, K4 in "
          f"turns, best of {reps}: "
          + ", ".join(f"{which} {secs:.4f} s/{iters} iterations"
                      for which, secs, iters, _ in runs)
          + f"; relative difference of the two solutions {dX:.3e}",
          flush=True)


def phase_k4_k7_old_vs_new(dev) -> None:
    """The KRILL solves (n 65536, and the host-paced n 8192 ones with one
    and with four right-hand sides) and the 131072x2048 sketch through
    their entry points with K4/K7 pointed at their earlier SIMT kernels
    and at the tensor-core ones, in turns (old, new, new, old) within this
    one call; every run is gated on its launch counts (one body only) and
    on the path's own checks."""
    from randlapack_tpu_torch import ops
    from randlapack_tpu_torch.ops import kernels
    krill_in_turns(dev, KRILL_N, 1, 1e-2, KRILL_K, 1)
    krill_in_turns(dev, 8192, 1, 1e-2, 256, 3)
    krill_in_turns(dev, 8192, 4, [1e-1, 1e-2, 1e-2, 1e-3], 512, 3)

    g = torch.Generator(device=dev)
    g.manual_seed(21)
    A = torch.randn((SKETCH_M, SKETCH_N), generator=g, device=dev)
    k7 = {"new": kernels.gaussian_sketch_cuda,
          "simt": kernels.gaussian_sketch_simt}

    def sketch(which):
        try:
            kernels.gaussian_sketch_cuda = k7[which]
            reset_counts()
            out = ops.gaussian_sketch(A, SKETCH_D, 11)
            counts = read_counts()
            name = "gaussian_sketch" + ("" if which == "new" else "_simt")
            gate(counts == {**NO_LAUNCHES, name: 1},
                 f"sketch with the {which} K7: launches {counts}")
            return out, cuda_ms(
                lambda: ops.gaussian_sketch(A, SKETCH_D, 11), 3, warmup=0)
        finally:
            kernels.gaussian_sketch_cuda = k7["new"]

    runs = [(which, *sketch(which)) for which in ("simt", "new", "new",
                                                  "simt")]
    dS = float(torch.linalg.norm(runs[0][1] - runs[1][1])
               / torch.linalg.norm(runs[0][1]))
    gate(dS <= 1e-5, f"the two K7 bodies differ by {dS}")
    print(f"[old-vs-new] ops.gaussian_sketch {SKETCH_M}x{SKETCH_N} f32 to d="
          f"{SKETCH_D}, K7 in turns: "
          + ", ".join(f"{which} {ms:.4f} ms" for which, _, ms in runs)
          + f"; relative difference of the two results {dS:.3e}", flush=True)


def phase_kernel_anatomy(dev) -> None:
    """Where K5/K6's time goes: the same per-step work with fewer blocks
    (a 1-block grid has no cross-block barrier cost) or fewer barriers
    per step (K6 without pivoting runs 2 instead of 3)."""
    from randlapack_tpu_torch.ops import qrcp
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    anatomy = []
    for d, n in ((138, N), (138, 2048), (138, 256)):
        Y = torch.randn(d, n, generator=g, device=dev)
        live = torch.ones(n, device=dev)
        anatomy.append((f"K5 {d}x{n} 128 steps", cuda_ms(
            lambda: qrcp.qrcp_select_pivots_cuda(Y, 128, live), 10)))
    for m, r0, pv in ((N, 0, True), (N, 0, False), (N, 4096, True),
                      (N, N - 256, True), (N, N - 128, True)):
        P = torch.randn(m, 128, generator=g, device=dev)
        anatomy.append((f"K6 {m}x128 row0={r0} pivot={pv}", cuda_ms(
            lambda: qrcp.qrcp_panel_cuda(P, r0, pv), 10)))
    print("[kernel-anatomy] " + "; ".join(f"{k}: {v:.4f} ms"
                                          for k, v in anatomy), flush=True)


def phase_profile(dev) -> None:
    """One HQRRP factorization under torch.profiler: device time by
    kernel name, the kernel count and the device's busy share of the
    wall time. The full table goes to chiprun_out/hqrrp_profile.txt."""
    from pathlib import Path
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import HQRRPConfig, hqrrp_lapack_format
    from randlapack_tpu_torch.gen import fast_decay_matrix
    cfg = HQRRPConfig(block_size=128, update_defer=4)
    A, st = fast_decay_matrix(N, N, RNGState(7), device=dev)
    hqrrp_lapack_format(A, cfg, st)
    _, wall, rows = device_profile(lambda: hqrrp_lapack_format(A, cfg, st))
    dev_ms = sum(r[1] for r in rows)
    n_kernels = sum(r[2] for r in rows)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "hqrrp_profile.txt").write_text(
        f"wall {wall:.4f} s, device {dev_ms:.1f} ms, {n_kernels} kernels\n"
        + "\n".join(f"{ms:10.3f} ms {cnt:7d}  {key}"
                    for key, ms, cnt in rows))
    print(f"[profile] hqrrp_lapack_format {N}x{N}: wall {wall:.4f} s, "
          f"device busy {dev_ms:.1f} ms ({100 * dev_ms / 1e3 / wall:.1f} %)"
          f" in {n_kernels} kernel launches; top: " + "; ".join(
              f"{key[:60]} {ms:.1f} ms/{cnt}" for key, ms, cnt in rows[:12]),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import randlapack_tpu_torch  # noqa: F401  (fails outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    seconds = {}

    def run(phase, *args):
        """``phase(*args)`` with its wall seconds kept for the last
        ``[time]`` line."""
        t0 = time.perf_counter()
        result = phase(*args)
        torch.cuda.synchronize()
        seconds[phase.__name__[6:]] = time.perf_counter() - t0
        return result

    smi = run(phase_env)
    run(phase_build)
    timed = run(phase_kernels, dev)
    counts = {"bqrrp": run(phase_main, dev, f"{smi}")}
    run(phase_old_vs_new, dev)
    run(phase_remainder, dev)
    run(phase_small_vs_plain, dev)
    counts["hqrrp"] = run(phase_hqrrp, dev, f"{smi}")
    run(phase_hqrrp_phases, dev)
    run(phase_hqrrp_cholqr, dev)
    run(phase_hqrrp_small_vs_plain, dev)
    counts["krill"] = run(phase_krill, dev)
    counts["op"] = run(phase_sketch, dev)
    run(phase_k4_k7_old_vs_new, dev)
    if "--profile" in sys.argv[1:]:
        run(phase_kernel_anatomy, dev)
        run(phase_profile, dev)
    print("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f"; all {sum(seconds.values()):.1f} s", flush=True)
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[path][name], **timed[name])
               for name, (src, rep, path) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
