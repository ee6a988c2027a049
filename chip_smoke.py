"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Builds the hand-written kernels from randlapack_tpu_torch/csrc/ (one
nvcc per source, all at once, sm_90a, into build/kernels/), holds each
against its plain PyTorch version at the shapes its path gives it, then
drives the port's paths — two factorizations of 8192×8192 f32 fast-decay
matrices, KRILL, the fused Gaussian sketch, the tall QR drivers, the
low-rank drivers, the operator slice and least squares:

- BQRRP: bqrrp_factored with the headline configuration (b 256, 2 pivot
  candidates per slot, 2 stages, update defer 4), then bqrrp_q; the same
  factorization with K1/K2 pointed at their earlier SIMT kernels and at
  the tensor-core ones, then with K3 pointed at its earlier flat kernel
  and at the blocked one, each pair in turns and under torch.profiler
  (K3's pair also on HQRRP's CholQR-panel run);
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
- CQRRPT and CQRRT at BASELINE config 3, a 131072×2048 f32
  fast_decay_matrix (decay 9): config 3 as bench.py builds it (SRHT
  sketch, explicit BQRRP b 256 on the sketch, blocked-inverse trsm; best
  of 3 and a phase split; no kernel launches), the sketch QRCP through
  HQRRP b 128 (16 K5 and 16 K6 launches), the default configuration
  (SASO, geqp3) and CQRRT with SASO and SRHT, each gated on residual,
  orthogonality, ``fail``, J and launches; the SASO (scatter, gather) and
  SRHT sketches alone beside K7; K5/K6 at CQRRPT's shapes against their
  plain versions and a small f64 card-vs-CPU parity run;
- the low-rank slice: RSVD at BASELINE config 1 (rsvd_fixed_rank of a
  4096² f32 fast_decay_matrix, decay 80, rank 256, QB block 64; best of 5,
  GFLOP/s by 12mnk, a phase split, peak memory, gated against the optimal
  rank-256 tail, on the SVD's consistency with QB's error, orthogonality
  and no kernel launch; QB's error on four draws held to an independent
  plain f64 QB on the same draws), the SVD routes on its 256×4096 B with
  the Jacobi one checked against B's f64 SVD, the same RSVD at 8192²,
  the card SVD route against the library's default driver in turns
  (KRILL's full-size solve, config 1), REVD2 over the implicit kernel
  operator at KRILL's size (n 65536, rank 1024: 15 K4 launches a call,
  orthogonality, λ, eigenpair residuals, K4's share by CUDA events; the
  port's LUs against the library's default backend) and nystrom_pc_data
  at n 8192 against the dense kernel matrix's eigenvalues;
- the operator slice (no kernel on it): ABRIK at BASELINE config 5
  (abrik of an 8192x4096 f32 fast_decay_matrix, decay 12, k 64, block
  64, 4 iterations; best of 3 by CUDA events, GFLOP/s by 8mnk·4, peak
  memory, the triplet-0 residual; gated on the bases' orthogonality, the
  Krylov relation, σ against the f64 call and no launch), its
  timing=True split with a profile and the band factor's SVD by route,
  RSVD at rank 64 on the same matrix, ABRIK over SparseLinOp against
  the dense tensor at densities 0.01 and 0.05 with one SpMM each way
  against the dense product, cholqr_linops over a 65536x1024 sparse
  operator (density 0.02) against its dense one and column-blocked,
  and an f64 card-vs-CPU run of the operator battery, ABRIK and the
  four CholQR drivers;
- least squares (no kernel on it but trailing_wy_update's): BASELINE
  config 2 (spls of a 100000x2000 f32 fast_decay_matrix, decay 7: the
  LSQR default, PCG, "qr", no refinement, four right-hand sides, damped
  LSQR and the default in f64; best of 3 by CUDA events, iterations,
  residuals, x-error and peak memory, gated against the f64 call at κ·eps
  for LSQR and κ²·eps for PCG, κ from the f64 R of A), the default
  call's steps by CUDA events with LSQR's bandwidth and busy share, the
  solver operators on a 128x128 grid Laplacian (device and host solves,
  padded widths, residuals gated by the triangular solves' backward
  error) and ABRIK over K⁻¹·D, trailing_wy_update at 8192² (one K1 and
  one K2 launch, A unchanged), a 1e7-entry Matrix Market file read by
  the native reader (built with g++ into build/native/) and by scipy,
  and a small f64 card-vs-CPU run;
- the trailing-precision modes (trailing_precision "high", "default",
  "bf16_3x_emul": K1/K2 as one TF32, one bf16 or three bf16 products):
  each form of K1 and K2 against its plain version and the f64 product at
  the main path's shapes, timed beside the library call and its bound
  (the ring forms of csrc/wy_ring.cu, all three of both kernels, also in
  turns with the earlier forms, gated faster, with their pre-passes held
  bit for bit to the plain ones and again at HQRRP's shapes);
  bench.py's BQRRP and HQRRP speed modes at 8192² in each mode, in turns
  with "highest", gated on launches, the mode's residual gate,
  orthogonality and the trailing-norm ratios against LAPACK geqp3 in f64
  (with two controls the gates must refuse); config 3 with the sketch
  BQRRP's trailing products in TF32 against "highest";
- the driver-level precision= ("high": one TF32 cuBLAS product, "default":
  one bf16 product, both into fp32; the kernels keep their fp32 forms):
  the BQRRP headline, RSVD config 1, CQRRPT config 3, ABRIK config 5,
  KRILL at n 65536 and SPLS config 2, each in both modes beside
  "highest", best of 3 in turns, gated on launches, on PERF.md §2's
  readings (set from tools/precision_residuals.py's CPU emulation) and
  on the TF32 switches, with one wrong answer per driver the gates must
  refuse;
- the distributed layer (randlapack_tpu_torch.parallel, [parallel]): 4
  gloo ranks share the card in one spawn (the kernels built first) and
  run dist_bqrrp_factored on the headline's 8192² matrix (2048 rows a
  rank, b 256, 2 stages, update defer 1: K1, K2, K3 32 each a rank,
  gated on the f32 gates, R and J the same on every rank and the
  trailing-norm ratios against bqrrp_factored on one process), the
  distributed CholQR, Gram, sketch and rangefinder on 131072×256,
  dist_cqrrpt/dist_cqrrt at config 3, dist_rsvd at config 1, dist_spls
  at config 2, dist_revd2 (8192², rank 256) and dist_krill (n 16384),
  each best of 3 beside the same call on one process, with the
  collectives' share of one more run; one NCCL rank must reproduce the
  single-process factorization bit for bit; K1 and K2 alone at a shard's
  shapes;
- the n 65536 KRILL solve and that sketch once more with K4 and K7 pointed
  at their earlier SIMT kernels and at the tensor-core ones, in turns;
- K5 and K6 with their earlier cooperative kernels and the step kernels,
  in turns at the main shapes, and the 8192² HQRRP with each pair;
- [lu]: ops.qr.lu_factor (cuSOLVER's getrf through csrc/getrf.cu) against
  lu_factor_ex under the cuSOLVER preference at the main paths' LU shapes,
  bit for bit and in turns, with a thread reading the backend setting;
- [edge]: the kernel paths (BQRRP, HQRRP, CQRRPT, KRILL, REVD2, two gloo
  ranks of dist_bqrrp_factored and dist_hqrrp) at small shapes under
  tools/fuzz_sweep.py's mutators, each kernel launched held against its
  plain version on the run's operands, and each kernel and form alone on
  mutated operands (randlapack_tpu_torch.utils.kernel_checks).

Each path runs with the launch counts set to 0 just before it and read
just after, and is checked against the JAX test gates at f32 (residual,
orthogonality, permutation, launch counts). Every phase prints one line;
any failed gate raises, and the script exits non-zero. The last two
lines are a JSON summary of the kernels and the device line.
``--profile`` adds K5/K6 timings of both pairs at fewer blocks (us a
step) and a torch.profiler breakdown of one HQRRP factorization by kernel group (the
full table goes to chiprun_out/).

Exits non-zero, printing no result, when no CUDA device is available.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from collections import Counter

import torch

N = 8192
EPS32 = float(torch.finfo(torch.float32).eps)
RES_GATE = 10 * EPS32 ** 0.75                 # tests/test_bqrrp_factored.py:95
ORTH_GATE = 10 * EPS32 ** 0.75 * math.sqrt(N)  # ... :96
# the trailing-precision modes and the K1/K2 form each launches in f32
MODES = {"high": "tf32", "default": "bf16", "bf16_3x_emul": "bf16x3"}
# the launch counts of the earlier K1/K2 forms (csrc/wy.cu), yardsticks of
# the ring forms that no driver path takes: "tf32_wy", "bf16_wy" and
# "bf16x3_wy" of both kernels
YARDSTICKS = tuple(f"{k}_{f}_wy" for f in MODES.values()
                   for k in ("masked_vt_a", "a_minus_vz_masked"))
NO_LAUNCHES = dict.fromkeys(
    ("masked_vt_a", "a_minus_vz_masked", "masked_vt_a_simt",
     "a_minus_vz_masked_simt", "getrfnp", "qrcp_select_pivots",
     "qrcp_panel", "kernel_matmat", "gaussian_sketch",
     "kernel_matmat_simt", "gaussian_sketch_simt", "kernel_matmat_wide",
     "qrcp_select_pivots_coop", "qrcp_panel_coop", "getrfnp_flat",
     *(f"{k}_{f}" for f in MODES.values()
       for k in ("masked_vt_a", "a_minus_vz_masked")), *YARDSTICKS,
     "tf32_tiles", "bf16_tiles"), 0)
EXPECTED_LAUNCHES = {**NO_LAUNCHES, "masked_vt_a": 32,
                     "a_minus_vz_masked": 8, "getrfnp": 32}
# HQRRP at 8192², b 128: 64 blocks, one K5 and one K6 launch each
HQRRP_LAUNCHES = {**NO_LAUNCHES, "qrcp_select_pivots": 64, "qrcp_panel": 64}
# KRILL, bench.py's recipe; the full-size run has 8× its n and 4× its k
KRILL_N, KRILL_K = 65536, 1024
# REVD2 over KRILL's full-size kernel operator at KRILL's rank: SYPS's three
# passes, SYRF's product and Y at s = k, then ten power-estimate passes at
# s = 1, each a K4 launch (those at s = k of its wide body)
REVD2_K = 1024
REVD2_LAUNCHES = {**NO_LAUNCHES, "kernel_matmat": 15, "kernel_matmat_wide": 5}
# BASELINE config 1 (bench.py:336-357): RSVD of a 4096² fast-decay matrix
# (decay 80: the optimal rank-256 tail ~1e-2), rank 256, QB block 64; and
# the same at 8192² (BASELINE.md's target shape)
RSVD_N, RSVD_K, RSVD_B = 4096, 256, 64
RSVD_ORTH_GATE = 10 * EPS32 ** 0.75 * math.sqrt(RSVD_K)
# QB's error against the optimal rank-k tail. With one power iteration and
# no oversampling the algorithm itself lands at 1.09-1.10x on config 1's
# matrix: [rsvd-draws] holds the port (f32 and f64) to an independent
# plain f64 QB on the same four draws, and that reads 1.0915-1.1026 too.
# The gate sits 1.6 % above the worst of those readings
RSVD_TAIL_FACTOR = 1.12
# BASELINE config 5 (bench.py:482-500): ABRIK of an 8192x4096 fast-decay
# matrix (decay 12), k 64, block 64, 4 Krylov iterations; the bases'
# orthogonality gate is PERF.md §2's rule at f32 for their 256 columns
ABRIK_M, ABRIK_N, ABRIK_K, ABRIK_B, ABRIK_Q = 8192, 4096, 64, 64, 4
ABRIK_ORTH_GATE = 10 * EPS32 ** 0.75 * math.sqrt(ABRIK_B * ABRIK_Q)
# the sketch of CQRRPT at a 131072×2048 matrix: d = 1.25·n rows
SKETCH_M, SKETCH_N, SKETCH_D = 131072, 2048, 2560
# config 3 of BASELINE.md: CQRRPT of a 131072x2048 tall matrix (bench.py's
# recipe), its sketch d = 1.25·n; gates from tests/test_qr_drivers.py at
# f32 and the rank k
TALL_M, TALL_N = 131072, 2048
# the sketch QRCP through HQRRP at b 128: 16 blocks on the 2560x2048
# sketch, one K5 and one K6 launch each
CQRRPT_HQRRP_LAUNCHES = {**NO_LAUNCHES, "qrcp_select_pivots": 16,
                         "qrcp_panel": 16}
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
# the pre-passes and ring kernels of K1/K2's ring forms: those whose entry
# point in wy.FORM_KERNELS is not one of csrc/wy.cu's "rl_*_mode" ones
RING_SOURCE = "randlapack_tpu_torch/csrc/wy_ring.cu"
# the residual of an f32 factorization whose trailing products run in a
# mode: at most twice the unit roundoff u of the operands the mode rounds
# them to (TF32 2^-11, bf16 2^-8; three bf16 products drop lo·lo, 2^-16).
# An operand rounded to nearest errs by up to u, uniformly, so a product
# of two rounded operands by ~0.8·u of itself, and the first trailing
# updates leave that in R (PERF.md §2; tools/trailing_mode_residuals.py,
# the forms' plain versions in these drivers on the CPU, reads
# 0.35-0.82·u from 1024² to 4096²)
MODE_U = {"high": 2.0 ** -11, "default": 2.0 ** -8,
          "bf16_3x_emul": 2.0 ** -16}
MODE_RES_GATE = {tp: 2 * u for tp, u in MODE_U.items()}
# docs/pivot_quality_f32.md: every driver's trailing-norm ratio against
# LAPACK geqp3 in f64 over the leading half, chip f32
PIVOT_BAND = (0.79, 1.07)
# one H100 SXM, published peaks: fp32 outside the tensor cores, dense TF32
# and bf16 on them, and HBM3
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
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
    from randlapack_tpu_torch.utils.kernel_checks import launch_counts
    return launch_counts()


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
    from randlapack_tpu_torch.utils import timing
    t0 = time.perf_counter()
    _build.lib()
    paths = _build.build()
    regs = [f"{path.stem.rsplit('_', 1)[0][3:]}: " + ", ".join(
        ln.split(":", 1)[1].strip() for ln in
        path.with_suffix(".log").read_text().splitlines()
        if "registers" in ln) for path in paths]
    # the set-up spans of _build.lib(): "nvcc" (where a library was stale)
    # with one span a source, all started together
    setup = timing.setup_spans()
    load = [s["id"] for s in setup if s["name"] == "setup.kernels"][-1:]
    nvcc = [s for s in setup if s["name"] == "nvcc" and s["parent"] in load]
    each = [s for s in setup if nvcc and s["parent"] == nvcc[-1]["id"]]
    built = ("reused" if not nvcc
             else f"nvcc {nvcc[-1]['host_ms'] * 1e-3:.2f} s, in parallel; "
             "each: " + ", ".join(f"{s['name']} {s['host_ms'] * 1e-3:.2f} s"
                                  for s in each)
             + "; one after another would take "
             f"{sum(s['host_ms'] for s in each) * 1e-3:.2f} s or less")
    print(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.2f}"
          f" s ({built}); ptxas: "
          f"{' | '.join(regs)}", flush=True)


def switched_lu(A):
    """The LU as ops.qr.lu_factor took it before its cuSOLVER binding: the
    process-wide backend switched to cuSOLVER around lu_factor_ex."""
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return torch.linalg.lu_factor_ex(A)
    finally:
        torch.backends.cuda.preferred_linalg_library("default")


# the pivoted LUs of the main paths: the BQRRP headline's pivot pass
# (the transposed d x n_rem sketch panel, d 320, at its first, a middle
# and its last block) and comps.orth's PLU stabilization (RSVD config 1's
# 4096 x 64, REVD2's 65536 x 1024)
LU_SHAPES = ((N, 320), (N // 2, 320), (256, 320), (RSVD_N, RSVD_B),
             (KRILL_N, REVD2_K))


def phase_lu(dev) -> None:
    """ops.qr.lu_factor (cuSOLVER's getrf through csrc/getrf.cu) against
    the process-wide switch it replaced, at the main paths' shapes: LU,
    pivots and info bit-equal, times in turns; a thread reading the
    backend setting during 100 calls sees "default" throughout."""
    import threading

    from randlapack_tpu_torch.ops.qr import lu_factor
    default = torch._C._LinalgBackend.Default
    rows = []
    for shape in LU_SHAPES:
        Y = torch.randn(shape, device=dev)
        new, old = lu_factor(Y), switched_lu(Y)
        gate(all(torch.equal(a, b) for a, b in zip(new, old)),
             f"lu: {shape} LU, pivots or info differ from the switched "
             f"route")
        reps = 3 if shape[0] * shape[1] > 1 << 24 else 20
        t_old, t_new = in_turns(lambda: switched_lu(Y),
                                lambda: lu_factor(Y), reps)
        rows.append(f"{shape[0]}x{shape[1]} binding {t_new:.4f} ms, switch "
                    f"{t_old:.4f} ms")
    seen, stop = set(), threading.Event()

    def watch():
        while not stop.is_set():
            seen.add(torch.backends.cuda.preferred_linalg_library())

    Y = torch.randn(LU_SHAPES[0], device=dev)
    reader = threading.Thread(target=watch)
    reader.start()
    try:
        for _ in range(100):
            lu_factor(Y)
        torch.cuda.synchronize()
    finally:
        stop.set()
        reader.join(timeout=60)
    gate(not reader.is_alive() and seen == {default},
         f"lu: a reading thread saw the backend setting {seen}")
    print("[lu] ops.qr.lu_factor f32 (cuSOLVER getrf through "
          "csrc/getrf.cu) against the switched lu_factor_ex, bit-equal, in "
          "turns: " + "; ".join(rows) + f"; a thread's readings during 100 "
          f"calls: {sorted(str(b) for b in seen)}", flush=True)


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
    # K3 getrfnp: the blocked kernel at BQRRP's k 256 and HQRRP CholQR's
    # k 128 (timed against the earlier flat kernel in turns, and against
    # cuSOLVER's unpivoted LU of M - diag(s), the signs handed to it), a
    # ragged 200 and f64
    for k, dtype, timed in ((256, f32, True), (128, f32, True),
                            (200, f32, False), (256, torch.float64, False)):
        M = torch.linalg.qr(torch.randn(k, k, generator=g, device=dev,
                                        dtype=dtype))[0].contiguous()
        F, s = lu.getrfnp_cuda(M)
        F2, s2 = lu.getrfnp_cuda(M)
        Ff, sf = lu.getrfnp_flat(M)
        Fp, sp = lu.getrfnp(M)
        tol = 1e-4 if dtype == f32 else 1e-10
        err = float((F - Fp).abs().max())
        umin = float(torch.triu(F).diagonal().abs().min())
        eye = torch.eye(k, dtype=dtype, device=dev)
        res = float(((torch.tril(F, -1) + eye) @ torch.triu(F)
                     - (M - torch.diag(s))).abs().max())
        LU, _, info = torch.linalg.lu_factor_ex(M - torch.diag(s),
                                                pivot=False)
        e_lib = float((F - LU).abs().max())
        e_flat = float((Ff - Fp).abs().max())
        gate(torch.equal(s, sp) and torch.equal(sf, sp),
             f"getrfnp k={k}: sign vectors differ")
        gate(err <= tol and e_flat <= tol, f"getrfnp k={k}: max|dF| {err}, "
             f"flat {e_flat}")
        gate(res <= tol, f"getrfnp k={k}: |LU - (M - diag s)| {res}")
        gate(umin >= 1 - 1e-5, f"getrfnp k={k}: min|u_jj| {umin}")
        gate(torch.equal(F, F2) and torch.equal(s, s2),
             f"getrfnp k={k}: two launches differ")
        gate(int(info) == 0 and e_lib <= tol,
             f"getrfnp k={k}: lu_factor_ex info {int(info)}, max|dF| {e_lib}")
        line = (f"[kernel] getrfnp k={k} {str(dtype)[6:]}: same s as the plain "
                f"and the flat kernel, max|dF| {err:.3e} (flat {e_flat:.3e}),"
                f" |LU - (M - diag s)| {res:.3e}, min|u_jj| {umin:.6f}, two "
                f"launches bit-equal, bit-equal to the flat kernel "
                f"{torch.equal(F, Ff)}; lu_factor_ex(pivot=False, s given) "
                f"max|dF| {e_lib:.3e}")
        if timed:
            flat_ms, ms = in_turns(lambda: lu.getrfnp_flat(M),
                                   lambda: lu.getrfnp_cuda(M), 100)
            lib_ms = cuda_ms(lambda: torch.linalg.lu_factor_ex(
                M - torch.diag(s), pivot=False), 100)
            rec = dict(ms=ms, flat_ms=flat_ms, us_per_step=ms * 1e3 / k,
                       library_ms=lib_ms,
                       library_call="torch.linalg.lu_factor_ex(M - diag(s),"
                       " pivot=False), s given")
            if k == 256:
                out["getrfnp"] = dict(
                    max_abs_err=err, lib_max_abs_err=e_lib,
                    plain_ms=cuda_ms(lambda: lu.getrfnp(M), 3, warmup=1),
                    **bound(2 * k ** 3 / 3, 4 * (2 * k * k + k)), **rec)
            else:
                out["getrfnp"].update({f"{key}_k{k}": v
                                       for key, v in rec.items()
                                       if key != "library_call"})
            line += (f"; blocked {ms:.4f} ms ({ms * 1e3 / k:.3f} us a step), "
                     f"flat {flat_ms:.4f} ms ({flat_ms * 1e3 / k:.3f} us a "
                     f"step), in turns; lu_factor_ex {lib_ms:.4f} ms")
        print(line, flush=True)
    # K5 qrcp_select_pivots: the HQRRP sketch Y (138, 8192), 128 steps,
    # some columns retired (and a ragged case); the step kernel and the
    # earlier cooperative one against the plain version, timed in turns
    for d, n, steps, timed in ((138, N, 128, True), (74, 1000, 64, False)):
        Y = spread(d, n)
        live = torch.ones(n, dtype=f32, device=dev)
        retired = torch.randperm(n, generator=g, device=dev)[:n // 8]
        live[retired] = 0.0
        ck = qrcp.qrcp_select_pivots_cuda(Y, steps, live)
        cc = qrcp.qrcp_select_pivots_coop(Y, steps, live)
        cp = qr.qrcp_select_pivots(Y, steps, live)
        gate(torch.equal(ck, cp) and torch.equal(cc, cp),
             f"qrcp_select_pivots {d}x{n}: pivots differ from the plain "
             "version's")
        gate(not bool(torch.isin(ck, retired).any()),
             "qrcp_select_pivots chose a retired column")
        if timed:
            ms_coop, ms = in_turns(
                lambda: qrcp.qrcp_select_pivots_coop(Y, steps, live),
                lambda: qrcp.qrcp_select_pivots_cuda(Y, steps, live), 10)
            out["qrcp_select_pivots"] = dict(
                max_abs_err=float((ck - cp).abs().max()), ms=ms,
                us_per_step=ms * 1e3 / steps, coop_ms=ms_coop,
                coop_us_per_step=ms_coop * 1e3 / steps,
                plain_ms=cuda_ms(lambda: qr.qrcp_select_pivots(
                    Y, steps, live), 2, warmup=1),
                **bound(*select_pivots_work(Y, steps, live)),
                library_ms=None)
        print(f"[kernel] qrcp_select_pivots d={d} n={n} steps={steps} "
              f"({n // 8} retired): pivots of both kernels equal", flush=True)
    # K6 qrcp_panel: the HQRRP panel (8192, 128) at row0 0 and 4096 (and
    # a ragged case), both kernels
    for m, b, r0, timed in ((N, 128, 0, True), (N, 128, 4096, False),
                            (1000, 100, 333, False)):
        P = spread(m, b)
        Wp, _, tp, sp = qr.qrcp_panel(P, r0)
        for name, fn in (("step", qrcp.qrcp_panel_cuda),
                         ("coop", qrcp.qrcp_panel_coop)):
            W, taus, sigma = fn(P, r0)
            err = float((W - Wp).abs().max())
            terr = float((taus - tp).abs().max())
            gate(torch.equal(sigma, sp), f"qrcp_panel ({name}) {m}x{b} "
                 f"row0={r0}: sigma differs from the plain version's")
            gate(err <= 1e-4 * float(Wp.abs().max()) and terr <= 1e-4,
                 f"qrcp_panel ({name}) {m}x{b} row0={r0}: max|dW| {err}, "
                 f"max|dtau| {terr}")
            if name == "step":
                errs = (err, terr)
        if timed:
            ms_coop, ms = in_turns(lambda: qrcp.qrcp_panel_coop(P, r0),
                                   lambda: qrcp.qrcp_panel_cuda(P, r0), 10)
            out["qrcp_panel"] = dict(
                max_abs_err=errs[0], ms=ms, us_per_step=ms * 1e3 / b,
                coop_ms=ms_coop, coop_us_per_step=ms_coop * 1e3 / b,
                plain_ms=cuda_ms(lambda: qr.qrcp_panel(P, r0), 2,
                                 warmup=1),
                **bound(*panel_work(m, b, r0, 4)),
                library_ms=None)
        print(f"[kernel] qrcp_panel m={m} b={b} row0={r0}: sigma of both "
              f"kernels equal, step kernel max|dW| {errs[0]:.3e} "
              f"(max|plain| {float(Wp.abs().max()):.3e}), max|dtau| "
              f"{errs[1]:.3e}", flush=True)
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
    # K4 at REVD2's width, s = k = 1024. At the [revd2-kernel] shape (n
    # 65536) against its plain version on the same X and V (the f32
    # blocked product, 1e-4 of max|plain|), which holds the 273 MB scratch
    # buffer and the grid at that shape, then timed beside the plain
    # version and the bound. At n 8192 also against the split emulation
    # and, as at s 1, within F64_ERR_FACTOR of the SIMT kernel's error
    # against the f64 plain version (the f64 product at n 65536 would
    # take minutes). The kernel evaluates K afresh for every 16-column
    # chunk of V (s/16 = 64 times what the bound counts)
    X, V = randn(8, 8192), randn(8192, REVD2_K)
    Ko = kernels.kernel_matmat(X, V, bw)
    ref = kernels.kernel_matmat_reference(X.double(), V.double(), bw,
                                          block=2048)
    emul = kernels.kernel_matmat_split_reference(X, V, bw, block=2048)
    err8 = float((Ko - emul).abs().max())
    e_new = relf(Ko, ref)
    e_simt = relf(kernels.kernel_matmat_simt(X, V, bw), ref)
    gate(err8 <= 1e-4 * float(emul.abs().max()),
         f"kernel_matmat n=8192 s={REVD2_K}: max|d| {err8} from the split "
         f"emulation")
    gate(e_new <= F64_ERR_FACTOR * e_simt,
         f"kernel_matmat n=8192 s={REVD2_K}: error against f64 {e_new}, the "
         f"SIMT kernel's {e_simt}")
    del X, V, Ko, ref, emul
    X, V = randn(8, KRILL_N), randn(KRILL_N, REVD2_K)
    Ko = kernels.kernel_matmat(X, V, bw)
    plain = kernels.kernel_matmat_reference(X, V, bw, block=2048)
    err = float((Ko - plain).abs().max())
    e_plain = float(torch.linalg.norm(Ko - plain) / torch.linalg.norm(plain))
    gate(bool(torch.isfinite(Ko).all()) and err <= 1e-4 * float(
        plain.abs().max()), f"kernel_matmat n={KRILL_N} s={REVD2_K}: max|d| "
         f"{err} from the plain version")
    gate(torch.equal(Ko, kernels.kernel_matmat(X, V, bw)),
         f"kernel_matmat n={KRILL_N} s={REVD2_K}: two launches differ")
    del Ko, plain
    wide_ms = cuda_ms(lambda: kernels.kernel_matmat(X, V, bw), 3, warmup=1)
    wide_plain = cuda_ms(lambda: kernels.kernel_matmat_reference(
        X, V, bw, block=2048), 1, warmup=1)
    wide = bound(**kernels.kernel_matmat_work(8, KRILL_N, REVD2_K))
    out["kernel_matmat"].update(
        wide_s=REVD2_K, wide_n=KRILL_N, wide_ms=wide_ms,
        wide_plain_ms=wide_plain, wide_bound_ms=wide["bound_ms"],
        wide_bound_by=wide["bound_by"], wide_max_abs_err=err,
        wide_rel_err_vs_plain=e_plain, n8192_s1024_err_vs_f64=e_new,
        n8192_s1024_simt_err_vs_f64=e_simt)
    print(f"[kernel] kernel_matmat d=8 s={REVD2_K} (REVD2's width): n "
          f"{KRILL_N}: max|d| from the plain version {err:.3e}, relative "
          f"{e_plain:.3e}, two launches bit-equal, kernel {wide_ms:.4f} ms, "
          f"plain {wide_plain:.4f} ms, bound {wide['bound_ms']:.4f} ms "
          f"({wide['bound_by']}: n^2 (2s + 6) flops at "
          f"{PEAK_FP32 / 1e12:.0f} TFLOP/s), kernel/bound "
          f"{wide_ms / wide['bound_ms']:.2f}; n 8192: max|d| from the split "
          f"emulation {err8:.3e}, relative error against f64 {e_new:.3e} "
          f"(SIMT {e_simt:.3e})", flush=True)
    del X, V
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
               if "simt_ms" in rec else
               f" ({rec['us_per_step']:.2f} us a step), earlier cooperative"
               f" kernel {rec['coop_ms']:.4f} ms "
               f"({rec['coop_us_per_step']:.2f} us a step)"
               if "coop_ms" in rec else
               f" ({rec['us_per_step']:.3f} us a step), earlier flat kernel "
               f"{rec['flat_ms']:.4f} ms; k 128: {rec['ms_k128']:.4f} ms, flat "
               f"{rec['flat_ms_k128']:.4f} ms, library "
               f"{rec['library_ms_k128']:.4f} ms"
               if "flat_ms" in rec else "")
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
    # the LU of the pivot pass through ops.qr.lu_factor (cuSOLVER) against
    # the library's default backend (MAGMA for a tall matrix): best of 2
    # in turns, and whether every run chose the same J
    from randlapack_tpu_torch.ops import qr as tqr
    port_lu = tqr.lu_factor

    def best_of_2(lu):
        tqr.lu_factor = lu
        try:
            bqrrp_factored(A, cfg, st)
            runs = []
            for _ in range(2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                f, _ = bqrrp_factored(A, cfg, st)
                end.record()
                torch.cuda.synchronize()
                runs.append((start.elapsed_time(end) / 1e3, f.J))
            return min(t for t, _ in runs), [J for _, J in runs]
        finally:
            tqr.lu_factor = port_lu

    turns = [(w, *best_of_2(torch.linalg.lu_factor_ex if w == "library"
                            else port_lu))
             for w in ("library", "port", "port", "library")]
    same = all(torch.equal(J, fac.J) for *_, Js in turns for J in Js)
    print("[main-lu] bqrrp_factored 8192x8192 f32, the pivot pass's LU by "
          "the library's default backend against ops.qr.lu_factor, best of "
          "2 in turns: " + ", ".join(f"{w} {t:.4f} s" for w, t, _ in turns)
          + f"; J equal in every run {same}", flush=True)
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
    MAIN_PROFILE["new"] = facs["new"]
    for which, (fac, wall, rows) in facs.items():
        busy = sum(ms for _, ms, _ in rows)
        gate(busy > 0, "the profiler saw no device time")
        # the tensor-core kernel is wy_tc_kernel<kVtA, form>
        k1 = sum(ms for key, ms, _ in rows if "wy_tc_kernel<true," in key
                 or "wy_tc_kernel<(bool)1," in key or "add_parts" in key
                 or "masked_vt_a_kernel" in key)
        k2 = sum(ms for key, ms, _ in rows if "wy_tc_kernel<false," in key
                 or "wy_tc_kernel<(bool)0," in key
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


# the profiled run of the main path that phase_old_vs_new makes, reused as
# the blocked-K3 run of phase_k3_old_vs_new (the same configuration)
MAIN_PROFILE = {}


def phase_k3_old_vs_new(dev) -> None:
    """The 8192x8192 BQRRP factorization with K3 pointed at the earlier
    flat kernel and at the blocked one: best-of-2 times in turns (flat,
    blocked, blocked, flat), then each under torch.profiler (wall time, the
    card's busy time and idle share, K3's share), with residual,
    orthogonality and whether both give the same J (the blocked run under
    the profiler is phase_old_vs_new's, when it ran); then HQRRP's
    CholQR-panel run (3000x2000, 16 K3 launches) in turns, best of 2."""
    from pathlib import Path
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import (BQRRPConfig, HQRRPConfig,
                                              PanelQR, bqrrp_factored, hqrrp)
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.ops import lu
    bodies = {"blocked": lu.getrfnp_cuda, "flat": lu.getrfnp_flat}

    def with_k3(which, fn):
        try:
            lu.getrfnp_cuda = bodies[which]
            return fn()
        finally:
            lu.getrfnp_cuda = bodies["blocked"]

    def best_of_2(which, run, expected):
        def timed():
            times = []
            for _ in range(2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                reset_counts()
                start.record()
                result = run()
                end.record()
                torch.cuda.synchronize()
                gate(read_counts() == expected[which],
                     f"launches with the {which} K3 {read_counts()}")
                times.append(start.elapsed_time(end) / 1e3)
            return min(times), result
        return with_k3(which, timed)

    cfg = BQRRPConfig(block_size=256, pivot_candidates=2, stages=2,
                      update_defer=4)
    A, st = fast_decay_matrix(N, N, RNGState(0), device=dev)
    expected = {"blocked": EXPECTED_LAUNCHES,
                "flat": {**EXPECTED_LAUNCHES, "getrfnp": 0,
                         "getrfnp_flat": 32}}
    turns = [(which, best_of_2(which, lambda: bqrrp_factored(A, cfg, st),
                               expected)[0])
             for which in ("flat", "blocked", "blocked", "flat")]
    print("[old-vs-new] bqrrp_factored 8192x8192 f32, K3 flat against "
          "blocked, best of 2, in turns: " + ", ".join(
              f"{which} {t:.4f} s" for which, t in turns), flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    facs = {}
    for which in ("flat", "blocked"):
        if which == "blocked" and "new" in MAIN_PROFILE:
            fac, wall, rows = MAIN_PROFILE["new"]
        else:
            (fac, _), wall, rows = with_k3(which, lambda: device_profile(
                lambda: bqrrp_factored(A, cfg, st)))
        busy = sum(ms for _, ms, _ in rows)
        gate(busy > 0, "the profiler saw no device time")
        k3 = [(ms, cnt) for key, ms, cnt in rows if "getrfnp" in key]
        gate(len(k3) == 1 and k3[0][1] == 32,
             f"K3 ({which}) not found 32 times in the profile: {k3}")
        (out / f"bqrrp_profile_k3_{which}.txt").write_text(
            f"wall {wall:.4f} s, device {busy:.1f} ms, "
            f"{sum(c for *_, c in rows)} launches\n" + "\n".join(
                f"{ms:10.3f} ms {cnt:7d}  {key}" for key, ms, cnt in rows))
        _, res, orth = quality(A, fac)
        facs[which] = fac
        print(f"[old-vs-new] K3 {which} under the profiler: wall {wall:.4f} "
              f"s, card busy {busy:.1f} ms (idle "
              f"{100 - 100 * busy / 1e3 / wall:.1f} %), K3 {k3[0][0]:.2f} ms "
              f"in {k3[0][1]} launches ({100 * k3[0][0] / busy:.1f} % of "
              f"busy); residual {res:.3e}, orth {orth:.3e}, fail "
              f"{bool(fac.fail)}", flush=True)
        gate(res <= RES_GATE and orth <= ORTH_GATE and not bool(fac.fail),
             f"quality with the {which} K3")
    print(f"[old-vs-new] K3: J equal between the two: "
          f"{torch.equal(facs['flat'].J, facs['blocked'].J)}, R equal: "
          f"{torch.equal(facs['flat'].R, facs['blocked'].R)}", flush=True)

    A, st = fast_decay_matrix(3000, 2000, RNGState(1), device=dev)
    chol = HQRRPConfig(block_size=128, panel_qr=PanelQR.cholqr)
    panel = {**NO_LAUNCHES, "qrcp_select_pivots": 16}
    expected = {"blocked": {**panel, "getrfnp": 16},
                "flat": {**panel, "getrfnp_flat": 16}}
    runs = [(which, *best_of_2(which, lambda: hqrrp(A, chol, st), expected))
            for which in ("flat", "blocked", "blocked", "flat")]
    quality_ = []
    for which, _, (Q, R, J, _, fail, _) in runs[:2]:
        res = float(torch.linalg.norm(Q @ R - A[:, J]) / torch.linalg.norm(A))
        gate(res <= RES_GATE and not bool(fail),
             f"cholqr-panel run with the {which} K3: residual {res}")
        quality_.append(f"{which} residual {res:.3e}")
    print("[old-vs-new] hqrrp 3000x2000 f32 cholqr panels, K3 flat against "
          "blocked, best of 2, in turns: " + ", ".join(
              f"{which} {t:.4f} s" for which, t, _ in runs)
          + f"; {', '.join(quality_)}", flush=True)


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
    torch.linalg.svd(F[:4096], full_matrices=False)
    (Ug, sig_g, _), t_gram = timed(lambda: svd_econ(F, "gram_eigh"))
    (V, sig, _), t_xla = timed(lambda: svd_econ(F, "xla"))
    (Ud, _, _), t_lib = timed(lambda: torch.linalg.svd(
        F, full_matrices=False))
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
          f"{tuple(F.shape)}: xla (QR, then gesvd of R) {t_xla:.4f} s "
          f"(|UtU-I|_F {orth(V):.2e}, sigma {float(sig[0]):.3e}.."
          f"{float(sig[-1]):.3e}), torch.linalg.svd with the library's "
          f"default driver {t_lib:.4f} s (|UtU-I|_F {orth(Ud):.2e}), "
          f"gram_eigh {t_gram:.4f} s (|UtU-I|_F {orth(Ug):.2e}); pcg "
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


def tall_quality(A, Q, R, J, k):
    """Residual ‖Q_k R_k − A[:, J]‖_F/‖A‖_F and ‖Q_kᵀQ_k − I‖_F, in f64."""
    Qk, Rk = Q[:, :k].double(), R[:k].double()
    AJ = A.index_select(1, J).double()
    res = float(torch.linalg.norm(Qk @ Rk - AJ) / torch.linalg.norm(AJ))
    orth = float(torch.linalg.norm(
        Qk.T @ Qk - torch.eye(k, dtype=Qk.dtype, device=Qk.device)))
    return res, orth


def tall_gates(tag, A, Q, R, J, rank, fail, counts, expected, secs,
               peak) -> None:
    """One ``[cqrrpt…]`` line and the f32 gates of tests/test_qr_drivers.py
    at the rank k: residual ≤ 10·eps^0.75, orthogonality ≤
    10·eps^0.75·√k, ``fail`` False, J a permutation, the launch counts.
    ``peak`` is the run's peak device memory in GiB."""
    m, n = A.shape
    k = int(rank) if rank is not None else n
    res, orth = tall_quality(A, Q, R, J, k)
    orth_gate = RES_GATE * math.sqrt(k)
    print(f"[{tag}] {m}x{n} f32: {secs}; residual {res:.3e} (gate "
          f"{RES_GATE:.2e}), orth {orth:.3e} (gate {orth_gate:.2e}), rank "
          f"{k}, fail {bool(fail)}, peak memory {peak:.2f} GiB, launches "
          f"{({c: v for c, v in counts.items() if v}) or 'none'}",
          flush=True)
    gate(bool(torch.isfinite(Q).all() and torch.isfinite(R).all()),
         f"{tag}: non-finite output")
    gate(torch.equal(torch.sort(J).values, torch.arange(n, device=J.device)),
         f"{tag}: J is not a permutation")
    gate(res <= RES_GATE, f"{tag}: residual {res}")
    gate(orth <= orth_gate, f"{tag}: orthogonality {orth}")
    gate(not bool(fail), f"{tag}: fail flag raised")
    gate(counts == expected, f"{tag}: launches {counts} != {expected}")


def timed_run(fn, reps: int):
    """``fn()`` ``reps`` times after one warm-up: the last output, wall
    seconds of each run around a synchronize, the launch counts and the
    peak device memory (GiB, inputs included) of the last run."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return out, times, read_counts(), peak


def phase_cqrrpt(dev, card: str, k7_ms: float) -> dict:
    """CQRRPT and CQRRT at BASELINE config 3 (131072x2048 f32,
    fast_decay_matrix(..., RNGState(2), decay=9.0)): config 3 as bench.py
    builds it (best of 3, then a timing=True split), the same matrix with
    the sketch QRCP through HQRRP (K5/K6), the default configuration (SASO,
    geqp3) and CQRRT with SASO and SRHT; the sketches alone beside K7; K5
    and K6 against their plain versions at this path's shapes; a small f64
    card-vs-CPU parity run. Returns the HQRRP run's launch counts."""
    import dataclasses
    from randlapack_tpu_torch import RNGState, sketching
    from randlapack_tpu_torch.drivers import (CQRRPTConfig, CQRRTConfig,
                                              QRCPKind, SketchKind, cqrrpt,
                                              cqrrt)
    from randlapack_tpu_torch.gen import fast_decay_matrix
    A, st = fast_decay_matrix(TALL_M, TALL_N, RNGState(2), decay=9.0,
                              device=dev)
    m, n = A.shape
    flops = 2.0 * m * n ** 2                    # bench.py's count
    cfg3 = CQRRPTConfig(sketch="srht", qrcp=QRCPKind.bqrrp,
                        bqrrp_block=256, bqrrp_pivot_candidates=2,
                        trsm_mode="blockinv")

    # -- config 3: best of 3, then the phase split --------------------------
    (Q, R, J, rank, fail, _), times, counts, peak = timed_run(
        lambda: cqrrpt(A, cfg3, st), 3)
    t = min(times)
    tall_gates("cqrrpt", A, Q, R, J, rank, fail, counts, NO_LAUNCHES,
               f"cqrrpt config 3 (srht, bqrrp b256 pc2, blockinv) on {card}"
               f": runs {[round(x, 4) for x in times]} s, best {t:.4f} s = "
               f"{flops / t / 1e9:.1f} GFLOP/s (2mn^2)", peak)
    del Q, R
    *_, phases = cqrrpt(A, cfg3, st, timing=True)
    print("[cqrrpt-phases] config 3, timing=True (blockinv: the timed path "
          "gathers A[:, J] as a_mod_piv; the untimed one folds the gather "
          "into a_mod_trsm): " + ", ".join(
              f"{k} {v:.4f} s" for k, v in phases.items()), flush=True)

    # -- the sketch QRCP through HQRRP: K5/K6 ------------------------------
    cfg_h = dataclasses.replace(cfg3, qrcp=QRCPKind.hqrrp, bqrrp_block=128)
    (Q, R, J, rank, fail, _), times, hq_counts, peak = timed_run(
        lambda: cqrrpt(A, cfg_h, st), 1)
    tall_gates("cqrrpt-hqrrp", A, Q, R, J, rank, fail, hq_counts,
               CQRRPT_HQRRP_LAUNCHES,
               f"cqrrpt srht, hqrrp b128, blockinv: {times[0]:.4f} s", peak)
    del Q, R

    # -- the default configuration (SASO, geqp3): geqp3 on the sketch -------
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    Q, R, J, rank, fail, _, ph = cqrrpt(A, CQRRPTConfig(), st, timing=True)
    secs = time.perf_counter() - t0
    tall_gates("cqrrpt-default", A, Q, R, J, rank, fail, read_counts(),
               NO_LAUNCHES,
               f"cqrrpt default (saso, geqp3), timing=True: {secs:.4f} s, "
               f"of which saso {ph['saso']:.4f} s and geqp3 on the "
               f"{int(1.25 * n)}x{n} sketch (qrcp) {ph['qrcp']:.4f} s",
               torch.cuda.max_memory_allocated() / 2 ** 30)
    del Q, R

    # -- CQRRT with SASO and SRHT --------------------------------------------
    for kind in (SketchKind.saso, SketchKind.srht):
        (Q, R, fail, _), times, counts, peak = timed_run(
            lambda: cqrrt(A, CQRRTConfig(sketch=kind), st), 1)
        tall_gates(f"cqrrt-{kind.value}", A, Q, R,
                   torch.arange(n, device=dev), None, fail, counts,
                   NO_LAUNCHES, f"cqrrt {kind.value}: {times[0]:.4f} s",
                   peak)
        del Q, R

    # -- the sketches alone, beside K7 ---------------------------------------
    d = int(1.25 * n)
    gen_ms = cuda_ms(lambda: sketching.fill_sparse(
        sketching.SparseDist(d, m), st, device=dev), 3, warmup=1)
    op, _ = sketching.fill_sparse(sketching.SparseDist(d, m), st,
                                  device=dev)
    scatter = sketching.saso_left_apply(op, A, method="scatter")
    again = sketching.saso_left_apply(op, A, method="scatter")
    gather = sketching.saso_left_apply(op, A, method="gather")
    sc_ms = cuda_ms(lambda: sketching.saso_left_apply(
        op, A, method="scatter"), 5)
    ga_ms = cuda_ms(lambda: sketching.saso_left_apply(
        op, A, method="gather"), 5)
    sop, _ = sketching.srht_skop(d, m, st, device=dev)
    srht_ms = cuda_ms(lambda: sketching.srht_left_apply(sop, A), 5)
    agree = float(torch.linalg.norm(scatter - gather)
                  / torch.linalg.norm(gather))
    bit_equal = torch.equal(scatter, again)
    runs_apart = float((scatter - again).abs().max() / gather.abs().max())
    print(f"[cqrrpt-sketch] {m}x{n} f32 to d={d}: saso scatter "
          f"{sc_ms:.4f} ms, gather {ga_ms:.4f} ms, scatter vs gather rel "
          f"{agree:.3e}, two scatter runs bit-equal {bit_equal} (max|diff| "
          f"{runs_apart:.3e} of max|SA|), fill_sparse {gen_ms:.4f} ms; srht "
          f"{srht_ms:.4f} ms; K7 gaussian_sketch {k7_ms:.4f} ms (kernel "
          f"phase)", flush=True)
    gate(agree <= 1e-5, f"saso scatter vs gather {agree}")
    del scatter, again, gather, op, sop

    # -- K5/K6 at this path's shapes against their plain versions -----------
    phase_cqrrpt_kernels(dev, A, d)
    del A
    phase_cqrrpt_small_vs_plain(dev)
    return hq_counts


def rsvd_checks(tag, A, U, S, Vt, err, k) -> tuple:
    """The gates every [rsvd…] run holds: U and Vᵀ orthonormal to
    10·eps32^0.75·√k (PERF.md §2's rule at f32), S finite and descending,
    and err (QB's relative Frobenius error) consistent with the SVD's own
    ‖A − U·diag(S)·Vt‖_F/‖A‖_F within 1e-5; all in f64. Returns
    (residual, orthogonality of U, of Vt)."""
    Ad = A.double()
    res = float(torch.linalg.norm(Ad - (U.double() * S.double()) @ Vt.double())
                / torch.linalg.norm(Ad))
    eye = torch.eye(k, dtype=torch.float64, device=A.device)
    orth_u = float(torch.linalg.norm(U.double().T @ U.double() - eye))
    orth_v = float(torch.linalg.norm(Vt.double() @ Vt.double().T - eye))
    gate(tuple(U.shape) == (A.shape[0], k) and tuple(Vt.shape)
         == (k, A.shape[1]) and tuple(S.shape) == (k,), f"{tag}: shapes")
    gate(bool(torch.isfinite(U).all() and torch.isfinite(S).all()
              and torch.isfinite(Vt).all()), f"{tag}: non-finite output")
    gate(bool((S[:-1] >= S[1:]).all()), f"{tag}: S not descending")
    gate(abs(res - err) <= 1e-5, f"{tag}: err {err} against the SVD's "
         f"residual {res}")
    gate(max(orth_u, orth_v) <= RSVD_ORTH_GATE,
         f"{tag}: orthogonality U {orth_u}, Vt {orth_v}")
    return res, orth_u, orth_v


def plain_qb_err(A, omegas) -> float:
    """The relative Frobenius error of blocked randomized QB with one
    power iteration and no oversampling (Halko, Martinsson and Tropp
    2011, algorithm 4.4; blocked as Martinsson and Voronin 2016), written
    straight from the papers with a Householder QR at every step: for
    each start Ω, Y = W·Ω, Y = Wᵀ·Y, Y = W·Y (orthonormalized in
    between), Qᵢ = orth(Y − Q·QᵀY), W ← W − Qᵢ·QᵢᵀW. None of the port's
    code runs here."""
    W, Q = A.clone(), A.new_zeros((A.shape[0], 0))
    for om in omegas:
        Y = torch.linalg.qr(W @ om).Q
        Y = torch.linalg.qr(W.T @ Y).Q
        Y = W @ Y
        Qi = torch.linalg.qr(Y - Q @ (Q.T @ Y)).Q
        W = W - Qi @ (Qi.T @ W)
        Q = torch.cat([Q, Qi], 1)
    return float(torch.linalg.norm(W) / torch.linalg.norm(A))


def phase_rsvd(dev, card: str) -> None:
    """BASELINE config 1 through rsvd_fixed_rank (bench.py:336-357):
    best of 5 after a warm-up, GFLOP/s by bench.py's 12·m·n·k, peak
    memory, gates against the optimal rank-256 tail; the phase split
    (qb_blocked, svd_econ of B, U = Q·Û, each timed around its public
    call); the three SVD routes on B; [svd-jacobi] against the f64 SVD of
    B."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import QBConfig, qb_blocked
    from randlapack_tpu_torch.drivers import RSVDConfig, rsvd_fixed_rank
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.ops.svd import svd_econ
    n, k = RSVD_N, RSVD_K
    A, st = fast_decay_matrix(n, n, RNGState(1), decay=80.0, device=dev)
    cfg = RSVDConfig(QBConfig(block_size=RSVD_B))
    (U, S, Vt, err, _), times, counts, peak = timed_run(
        lambda: rsvd_fixed_rank(A, k, cfg, st), 5)
    t, err = min(times), float(err)
    sig = torch.linalg.svdvals(A.double())
    tail = float(torch.linalg.norm(sig[k:]) / torch.linalg.norm(sig))
    PRECISION_INPUT["rsvd_tail"] = tail
    res, orth_u, orth_v = rsvd_checks("rsvd", A, U, S, Vt, err, k)
    print(f"[rsvd] rsvd_fixed_rank {n}x{n} f32 fast-decay (decay 80), rank "
          f"{k}, QB block {RSVD_B} on {card}: runs "
          f"{[round(x, 4) for x in times]} s, best {t:.4f} s = "
          f"{12.0 * n * n * k / t / 1e9:.1f} GFLOP/s (12mnk); QB err "
          f"{err:.4e} against the optimal tail {tail:.4e} (x{err / tail:.3f}"
          f"), |A - U S Vt|/|A| {res:.4e}, orth U {orth_u:.3e} Vt "
          f"{orth_v:.3e} (gate {RSVD_ORTH_GATE:.2e}), sigma "
          f"{float(S[0]):.4e}..{float(S[-1]):.4e}, peak memory {peak:.3f} "
          f"GiB, launches {counts}", flush=True)
    gate(err <= RSVD_TAIL_FACTOR * tail, f"rsvd: err {err} against "
         f"{RSVD_TAIL_FACTOR} x the optimal rank-{k} tail {tail}")
    gate(counts == NO_LAUNCHES, f"rsvd: launches {counts}")
    del U, Vt
    # the second witness of QB's error: the timed runs' starts (drawn
    # here as qb_blocked draws them, block i from state.branch(i)) and
    # three other draws, each injected into the port in f32 and in f64 and
    # into plain_qb_err, an independent f64 QB with Householder QR at
    # every step (the same range in exact arithmetic)
    Ad = A.double()
    rows = []
    for seed in (None, 11, 12, 13):
        s0 = st if seed is None else RNGState(seed)
        om = [torch.randn((n, RSVD_B), generator=s0.branch(i).spawn(dev)[0],
                          device=dev) for i in range(k // RSVD_B)]
        e32 = float(rsvd_fixed_rank(A, k, cfg, s0, omegas=om)[3])
        e64 = float(rsvd_fixed_rank(Ad, k, cfg, s0,
                                    omegas=[o.double() for o in om])[3])
        rows.append((e32, e64, plain_qb_err(Ad, [o.double() for o in om])))
    print(f"[rsvd-draws] QB err / optimal tail (port f32, port f64, plain "
          f"f64 QB) for the timed runs' starts and three other draws: "
          + "; ".join(f"{a / tail:.4f}, {b / tail:.4f}, {c / tail:.4f}"
                      for a, b, c in rows), flush=True)
    gate(abs(rows[0][0] - err) <= 1e-4 * err, f"rsvd: the redrawn starts "
         f"give err {rows[0][0]}, the timed runs {err}")
    for e32, e64, e_ref in rows:
        gate(abs(e32 - e_ref) <= 1e-3 * e_ref and abs(e64 - e_ref)
             <= 1e-8 * e_ref, f"rsvd: err f32 {e32}, f64 {e64} against the "
             f"plain f64 QB's {e_ref}")
        gate(e32 <= RSVD_TAIL_FACTOR * tail, f"rsvd: err {e32} against "
             f"{RSVD_TAIL_FACTOR} x the optimal rank-{k} tail {tail}")
    del sig, Ad

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    _, t_prof, rows = device_profile(lambda: rsvd_fixed_rank(A, k, cfg, st))
    busy = sum(ms for _, ms, _ in rows)
    gate(busy > 0, "rsvd: the profiler saw no device time")
    print(f"[rsvd-profile] one call under torch.profiler: {t_prof:.4f} s, "
          f"{sum(c for *_, c in rows)} device launches, the card busy "
          f"{busy:.2f} ms ({100 * busy / 1e3 / t_prof:.1f} %, idle "
          f"{100 - 100 * busy / 1e3 / t_prof:.1f} %); top: " + "; ".join(
              f"{key[:50]} {ms:.2f} ms/{cnt}" for key, ms, cnt in rows[:8]),
          flush=True)
    (Q, B, _, _), t_qb = timed(lambda: qb_blocked(A, k, cfg.qb, st))
    (Ub, S, Vt), t_svd = timed(lambda: svd_econ(B, cfg.svd_method))
    _, t_u = timed(lambda: Q @ Ub)
    print(f"[rsvd-phases] qb_blocked {t_qb:.4f} s, svd_econ of B "
          f"{tuple(B.shape)} {t_svd:.4f} s, U = Q Ub {t_u:.4f} s; "
          f"{t_qb + t_svd + t_u:.4f} s against {t:.4f} s best untimed "
          f"({k // RSVD_B} blocks, each with 4 host reads: the Householder-"
          f"fallback flags of rf and of the re-orthogonalization, the "
          f"pivots of RS's two PLU stabilizations)", flush=True)
    routes, outs = {}, {}
    for method in ("xla", "gram_eigh", "jacobi", "default driver"):
        fn = ((lambda M: tuple(torch.linalg.svd(M, full_matrices=False)))
              if method == "default driver" else
              (lambda M: svd_econ(M, method)))
        fn(B[:8, :64])                                     # warm-up
        outs[method], routes[method] = timed(lambda: fn(B))
    Uj, Sj, Vtj = outs["jacobi"]
    Bd = B.double()
    _, s64, _ = torch.linalg.svd(Bd, full_matrices=False)
    top = s64 >= 1e-3 * s64[0]
    s_err = float(((Sj.double() - s64).abs() / s64)[top].max())
    trip = float(torch.linalg.vector_norm(
        Bd @ Vtj.double().T - Uj.double() * Sj.double(), dim=0).max()
        / s64[0])
    def orth2(U, Vt):
        return max(float(torch.linalg.norm(
            M.double().T @ M.double() - torch.eye(
                M.shape[1], dtype=torch.float64, device=dev)))
            for M in (U, Vt.T))

    print(f"[svd-routes] svd_econ of B {tuple(B.shape)} f32 (one call each, "
          f"after a warm-up call on an 8x64 corner; 'default driver' is "
          f"torch.linalg.svd as the library picks it): " + ", ".join(
              f"{m_} {v:.4f} s (max |UtU-I|_F, |VtVt^T-I|_F "
              f"{orth2(outs[m_][0], outs[m_][2]):.2e})"
              for m_, v in routes.items()), flush=True)
    print(f"[svd-jacobi] svd_econ(B, 'jacobi') {tuple(B.shape)} f32: "
          f"{routes['jacobi']:.4f} s; against the f64 SVD of B: max "
          f"relative error of sigma >= 1e-3 sigma_1 ({int(top.sum())} "
          f"values) {s_err:.3e}, max |B v_i - sigma_i u_i|/sigma_1 "
          f"{trip:.3e}", flush=True)
    gate(s_err <= 1e-5, f"svd-jacobi: sigma relative error {s_err}")
    gate(trip <= 1e-5, f"svd-jacobi: triplet residual {trip}")


def library_default_svd(B):
    """``torch.linalg.svd`` with the library's default card driver
    (``gesvdj``): the route ``svd_econ("xla")`` took on the card before it
    reduced B by a Householder QR and took ``gesvd`` of R."""
    return tuple(torch.linalg.svd(B, full_matrices=False))


def phase_svd_route_turns(dev) -> None:
    """What the card route of ``svd_econ("xla")`` costs and saves, against
    the library's default driver, in turns (old, new, new, old) after a
    warm-up of each: KRILL's full-size f32 solve through
    ``krill_full_rpchol`` and, apart, its preconditioner build
    (``rpchol_pc_data``: RPCholesky and the SVD of F) and PCG; config 1's
    RSVD, best of 3 a turn."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import (PCGConfig, QBConfig, pcg,
                                            rpchol_pc_data)
    from randlapack_tpu_torch.drivers import (KrillConfig, RSVDConfig,
                                              krill_full_rpchol,
                                              rsvd_fixed_rank)
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.linops import SpectralPrecond
    from randlapack_tpu_torch.ops import svd as tsvd
    mu = 1e-2
    G, H = krill_problem(KRILL_N, 1, mu, dev)
    mus = torch.full((1,), mu, dtype=H.dtype, device=dev)
    A, st = fast_decay_matrix(RSVD_N, RSVD_N, RNGState(1), decay=80.0,
                              device=dev)
    kcfg = KrillConfig(k=KRILL_K, rpchol_block=64,
                       pcg=PCGConfig(tol=1e-5, max_iters=200))
    rcfg = RSVDConfig(QBConfig(block_size=RSVD_B))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def turn():
        (_, _, iters, _), t_krill = timed(lambda: krill_full_rpchol(
            G, H, mu, kcfg, RNGState(6)))
        (V, lam, _, _), t_pc = timed(lambda: rpchol_pc_data(
            G.with_reg(False), KRILL_K, RNGState(6), block_size=64))
        P = SpectralPrecond.prep(V, lam, mus)
        _, t_pcg = timed(lambda: pcg(G.with_reg(True), H, P,
                                     torch.zeros_like(H), kcfg.pcg))
        t_rsvd = min(timed(lambda: rsvd_fixed_rank(A, RSVD_K, rcfg, st))[1]
                     for _ in range(3))
        return t_krill, iters, t_pc, t_pcg, t_rsvd

    route, runs = tsvd._svd_library, {"old": [], "new": []}
    try:
        for i, which in enumerate(("old", "new", "old", "new", "new",
                                   "old")):
            tsvd._svd_library = (library_default_svd if which == "old"
                                 else route)
            row = turn()
            if i >= 2:                    # the first two are the warm-ups
                runs[which].append(row)
    finally:
        tsvd._svd_library = route
    print("[svd-route-turns] svd_econ('xla') on the card, the library's "
          "default driver (old) against QR then gesvd of R (new), in turns "
          "after a warm-up of each: krill_full_rpchol n=65536 f32 k=1024 s, "
          "iterations, rpchol_pc_data s, pcg s; rsvd config 1 best of 3 s: "
          + "; ".join(f"{w} " + ", ".join(
              f"({a:.4f}, {i}, {b:.4f}, {c:.4f}, {d:.4f})"
              for a, i, b, c, d in runs[w]) for w in ("old", "new")),
          flush=True)


def phase_rsvd_8192(dev, card: str) -> None:
    """Config 1's recipe at BASELINE.md's 8192² target shape, rank 256,
    best of 3."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import QBConfig
    from randlapack_tpu_torch.drivers import RSVDConfig, rsvd_fixed_rank
    from randlapack_tpu_torch.gen import fast_decay_matrix
    n, k = 2 * RSVD_N, RSVD_K
    A, st = fast_decay_matrix(n, n, RNGState(1), decay=80.0, device=dev)
    cfg = RSVDConfig(QBConfig(block_size=RSVD_B))
    (U, S, Vt, err, _), times, counts, peak = timed_run(
        lambda: rsvd_fixed_rank(A, k, cfg, st), 3)
    t, err = min(times), float(err)
    res, orth_u, orth_v = rsvd_checks("rsvd-8192", A, U, S, Vt, err, k)
    gate(counts == NO_LAUNCHES, f"rsvd-8192: launches {counts}")
    print(f"[rsvd-8192] rsvd_fixed_rank {n}x{n} f32 fast-decay (decay 80), "
          f"rank {k} on {card}: runs {[round(x, 4) for x in times]} s, best "
          f"{t:.4f} s = {12.0 * n * n * k / t / 1e9:.1f} GFLOP/s (12mnk); QB "
          f"err {err:.4e}, |A - U S Vt|/|A| {res:.4e}, orth U "
          f"{orth_u:.3e} Vt {orth_v:.3e}, peak memory {peak:.3f} GiB",
          flush=True)


def phase_revd2(dev, card: str) -> dict:
    """REVD2 over the implicit kernel operator at KRILL's full size (the
    [krill] points, n 65536, d 8, unregularized), rank 1024, f32: warm-up,
    best of 2, then one run with CUDA events around each K4 launch for its
    share; the port's LUs against the library's default backend; gates on
    fail, orthogonality, λ, 15 K4 launches a call and the top-8 eigenpair
    residuals (K·v by K4). Returns the launch counts of one call."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import REVD2Config, revd2_fixed_rank
    G, _ = krill_problem(KRILL_N, 1, 0.0, dev)
    op = G.with_reg(False)
    k, cfg = REVD2_K, REVD2Config()
    (V, lam, est, nu, fail, _), times, counts, peak = timed_run(
        lambda: revd2_fixed_rank(op, k, cfg, RNGState(4)), 2)
    t = min(times)
    gate(counts == REVD2_LAUNCHES, f"revd2-kernel: launches {counts}")
    gate(not bool(fail), "revd2-kernel: fail flag raised")
    # K4's device time inside one call, by CUDA events around each launch
    # (torch.profiler's tables take minutes here: cuSOLVER's SVD launches
    # tens of thousands of small kernels)
    from randlapack_tpu_torch import pdkernels
    launch, spans = pdkernels.kernel_matmat, []

    def timed_launch(*args):
        span = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        span[0].record()
        result = launch(*args)
        span[1].record()
        spans.append(span)
        return result

    pdkernels.kernel_matmat = timed_launch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        revd2_fixed_rank(op, k, cfg, RNGState(4))
        torch.cuda.synchronize()
        t_ev = time.perf_counter() - t0
    finally:
        pdkernels.kernel_matmat = launch
    k4_each = [a.elapsed_time(b) for a, b in spans]
    k4 = sum(k4_each)
    gate(len(spans) == 15 and k4 > 0, f"revd2-kernel: {len(spans)} timed "
         f"K4 launches")
    orth = float(torch.linalg.norm(V.double().T @ V.double() - torch.eye(
        k, dtype=torch.float64, device=dev)))
    gate(orth <= 10 * EPS32 ** 0.75 * math.sqrt(k),
         f"revd2-kernel: orthogonality {orth}")
    gate(bool((lam >= 0).all() and (lam[:-1] >= lam[1:]).all()),
         "revd2-kernel: lambda negative or not descending")
    l1 = float(lam[0])
    KV = op.matmat(V[:, :8].contiguous())
    eres = (torch.linalg.vector_norm(KV - V[:, :8] * lam[:8], dim=0)
            / l1).tolist()
    gate(max(eres) <= 1e-3, f"revd2-kernel: eigenpair residuals {eres}")
    # the port's LUs (ops.qr.lu_factor: REVD2's PLU stabilization at this
    # shape, config 1's at 4096x64, BQRRP's pivot pass on an 8192x256
    # transposed sketch panel) against the library's own choice of backend
    from randlapack_tpu_torch.ops.qr import lu_factor
    lu_rows = []
    for shape in ((KRILL_N, k), (RSVD_N, RSVD_B), (N, 256)):
        Y = torch.randn(shape, device=dev)
        piv_lib = torch.linalg.lu_factor_ex(Y)[1]
        piv_port = lu_factor(Y)[1]
        lu_rows.append((shape, cuda_ms(lambda: torch.linalg.lu_factor_ex(Y),
                                       3, warmup=1),
                        cuda_ms(lambda: lu_factor(Y), 3, warmup=1),
                        torch.equal(piv_lib, piv_port)))
    del Y
    gate(torch.backends.cuda.preferred_linalg_library()
         == torch._C._LinalgBackend.Default,
         "lu_factor left the linalg backend changed")
    print("[revd2-lu] lu_factor_ex f32, the library's default backend "
          "against ops.qr.lu_factor (cuSOLVER): " + "; ".join(
              f"{m_}x{n_} {a_:.2f} ms against {b_:.2f} ms, pivots equal "
              f"{eq}" for (m_, n_), a_, b_, eq in lu_rows), flush=True)
    print(f"[revd2-kernel] revd2_fixed_rank over SquaredExpKernelLinOp n="
          f"{KRILL_N} d=8 f32 (bandwidth {G.bandwidth:.3f}), k={k} on "
          f"{card}: runs {[round(x, 4) for x in times]} s, best {t:.4f} s; "
          f"a call with CUDA events around each K4 launch {t_ev:.4f} s, K4 "
          f"{k4:.1f} ms ({100 * k4 / 1e3 / t_ev:.1f} % of it; the five at "
          f"s={k} {sum(k4_each[:5]):.1f} ms, the ten at s=1 "
          f"{sum(k4_each[5:]):.1f} ms); fail {bool(fail)}, |V^T V - "
          f"I|_F {orth:.3e}, lambda {l1:.4e}..{float(lam[-1]):.4e}, err_est/"
          f"lambda_1 {float(est) / l1:.3e}, nu {float(nu):.4e}, top-8 "
          f"|K v - lambda v|/lambda_1 max {max(eres):.3e}; peak memory "
          f"{peak:.3f} GiB; launches {counts}", flush=True)
    return counts


def phase_nystrom(dev, card: str) -> None:
    """nystrom_pc_data (adaptive REVD2 from k 64, tol 1e-6) over the
    [krill] recipe's points at n 8192; its top-8 λ against eigvalsh of the
    dense kernel matrix in f64 on the card."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import nystrom_pc_data
    from randlapack_tpu_torch.pdkernels import squared_exp_kernel
    n = 8192
    G, _ = krill_problem(n, 1, 0.0, dev)
    op = G.with_reg(False)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    V, lam, k_used, _ = nystrom_pc_data(op, 64, RNGState(5), 1e-2, tol=1e-6)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    Xd = op.X.double()
    w = torch.linalg.eigvalsh(squared_exp_kernel(Xd, Xd, op.bandwidth))
    w = w.flip(0)[:8]
    rel = ((lam[:8].double() - w).abs() / w).tolist()
    print(f"[nystrom] nystrom_pc_data n={n} d=8 f32 (bandwidth "
          f"{op.bandwidth:.3f}) from k 64, tol 1e-6 on {card}: {secs:.4f} s, "
          f"k_used {k_used}, K4 launches {counts['kernel_matmat']}; top-8 "
          f"lambda against the dense f64 eigvalsh: max relative "
          f"{max(rel):.3e} (lambda_1 {float(w[0]):.4e})", flush=True)
    gate(max(rel) <= 1e-3, f"nystrom: top-8 lambda relative errors {rel}")
    gate(counts["kernel_matmat"] > 0 and counts == {
        **NO_LAUNCHES, "kernel_matmat": counts["kernel_matmat"],
        "kernel_matmat_wide": counts["kernel_matmat_wide"]},
        f"nystrom: launches {counts}")


def event_runs(fn, reps: int):
    """``fn()`` ``reps`` times after one warm-up, each run timed by CUDA
    events: the last output, the seconds of each run, the launch counts
    and the peak device memory (GiB, inputs included) of the last run,
    and that peak above what was allocated before it."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    peak = torch.cuda.max_memory_allocated()
    return out, times, read_counts(), peak / 2 ** 30, (peak - base) / 2 ** 30


def profile_summary(fn, top: int = 8) -> tuple:
    """``fn()`` under torch.profiler: wall seconds, device launches, busy
    ms, idle share and the ``top`` device rows as text."""
    _, wall, rows = device_profile(fn)
    busy = sum(ms for _, ms, _ in rows)
    gate(busy > 0, "the profiler saw no device time")
    text = "; ".join(f"{key[:48]} {ms:.2f} ms/{cnt}"
                     for key, ms, cnt in rows[:top])
    return wall, sum(c for *_, c in rows), busy, \
        100 - 100 * busy / 1e3 / wall, text


def abrik_problem(dev):
    """BASELINE config 5's input (bench.py:482-500): the 8192x4096 f32
    fast_decay_matrix(decay=12) from RNGState(5), the state it returns and
    ABRIK's configuration (b 64, q 4)."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import ABRIKConfig
    from randlapack_tpu_torch.gen import fast_decay_matrix
    A, st = fast_decay_matrix(ABRIK_M, ABRIK_N, RNGState(5), decay=12.0,
                              device=dev)
    return A, st, ABRIKConfig(block_size=ABRIK_B, max_iters=ABRIK_Q)


def triplet0(A, U, S, Vt) -> float:
    """bench.py's ‖A v₀ − σ₀u₀‖ (f64)."""
    return float(torch.linalg.norm(A.double() @ Vt[0].double()
                                   - S[0].double() * U[:, 0].double()))


# config 5's time, triplet-0 residual and S, for [abrik-vs-rsvd]
ABRIK_RESULT = {}


def phase_abrik(dev, card: str) -> dict:
    """BASELINE config 5 through abrik (bench.py:482-500): best of 3 by
    CUDA events after a warm-up, GFLOP/s by bench.py's 8·m·n·k·4, peak
    memory and the triplet-0 residual (reported: the spectrum is nearly
    flat at the top, so four iterations need not converge it). Gates, on
    abrik_factor with the timed runs' start: the bases' orthogonality,
    the Krylov relation A·V = U·B, the top σ against the same call in
    f64, and no kernel launch. Returns the launch counts."""
    from randlapack_tpu_torch.drivers import abrik, abrik_factor
    A, st, cfg = abrik_problem(dev)
    m, n, k = ABRIK_M, ABRIK_N, ABRIK_K
    (U, S, Vt, info, _), times, counts, peak, above = event_runs(
        lambda: abrik(A, k, cfg, st), 3)
    t = min(times)
    r0 = triplet0(A, U, S, Vt)
    v0 = torch.randn((n, ABRIK_B), generator=st.spawn(dev)[0], device=dev)
    Ub, Vb, B, cap, iters, _ = abrik_factor(A, st, cfg, v0=v0)
    Ad = A.double()
    K = ABRIK_B * ABRIK_Q
    eye = torch.eye(K, dtype=torch.float64, device=dev)
    orth_u = float(torch.linalg.norm(Ub.double().T @ Ub.double() - eye))
    orth_v = float(torch.linalg.norm(Vb.double().T @ Vb.double() - eye))
    kry = float(torch.linalg.norm(Ad @ Vb.double() - Ub.double() @ B.double())
                / torch.linalg.norm(Ad))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, S64, _, info64, _ = abrik(Ad, k, cfg, st, v0=v0.double())
    PRECISION_INPUT["abrik_S64"] = S64
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    sgap = float((S.double() - S64).abs().max() / S64[0])
    print(f"[abrik] abrik {m}x{n} f32 fast-decay (decay 12), k {k}, block "
          f"{ABRIK_B}, {ABRIK_Q} iterations (BASELINE config 5) on {card}: "
          f"runs {[round(x, 5) for x in times]} s (CUDA events), best "
          f"{t:.5f} s = {8.0 * m * n * k * 4 / t / 1e9:.1f} GFLOP/s "
          f"(8mnk*4); triplet-0 residual |A v0 - s0 u0| {r0:.4e} (reported; "
          f"s0 {float(S[0]):.4e}); iterations {info['num_krylov_iters']}; "
          f"abrik_factor on the same start: |Ub^T Ub - I|_F {orth_u:.3e}, "
          f"|Vb^T Vb - I|_F {orth_v:.3e} (gate {ABRIK_ORTH_GATE:.3e}), "
          f"|A Vb - Ub B|_F/|A|_F {kry:.3e} (gate 1e-4); top {k} sigma "
          f"against the f64 call ({t64:.3f} s): max |ds|/s0 {sgap:.3e} (gate "
          f"1e-4); peak memory {peak:.3f} GiB, {above:.3f} GiB above the "
          f"tensors allocated before the call; launches {counts}",
          flush=True)
    gate(info["num_krylov_iters"] == ABRIK_Q and iters == ABRIK_Q
         and info64["num_krylov_iters"] == ABRIK_Q, "abrik: iterations")
    gate(bool(torch.isfinite(U).all() and torch.isfinite(S).all()
              and torch.isfinite(Vt).all()) and tuple(U.shape) == (m, k)
         and tuple(Vt.shape) == (k, n), "abrik: output shape or finiteness")
    gate(max(orth_u, orth_v) <= ABRIK_ORTH_GATE,
         f"abrik: orthogonality U {orth_u}, V {orth_v}")
    gate(kry <= 1e-4, f"abrik: Krylov relation {kry}")
    gate(sgap <= 1e-4, f"abrik: sigma against f64 {sgap}")
    gate(counts == NO_LAUNCHES, f"abrik: launches {counts}")
    ABRIK_RESULT.update(seconds=t, triplet0=r0, S=S)
    return counts



def phase_abrik_phases(dev) -> None:
    """Config 5's timing=True split (the 13 slots of rl_abrik.hh:734 the
    JAX package fills: every phase synced, all q iterations) and one
    untimed call under torch.profiler: card busy and idle share, top
    device rows."""
    from randlapack_tpu_torch.drivers import abrik, abrik_factor
    from randlapack_tpu_torch.ops.svd import svd_econ
    A, st, cfg = abrik_problem(dev)
    abrik(A, ABRIK_K, cfg, st, timing=True)
    *_, report = abrik(A, ABRIK_K, cfg, st, timing=True)
    wall, launches, busy, idle, text = profile_summary(
        lambda: abrik(A, ABRIK_K, cfg, st))
    # the band factor's SVD (get_factors) by route, on this run's B
    B = abrik_factor(A, st, cfg)[2]
    routes = {"xla (the port's)": lambda: svd_econ(B, "xla"),
              "default driver": lambda: torch.linalg.svd(
                  B, full_matrices=False),
              "gram_eigh": lambda: svd_econ(B, "gram_eigh"),
              "host LAPACK": lambda: torch.linalg.svd(
                  B.cpu(), full_matrices=False)}
    svd_ms = {}
    for name, fn in routes.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        svd_ms[name] = (time.perf_counter() - t0) * 1e3
    print(f"[abrik-phases] timing=True: " + ", ".join(
        f"{k_} {v:.5f} s" for k_, v in report.items())
          + f"; one call under torch.profiler {wall:.5f} s, {launches} "
          f"device launches, card busy {busy:.2f} ms (idle {idle:.1f} %; "
          f"{ABRIK_Q - 2} host reads of the stop flag); top: {text}; the "
          f"SVD of the {tuple(B.shape)} band factor, one warm call each: "
          + ", ".join(f"{k_} {v:.2f} ms" for k_, v in svd_ms.items()),
          flush=True)


def phase_abrik_vs_rsvd(dev) -> None:
    """bench.py:502-524 on config 5's A: rsvd_fixed_rank at rank 64 with
    QBConfig(block_size=64), best of 3 by CUDA events; both times, both
    triplet-0 residuals and the largest relative sigma gap (reported)."""
    from randlapack_tpu_torch.comps import QBConfig
    from randlapack_tpu_torch.drivers import RSVDConfig, rsvd_fixed_rank
    A, st, _ = abrik_problem(dev)
    cfg = RSVDConfig(QBConfig(block_size=ABRIK_B))      # 64, as bench.py
    (U, S, Vt, err, _), times, counts, peak, _ = event_runs(
        lambda: rsvd_fixed_rank(A, ABRIK_K, cfg, st), 3)
    r0 = triplet0(A, U, S, Vt)
    S_ab = ABRIK_RESULT["S"]
    gap = float(((S_ab - S).abs() / S.clamp(min=1e-30)).max())
    print(f"[abrik-vs-rsvd] rank {ABRIK_K} on config 5's A: abrik "
          f"{ABRIK_RESULT['seconds']:.5f} s, rsvd_fixed_rank (QB block 64) "
          f"runs {[round(x, 5) for x in times]} s, best {min(times):.5f} s; "
          f"triplet-0 residual abrik {ABRIK_RESULT['triplet0']:.4e}, rsvd "
          f"{r0:.4e}; largest relative sigma gap {gap:.4e}; rsvd QB err "
          f"{float(err):.4e}, peak {peak:.3f} GiB, launches "
          f"{'none' if counts == NO_LAUNCHES else counts}", flush=True)
    gate(counts == NO_LAUNCHES, f"abrik-vs-rsvd: launches {counts}")


def phase_abrik_sparse(dev, card: str) -> None:
    """bench.py:646-690: ABRIK (b 64, q 4, k 64, RNGState(22)) over
    SparseLinOp.from_dense of an 8192x4096 matrix from
    gen_exp_singvals(4096, 1e6) masked to density 0.01 and 0.05
    (RNGState(21)), against the same call on the dense tensor: nnz, both
    times (best of 3), their ratio and the sigma gap (gate 1e-4
    relative); one matmat and one tmatmat at 64 columns against the dense
    A @ X and A.T @ Y in turns, two calls' bit-equality (also under
    PyTorch's deterministic mode), and tmatmat's device launches under
    torch.profiler."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import abrik
    from randlapack_tpu_torch.gen import (gen_exp_singvals,
                                          gen_sparse_from_singvals)
    from randlapack_tpu_torch.linops import SparseLinOp
    _, _, cfg = abrik_problem(dev)
    m, n, k = ABRIK_M, ABRIK_N, ABRIK_K
    sv = gen_exp_singvals(n, 1e6, torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(8)
    X = torch.randn((n, k), generator=g, device=dev)
    Y = torch.randn((m, k), generator=g, device=dev)
    for dens in (0.01, 0.05):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        Ad, _ = gen_sparse_from_singvals(m, n, sv, dens, RNGState(21))
        op = SparseLinOp.from_dense(Ad)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        p_gen = torch.cuda.max_memory_allocated() / 2 ** 30
        (_, S_sp, _, _, _), t_sp, c_sp, p_sp, _ = event_runs(
            lambda: abrik(op, k, cfg, RNGState(22)), 3)
        (_, S_dn, _, _, _), t_dn, c_dn, p_dn, _ = event_runs(
            lambda: abrik(Ad, k, cfg, RNGState(22)), 3)
        gap = float(((S_sp - S_dn).abs() / S_dn.clamp(min=1e-30)).max())
        mm = in_turns(lambda: Ad @ X, lambda: op.matmat(X), 20)
        tm = in_turns(lambda: Ad.T @ Y, lambda: op.tmatmat(Y), 20)
        same = (torch.equal(op.matmat(X), op.matmat(X)),
                torch.equal(op.tmatmat(Y), op.tmatmat(Y)))
        # does PyTorch's deterministic mode change the SpMM it picks?
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            same_det = torch.equal(op.tmatmat(Y), op.tmatmat(Y))
        finally:
            torch.use_deterministic_algorithms(False)
        _, _, rows = device_profile(
            lambda: [op.tmatmat(Y) for _ in range(5)])
        print(f"[abrik-sparse] density {dens}: nnz {op.nnz} "
              f"({op.nnz / (m * n):.4f}; int32 CSR indices "
              f"{op.A.crow_indices().dtype == torch.int32}), generated and "
              f"converted in {t_gen:.3f} s at a peak of {p_gen:.3f} GiB; "
              f"abrik over SparseLinOp best "
              f"{min(t_sp):.5f} s {[round(x, 5) for x in t_sp]}, over the "
              f"dense tensor best {min(t_dn):.5f} s; sparse/dense "
              f"{min(t_sp) / min(t_dn):.3f}; max relative sigma gap "
              f"{gap:.3e} (gate 1e-4); peak {p_sp:.3f} / {p_dn:.3f} GiB; "
              f"at {k} columns, in turns: A@X dense {mm[0]:.4f} ms, CSR "
              f"{mm[1]:.4f} ms; A^T@Y dense {tm[0]:.4f} ms, CSR of A^T "
              f"{tm[1]:.4f} ms; two calls bit-equal matmat {same[0]}, "
              f"tmatmat {same[1]} (tmatmat under torch.use_deterministic_"
              f"algorithms {same_det}); five tmatmat calls on the card: "
              + "; ".join(f"{key[:60]} x{cnt}" for key, _, cnt in rows),
              flush=True)
        gate(gap <= 1e-4, f"abrik-sparse {dens}: sigma gap {gap}")
        gate(c_sp == NO_LAUNCHES and c_dn == NO_LAUNCHES,
             f"abrik-sparse: launches {c_sp} {c_dn}")
        del Ad, op


def phase_cholqr_linops_sparse(dev, card: str) -> None:
    """bench.py:691-712: cholqr_linops over SparseLinOp.from_dense of a
    65536x1024 matrix from gen_exp_singvals(1024, 1e4) at density 0.02
    (RNGState(23)) and over the DenseLinOp of the same array, best of 3
    each, and gram_block=256 on the sparse operator with its peak memory
    against the one-shot run's. Gates: fail equal; where False, both R
    within 1e-4 relative; ‖RᵀR − AᵀA‖_F/‖AᵀA‖_F reported."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import (CholQRLinopsConfig,
                                              cholqr_linops)
    from randlapack_tpu_torch.gen import (gen_exp_singvals,
                                          gen_sparse_from_singvals)
    from randlapack_tpu_torch.linops import DenseLinOp, SparseLinOp
    m, n = 65536, 1024
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    At, _ = gen_sparse_from_singvals(
        m, n, gen_exp_singvals(n, 1e4, torch.float32, device=dev), 0.02,
        RNGState(23))
    op, dop = SparseLinOp.from_dense(At), DenseLinOp(At)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    p_gen = torch.cuda.max_memory_allocated() / 2 ** 30
    runs = {}
    for name, A_, cfg in (("sparse", op, CholQRLinopsConfig()),
                          ("dense", dop, CholQRLinopsConfig()),
                          ("sparse gram_block 256", op,
                           CholQRLinopsConfig(gram_block=256))):
        (R, fail, _), times, counts, peak, above = event_runs(
            lambda: cholqr_linops(A_, cfg), 3)
        gate(counts == NO_LAUNCHES, f"cholqr-linops {name}: launches")
        runs[name] = (R, bool(fail), min(times), peak, above)
    Ad = At.double()
    G = Ad.T @ Ad
    errs = {name: float(torch.linalg.norm(r[0].double().T @ r[0].double()
                                          - G) / torch.linalg.norm(G))
            for name, r in runs.items()}
    Rs, Rd = runs["sparse"][0], runs["dense"][0]
    dR = float(torch.linalg.norm(Rs - Rd) / torch.linalg.norm(Rd))
    dRb = float(torch.linalg.norm(runs["sparse gram_block 256"][0] - Rd)
                / torch.linalg.norm(Rd))
    print(f"[cholqr-linops-sparse] cholqr_linops {m}x{n} f32, density 0.02 "
          f"(nnz {op.nnz}; generated and converted in {t_gen:.3f} s at a "
          f"peak of {p_gen:.3f} GiB) on {card}: " + "; ".join(
              f"{name} best {r[2]:.5f} s, fail {r[1]}, peak {r[3]:.3f} GiB "
              f"({r[4]:.3f} above the inputs), |R^T R - A^T A|_F/|A^T A|_F "
              f"{errs[name]:.3e}" for name, r in runs.items())
          + f"; sparse/dense {runs['sparse'][2] / runs['dense'][2]:.3f}; R "
          f"sparse vs dense {dR:.3e}, gram_block 256 vs dense {dRb:.3e} "
          f"(gate 1e-4)", flush=True)
    gate(len({r[1] for r in runs.values()}) == 1,
         f"cholqr-linops: fail differs {[r[1] for r in runs.values()]}")
    if not runs["dense"][1]:
        gate(dR <= 1e-4 and dRb <= 1e-4, f"cholqr-linops: R {dR}, {dRb}")


def phase_linops_small_vs_plain(dev) -> None:
    """The operator slice on the card against the CPU, f64, small sizes,
    the same inputs and draws on both: the operator battery (dense,
    sparse, four composites x matmat, tmatmat, rmatmat, fro_nrm, cols,
    the views, materialize) within 1e-13, abrik (both qr_explicit modes)
    with iterations equal, S within 1e-10 s0, U and V within 1e-9 after
    sign alignment, and the four CholQR drivers over the sparse operator
    with fail equal and R within 1e-10 |R|."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch import linops as tl
    from randlapack_tpu_torch.drivers import (ABRIKConfig, CholQRLinopsConfig,
                                              CQRRTLinopsConfig, abrik,
                                              cholqr_linops, cqrrt_linops,
                                              scholqr3_linops,
                                              scholqr3_linops_basic)
    g = torch.Generator().manual_seed(10)
    f64 = torch.float64

    def rand(*shape):
        return torch.randn(*shape, generator=g, dtype=f64)

    def sparse(shape, density=0.2):
        M = rand(*shape) * (torch.rand(*shape, generator=g, dtype=f64)
                            < density)
        return M

    mats = {"A": rand(40, 28), "S": sparse((40, 28)), "B1": rand(40, 16),
            "B2": rand(16, 28), "S2": sparse((16, 28)), "S3": sparse((40, 16)),
            "C": rand(16, 16)}

    def ops(device):
        d = {k_: v.to(device) for k_, v in mats.items()}
        D, Sp = tl.DenseLinOp, tl.SparseLinOp.from_dense
        C = tl.CompositeLinOp
        return {"dense": D(d["A"]), "sparse": Sp(d["S"]),
                "composite_dd": C(D(d["B1"]), D(d["B2"])),
                "composite_ds": C(D(d["B1"]), Sp(d["S2"])),
                "composite_sd": C(Sp(d["S3"]), D(d["B2"])),
                "composite_nested": C(D(d["B1"]), C(D(d["C"]), D(d["B2"])))}

    Xs = {"mat": rand(28, 5), "t": rand(40, 5), "r": rand(5, 40),
          "blk": rand(28, 5), "col": rand(16, 5), "sub": rand(12, 5)}
    methods = {
        "matmat": lambda op, X: op.matmat(X["mat"]),
        "tmatmat": lambda op, X: op.tmatmat(X["t"]),
        "rmatmat": lambda op, X: op.rmatmat(X["r"]),
        "fro_nrm": lambda op, X: op.fro_nrm(),
        "cols": lambda op, X: op.cols(6, 8),
        "row_block": lambda op, X: op.row_block(8, 24).matmat(X["blk"]),
        "col_block": lambda op, X: op.col_block(4, 20).matmat(X["col"]),
        "submatrix": lambda op, X: tl.submatrix(op, 8, 24, 4, 16).matmat(
            X["sub"]),
        "materialize": lambda op, X: tl.materialize(op)}
    on_card, on_cpu = ops(dev), ops("cpu")
    Xg = {k_: v.to(dev) for k_, v in Xs.items()}
    worst = 0.0
    for tag in on_cpu:
        for name, fn in methods.items():
            ref = fn(on_cpu[tag], Xs)
            got = fn(on_card[tag], Xg).cpu()
            rel = float((got - ref).abs().max() / ref.abs().max())
            gate(rel <= 1e-13, f"linops {tag}.{name} card vs CPU: {rel}")
            worst = max(worst, rel)
    A = rand(96, 60) * torch.logspace(0, -4, 60, dtype=f64)
    ab = []
    for qr in ("geqrf", "cqrrt"):
        cfg = ABRIKConfig(block_size=6, max_iters=4, qr_explicit=qr)
        v0 = rand(60, 6)
        sk = [rand(8, 60 if (i % 2 == 0 and i > 0) else 96)
              for i in range(8)]
        outs = [abrik(M, 10, cfg, RNGState(0), v0=v0.to(M.device),
                      qr_sketches=[s.to(M.device) for s in sk])
                for M in (A.to(dev), A)]
        (Ug, Sg, Vtg, ig, _), (Uc, Sc, Vtc, ic, _) = outs
        gate(ig["num_krylov_iters"] == ic["num_krylov_iters"],
             f"abrik {qr}: iterations")
        dS = float((Sg.cpu() - Sc).abs().max() / Sc[0])
        sgn_u = torch.sign((Ug.cpu() * Uc).sum(0))
        sgn_v = torch.sign((Vtg.cpu() * Vtc).sum(1))
        dU = float((Ug.cpu() * sgn_u - Uc).abs().max())
        dV = float((Vtg.cpu() * sgn_v[:, None] - Vtc).abs().max())
        gate(dS <= 1e-10 and dU <= 1e-9 and dV <= 1e-9,
             f"abrik {qr} card vs CPU: S {dS}, U {dU}, V {dV}")
        ab.append(f"{qr} S {dS:.2e} U {dU:.2e} V {dV:.2e}")
    Ac = rand(120, 24) * torch.logspace(0, -3, 24, dtype=f64)
    Ac = Ac * (torch.rand(120, 24, generator=g, dtype=f64) < 0.5)
    G = rand(120, 36)
    drivers = {
        "cholqr_linops": lambda op, dv: cholqr_linops(
            op, CholQRLinopsConfig(gram_block=10, passes=2))[:2],
        "scholqr3_linops": lambda op, dv: scholqr3_linops(op)[:2],
        "cqrrt_linops": lambda op, dv: cqrrt_linops(
            op, CQRRTLinopsConfig(d_factor=1.5), RNGState(0),
            sketch=G.to(dv))[:2],
        "scholqr3_linops_basic": lambda op, dv:
            scholqr3_linops_basic(op)[1:]}
    ch = []
    for name, fn in drivers.items():
        Rg, fg = fn(tl.SparseLinOp.from_dense(Ac.to(dev)), dev)
        Rc, fc = fn(tl.SparseLinOp.from_dense(Ac), "cpu")
        dR = float((Rg.cpu() - Rc).abs().max() / torch.linalg.norm(Rc))
        gate(bool(fg) == bool(fc) and dR <= 1e-10,
             f"{name} card vs CPU: fail {bool(fg)}/{bool(fc)}, R {dR}")
        ch.append(f"{name} {dR:.2e}")
    print(f"[linops-small-vs-plain] f64 card vs CPU: operator battery (6 "
          f"operators x 9 methods) max rel {worst:.2e}; abrik: "
          + ", ".join(ab) + "; R over SparseLinOp: " + ", ".join(ch),
          flush=True)


def phase_cqrrpt_kernels(dev, A, d) -> None:
    """K5 and K6 on the shapes CQRRPT's HQRRP gives them (the 138x2048
    sketch of the 2560x2048 sketch; a 2560x128 panel), against their plain
    versions; the launches here are not the path's."""
    from randlapack_tpu_torch.ops import qr as tqr, qrcp as tqrcp
    n = A.shape[1]
    g = torch.Generator(device=dev).manual_seed(5)
    Y = torch.randn((138, n), generator=g, device=dev) \
        * torch.exp(-3 * torch.rand(n, generator=g, device=dev))
    live = torch.ones(n, device=dev)
    live[::8] = 0.0
    P = torch.randn((d, 128), generator=g, device=dev) \
        * torch.exp(-3 * torch.rand(128, generator=g, device=dev))
    piv = tqrcp.qrcp_select_pivots_cuda(Y, 128, live)
    piv_ref = tqr.qrcp_select_pivots(Y, 128, live)
    W, taus, sigma = tqrcp.qrcp_panel_cuda(P, 0, True)
    Wr, _, taus_r, sr = tqr.qrcp_panel(P, 0, True)
    dW = float(max((W - Wr).abs().max() / Wr.abs().max(),
                   (taus - taus_r).abs().max()))
    print(f"[cqrrpt-kernels] K5 on 138x{n} (128 steps, 1/8 retired): pivots"
          f" equal {torch.equal(piv, piv_ref)}; K6 on {d}x128: sigma equal "
          f"{torch.equal(sigma, sr)}, rel max|dW|, |dtau| {dW:.3e}", flush=True)
    gate(torch.equal(piv, piv_ref), "K5 pivots at the cqrrpt shape")
    gate(torch.equal(sigma, sr) and dW <= 1e-4, "K6 at the cqrrpt shape")


def phase_cqrrpt_small_vs_plain(dev) -> None:
    """cqrrpt on the card against the CPU, f64, 4096x256, the same
    operators (drawn on the CPU) injected on both devices: same pivots,
    R within 1e-10 of max|R|."""
    import dataclasses
    from randlapack_tpu_torch import RNGState, sketching
    from randlapack_tpu_torch.drivers import CQRRPTConfig, QRCPKind, cqrrpt
    g = torch.Generator().manual_seed(6)
    m, n = 4096, 256
    A = torch.randn(m, n, generator=g, dtype=torch.float64) \
        * torch.logspace(0, -6, n, dtype=torch.float64)
    d = int(1.25 * n)
    st = RNGState(3)
    saso, _ = sketching.fill_sparse(sketching.SparseDist(d, m), st,
                                    dtype=torch.float64, device="cpu")
    srht, _ = sketching.srht_skop(d, m, st, dtype=torch.float64,
                                  device="cpu")
    S_b = torch.randn(80, d, generator=g, dtype=torch.float64) / math.sqrt(80)
    G_h = 2 * torch.rand(74, d, generator=g, dtype=torch.float64) - 1

    def on(op, device):
        return dataclasses.replace(op, **{
            f.name: getattr(op, f.name).to(device)
            for f in dataclasses.fields(op)
            if isinstance(getattr(op, f.name), torch.Tensor)})

    runs = [("saso/geqp3", CQRRPTConfig(), saso, None),
            ("srht/bqrrp/blockinv", CQRRPTConfig(
                sketch="srht", qrcp=QRCPKind.bqrrp, bqrrp_block=64,
                bqrrp_pivot_candidates=2, trsm_mode="blockinv",
                trsm_block=64, gram_block=128), srht, S_b),
            ("srht/hqrrp", CQRRPTConfig(sketch="srht", qrcp=QRCPKind.hqrrp,
                                        bqrrp_block=64), srht, G_h)]
    for name, cfg, op, qs in runs:
        reset_counts()
        Qg, Rg, Jg, rg, fg, _ = cqrrpt(
            A.to(dev), cfg, st, sketch=on(op, dev),
            qrcp_sketch=None if qs is None else qs.to(dev))
        torch.cuda.synchronize()
        counts = read_counts()
        Qc, Rc, Jc, rc, fc, _ = cqrrpt(A, cfg, st, sketch=op,
                                       qrcp_sketch=qs)
        dR = float((Rg.cpu() - Rc).abs().max() / Rc.abs().max())
        same_j = torch.equal(Jg.cpu(), Jc)
        print(f"[cqrrpt-small-vs-plain] {m}x{n} f64 {name} card vs CPU: J "
              f"equal {same_j}, rank {int(rg)}/{int(rc)}, rel max|dR| "
              f"{dR:.3e}, card launches K5/K6 {counts['qrcp_select_pivots']}"
              f"/{counts['qrcp_panel']}", flush=True)
        gate(same_j and int(rg) == int(rc) and dR <= 1e-10
             and bool(fg) == bool(fc), f"cqrrpt {name} card vs CPU")


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


def phase_k5_k6_old_vs_new(dev) -> None:
    """K5 and K6 with their earlier cooperative kernels and the step
    kernels in turns (old, new, new, old) at the main shapes (K6 at the
    first, middle and last panel of the 8192^2 factorization), then
    hqrrp_lapack_format 8192^2 through its entry point with each pair, in
    turns, best of 3 each; every factorization is gated on its launch
    counts (one pair only), the last of each on residual and
    orthogonality, and the two pivot orders J are compared."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import HQRRPConfig, hqrrp_lapack_format
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.ops import qrcp
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    Y = torch.randn(138, N, generator=g, device=dev)
    live = (torch.rand(N, generator=g, device=dev) > 0.125).float()
    lines = []
    old, new = in_turns(lambda: qrcp.qrcp_select_pivots_coop(Y, 128, live),
                        lambda: qrcp.qrcp_select_pivots_cuda(Y, 128, live),
                        10)
    lines.append(f"K5 138x{N} 128 steps: coop {old:.4f} ms "
                 f"({old * 1e3 / 128:.2f} us a step), step {new:.4f} ms "
                 f"({new * 1e3 / 128:.2f} us a step)")
    for r0 in (0, N // 2, N - 128):
        P = torch.randn(N, 128, generator=g, device=dev)
        old, new = in_turns(lambda: qrcp.qrcp_panel_coop(P, r0),
                            lambda: qrcp.qrcp_panel_cuda(P, r0), 10)
        lines.append(f"K6 {N}x128 row0 {r0}: coop {old:.4f} ms "
                     f"({old * 1e3 / 128:.2f} us a step), step {new:.4f} ms"
                     f" ({new * 1e3 / 128:.2f} us a step)")
    print("[old-vs-new] " + "; ".join(lines), flush=True)

    cfg = HQRRPConfig(block_size=128, update_defer=4)
    A, st = fast_decay_matrix(N, N, RNGState(7), device=dev)
    pairs = {"step": (qrcp.qrcp_select_pivots_cuda, qrcp.qrcp_panel_cuda),
             "coop": (qrcp.qrcp_select_pivots_coop, qrcp.qrcp_panel_coop)}
    expected = {"step": HQRRP_LAUNCHES,
                "coop": {**NO_LAUNCHES, "qrcp_select_pivots_coop": 64,
                         "qrcp_panel_coop": 64}}
    outs = {}

    def best_of_3(which):
        best = None
        try:
            qrcp.qrcp_select_pivots_cuda, qrcp.qrcp_panel_cuda = pairs[which]
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                reset_counts()
                start.record()
                outs[which] = hqrrp_lapack_format(A, cfg, st)
                end.record()
                torch.cuda.synchronize()
                gate(read_counts() == expected[which],
                     f"HQRRP with the {which} kernels: {read_counts()}")
                t = start.elapsed_time(end) / 1e3
                best = t if best is None else min(best, t)
        finally:
            qrcp.qrcp_select_pivots_cuda, qrcp.qrcp_panel_cuda = pairs["step"]
        return best

    best_of_3("step")                                      # warm-up
    turns = [(which, best_of_3(which))
             for which in ("coop", "step", "step", "coop")]
    quality = []
    for which in ("coop", "step"):
        packed, taus, R, J, _ = outs[which]
        _, res, orth = hqrrp_quality(A, packed, taus, R, J)
        gate(res <= RES_GATE and orth <= ORTH_GATE,
             f"HQRRP with the {which} kernels: residual {res}, orth {orth}")
        quality.append(f"{which} residual {res:.3e}, orth {orth:.3e}")
    same = torch.equal(outs["coop"][3], outs["step"][3])
    print(f"[old-vs-new] hqrrp_lapack_format {N}x{N} f32 b128/defer4, K5/K6 "
          "in turns, best of 3: " + ", ".join(
              f"{which} {t:.4f} s" for which, t in turns)
          + f"; {'; '.join(quality)}; J equal between the two: {same}",
          flush=True)


def phase_kernel_anatomy(dev) -> None:
    """Where K5/K6's time goes, for the step kernels and the earlier
    cooperative ones: the same per-step work with fewer blocks, or (K6)
    without pivoting (one exchange fewer a step for the cooperative
    kernel); ms and us a step."""
    from randlapack_tpu_torch.ops import qrcp
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    anatomy = []
    kinds = {"K5": (qrcp.qrcp_select_pivots_cuda,
                    qrcp.qrcp_select_pivots_coop),
             "K6": (qrcp.qrcp_panel_cuda, qrcp.qrcp_panel_coop)}
    for d, n in ((138, N), (138, 2048), (138, 256)):
        Y = torch.randn(d, n, generator=g, device=dev)
        live = torch.ones(n, device=dev)
        for name, fn in zip(("step", "coop"), kinds["K5"]):
            anatomy.append((f"K5 {name} {d}x{n}", cuda_ms(
                lambda: fn(Y, 128, live), 10)))
    for m, r0, pv in ((N, 0, True), (N, 0, False), (N, 4096, True),
                      (N, N - 256, True), (N, N - 128, True)):
        P = torch.randn(m, 128, generator=g, device=dev)
        for name, fn in zip(("step", "coop"), kinds["K6"]):
            anatomy.append((f"K6 {name} {m}x128 row0={r0} pivot={pv}",
                            cuda_ms(lambda: fn(P, r0, pv), 10)))
    print("[kernel-anatomy] " + "; ".join(
        f"{k}: {v:.4f} ms, {v * 1e3 / 128:.2f} us a step"
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


# BASELINE config 2 (bench.py:586-645): sketch-and-precondition least
# squares of a 100000x2000 f32 fast-decay matrix (decay 7), mu 0,
# PCGSaddleConfig(tol=1e-6, max_iters=60); the gates are in PERF.md §2
SPLS_M, SPLS_N, SPLS_TOL, SPLS_ITERS = 100000, 2000, 1e-6, 60
SPLS_DAMP = 1e-2
# the solver operators' problem: the 5-point Laplacian of a 128x128 grid
# (n 16384), 64 right-hand sides
GRID, SOLVER_RHS = 128, 64
# [trailing-wy]: BQRRP's shapes (A 8192², b 256), the live window from 2048
WY_N, WY_B, WY_DEAD = 8192, 256, 2048
# [mm-native]: a Matrix Market file of this many entries
MM_NNZ = 10_000_000


def spls_problem(dev, dtype=torch.float32):
    """Config 2's input: fast_decay_matrix(100000, 2000, RNGState(3),
    decay=7.0) and x_t from torch.Generator seed 9 on the card (bench.py
    draws x_t with jax.random.key(9), so b differs from bench.py's), b =
    A·x_t, four more columns X_t for the multi-RHS run."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.gen import fast_decay_matrix
    A, _ = fast_decay_matrix(SPLS_M, SPLS_N, RNGState(3), dtype=dtype,
                             decay=7.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    xt = torch.randn(SPLS_N, generator=g, dtype=dtype, device=dev)
    Xt = torch.randn((SPLS_N, 4), generator=g, dtype=dtype, device=dev)
    return A, xt, Xt


def ls_quality(A64, fro2, b, x, xt, mu=0.0) -> dict:
    """In f64: ‖Ax−b‖/‖b‖, the normal-equations residual
    ‖Aᵀ(b−Ax) − μx‖/((‖A‖_F²+μ)‖x‖) and ‖x−x_t‖/‖x_t‖."""
    b, x, xt = b.double(), x.double(), xt.double()
    r = b - A64 @ x
    nb, nx = torch.linalg.norm(b), torch.linalg.norm(x)
    return dict(rel=float(torch.linalg.norm(r) / nb),
                ne=float(torch.linalg.norm(A64.T @ r - mu * x)
                         / ((fro2 + mu) * nx)),
                xerr=float(torch.linalg.norm(x - xt) / torch.linalg.norm(xt)))


def phase_spls(dev, card: str) -> dict:
    """BASELINE config 2 through spls, each run best of 3 by CUDA events
    after a warm call: the LSQR default, solver="pcg", precond="qr",
    refine_precond=False, four right-hand sides (PCG), damped LSQR at
    mu 1e-2 and the default in f64 on the same A. Per run: seconds,
    iterations, the residuals, the x-error, peak memory above the inputs
    (the bandwidth of an LSQR iteration is in [spls-phases]). Gates (PERF.md
    §2, from the algorithms; κ from the f64 R of A): iterations below
    max_iters; no kernel launch; in f32 at μ 0 the normal-equations
    residual ≤ √n·eps32 (a backward-stable least-squares solve) and
    ‖Ax−b‖/‖b‖ ≤ (1+2κ)·eps32 (the residual's perturbation bound for a
    backward error of eps32, b consistent); each LSQR run's x-error at
    most a tenth of PCG's (κ·eps against κ²·eps); in f64 ‖Ax−b‖/‖b‖ ≤
    tol + √n·κ·eps64 (LSQR stops once φ̄ ≤ tol·‖b‖, and φ̄ tracks the
    true residual to rounding); the damped run's normal-equations
    residual ≤ √n·eps32. Controls that each gate must refuse (gated to
    fail, [spls-controls]): x = x_t/2 (residual and normal equations),
    x_t plus a random 1e-2 relative perturbation and unpreconditioned
    LSQR stopped at the default's count (normal equations), the damped
    solution halved, and the f64 call stopped at half its iterations
    (the f64 residual). Returns the launch counts."""
    import dataclasses
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import LSQRConfig, PCGSaddleConfig, lsqr
    from randlapack_tpu_torch.drivers import SPLSConfig, spls
    A, xt, Xt = spls_problem(dev)
    m, n = A.shape
    A64 = A.double()
    fro2 = float(torch.linalg.norm(A64) ** 2)
    b = A @ xt
    B4 = A @ Xt
    base = SPLSConfig(pcg=PCGSaddleConfig(tol=SPLS_TOL, max_iters=SPLS_ITERS))
    R64 = torch.linalg.qr(A64, mode="r")[1]
    sv = torch.linalg.svdvals(R64)
    kappa = float(sv[0] / sv[-1])
    PRECISION_INPUT["spls_kappa"] = kappa
    del R64
    xt64, b64 = xt.double(), A64 @ xt.double()
    runs = [("lsqr (default)", A, b, xt, 0.0, base),
            ("pcg", A, b, xt, 0.0, dataclasses.replace(base, solver="pcg")),
            ("qr", A, b, xt, 0.0, dataclasses.replace(base, precond="qr")),
            ("no refine", A, b, xt, 0.0,
             dataclasses.replace(base, refine_precond=False)),
            ("pcg 4 rhs", A, B4, Xt, 0.0, base),
            (f"lsqr damped mu {SPLS_DAMP:g}", A, b, xt, SPLS_DAMP, base),
            ("f64 default", A64, b64, xt64, 0.0, base)]
    out, xs, all_counts = {}, {}, {}
    for tag, Am, bm, xm, mu, cfg in runs:
        (x, hist, iters, _), times, counts, peak, above = event_runs(
            lambda: spls(Am, bm, mu, cfg, RNGState(4)), 3)
        q = ls_quality(A64, fro2, bm, x, xm, mu)
        t = min(times)
        out[tag] = dict(q, iters=iters, t=t, mu=mu, above=above)
        xs[tag] = x
        print(f"[spls] {m}x{n} {str(Am.dtype)[6:]} {tag} on {card}: runs "
              f"{[round(s, 5) for s in times]} s (CUDA events), best "
              f"{t:.5f} s, {iters} iterations; |Ax-b|/|b| "
              f"{q['rel']:.4e}, |A^T r|/(|A|_F^2 |x|) "
              f"{q['ne']:.4e}, x-error {q['xerr']:.4e}; peak memory "
              f"{peak:.3f} GiB, {above:.3f} GiB above the inputs; launches "
              f"{'none' if counts == NO_LAUNCHES else counts}", flush=True)
        gate(bool(torch.isfinite(x).all()) and x.shape == xm.shape,
             f"spls {tag}: output shape or finiteness")
        gate(iters < SPLS_ITERS, f"spls {tag}: {iters} iterations")
        gate(counts == NO_LAUNCHES, f"spls {tag}: launches {counts}")
        all_counts = counts
    e64 = float(torch.finfo(torch.float64).eps)
    ne_gate = math.sqrt(n) * EPS32
    res_gate = (1 + 2 * kappa) * EPS32
    res64_gate = SPLS_TOL + math.sqrt(n) * kappa * e64
    print(f"[spls] kappa(A) {kappa:.4e} (f64 R of A); kappa*eps32 "
          f"{kappa * EPS32:.3e}, kappa^2*eps32 {kappa ** 2 * EPS32:.3e}; "
          f"gates: f32 NE {ne_gate:.3e}, f32 residual {res_gate:.3e}, f64 "
          f"residual {res64_gate:.4e}", flush=True)

    def refused(tag, q, gates):
        """Print a control's readings and gate that each named gate
        refuses it."""
        print(f"[spls-controls] {tag}: |Ax-b|/|b| {q['rel']:.4e}, NE "
              f"{q['ne']:.4e}, x-error {q['xerr']:.4e}; must fail "
              f"{', '.join(gates)}", flush=True)
        limits = {"residual": ("rel", res_gate), "NE": ("ne", ne_gate),
                  "f64 residual": ("rel", res64_gate)}
        for name in gates:
            key, lim = limits[name]
            gate(q[key] > lim, f"spls control {tag} passes the {name} gate "
                 f"({q[key]} <= {lim})")

    for tag, r in out.items():
        if tag == "f64 default":
            gate(r["rel"] <= res64_gate, f"spls f64: residual {r['rel']}")
            continue
        if r["mu"] > 0:
            print(f"[spls-gates] {tag}: NE {r['ne']:.3e} (gate "
                  f"{ne_gate:.3e})", flush=True)
            gate(r["ne"] <= ne_gate, f"spls {tag}: damped NE residual "
                 f"{r['ne']}")
            continue
        print(f"[spls-gates] {tag}: residual {r['rel']:.3e} (gate "
              f"{res_gate:.3e}), NE {r['ne']:.3e} (gate {ne_gate:.3e}), "
              f"x-error {r['xerr']:.3e} (not gated alone: kappa*eps32 "
              f"{kappa * EPS32:.3f})", flush=True)
        gate(r["rel"] <= res_gate, f"spls {tag}: residual {r['rel']}")
        gate(r["ne"] <= ne_gate, f"spls {tag}: NE residual {r['ne']}")
    # LSQR's κ·eps against the normal equations' κ²·eps, as
    # tests/test_psd_track.py:226 holds the JAX package to it
    for tag in ("lsqr (default)", "qr", "no refine"):
        gate(out[tag]["xerr"] <= out["pcg"]["xerr"] / 10,
             f"spls {tag}: x-error {out[tag]['xerr']} not 10x below PCG's")
    g = torch.Generator(device=dev).manual_seed(10)
    u = torch.randn(n, generator=g, dtype=A.dtype, device=dev)
    u *= 1e-2 * torch.linalg.norm(xt) / torch.linalg.norm(u)
    refused("x = x_t/2", ls_quality(A64, fro2, b, xt / 2, xt),
            ["residual", "NE"])
    refused("x = x_t + 1e-2 perturbation",
            ls_quality(A64, fro2, b, xt + u, xt), ["NE"])
    damped = f"lsqr damped mu {SPLS_DAMP:g}"
    refused("damped solution halved", ls_quality(
        A64, fro2, b, xs[damped] / 2, xt, SPLS_DAMP), ["NE"])
    half64 = out["f64 default"]["iters"] // 2
    x64h = spls(A64, b64, 0.0, dataclasses.replace(base, pcg=PCGSaddleConfig(
        tol=SPLS_TOL, max_iters=half64)), RNGState(4))[0]
    refused(f"f64 default stopped at {half64} iterations",
            ls_quality(A64, fro2, b64, x64h, xt64), ["f64 residual"])
    it32 = out["lsqr (default)"]["iters"]
    refused(f"unpreconditioned LSQR, {it32} iterations", ls_quality(
        A64, fro2, b, lsqr(A, b, None, LSQRConfig(
            tol=SPLS_TOL, max_iters=it32))[0], xt), ["NE"])
    # reported, not gated: f32 LSQR reaches its rounding floor by half its
    # iterations, so a solve stopped there reads as a converged one
    x = spls(A, b, 0.0, dataclasses.replace(base, pcg=PCGSaddleConfig(
        tol=SPLS_TOL, max_iters=it32 // 2)), RNGState(4))[0]
    q = ls_quality(A64, fro2, b, x, xt)
    print(f"[spls-controls] f32 default stopped at {it32 // 2} iterations: "
          f"|Ax-b|/|b| {q['rel']:.4e}, NE {q['ne']:.4e}, x-error "
          f"{q['xerr']:.4e}; reported (the f64 gate refuses truncation)",
          flush=True)
    return all_counts



def event_ms(fn) -> tuple:
    """``fn()`` once, timed by CUDA events: its output and milliseconds."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_spls_phases(dev) -> None:
    """The default call split into its steps, each timed by CUDA events on
    a warm card (one warm pass first): the SASO draw, its apply, svd_econ
    of the 8000x2000 sketch, the orthogonalizer, the refinement and the
    LSQR iterations (ms an iteration; bandwidth at 2mn·4 bytes an
    iteration against 3.35 TB/s); the card-busy share of
    the solve under torch.profiler; iterations with and without the
    refinement, for LSQR and PCG; the refinement's fail flag (gated
    False) and rank."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import (LSQRConfig, PCGSaddleConfig,
                                            lsqr, make_right_orthogonalizer,
                                            pcg_saddle)
    from randlapack_tpu_torch.comps.preconditioners import \
        refine_right_precond
    from randlapack_tpu_torch.ops.svd import svd_econ
    from randlapack_tpu_torch.sketching import (SparseDist, fill_sparse,
                                                saso_left_apply)
    A, xt, _ = spls_problem(dev)
    m, n = A.shape
    d = 4 * n
    b = A @ xt
    lcfg = LSQRConfig(tol=SPLS_TOL, max_iters=SPLS_ITERS)
    passes = []
    for warm in (True, False):
        (S, _), t_draw = event_ms(lambda: fill_sparse(
            SparseDist(d, m, 8), RNGState(4), dtype=A.dtype, device=dev))
        A_sk, t_apply = event_ms(lambda: saso_left_apply(S, A))
        (_, sig, Vt), t_svd = event_ms(lambda: svd_econ(A_sk))
        (M0, rank), t_orth = event_ms(
            lambda: make_right_orthogonalizer(Vt.T, sig, 0.0))
        (M, fail), t_ref = event_ms(
            lambda: refine_right_precond(A_sk, M0, 0.0))
        (x, _, it), t_lsqr = event_ms(lambda: lsqr(A, b, M, lcfg))
        passes.append((S, A_sk, sig, M, x))
    wall, launches, busy, idle, text = profile_summary(
        lambda: lsqr(A, b, M, lcfg))
    _, _, it0 = lsqr(A, b, M0, lcfg)
    pcfg = PCGSaddleConfig(tol=SPLS_TOL, max_iters=SPLS_ITERS)
    z = torch.zeros((n, 1), dtype=A.dtype, device=dev)
    _, _, pit = pcg_saddle(A, b[:, None], z, 0.0, M, z, pcfg)
    _, _, pit0 = pcg_saddle(A, b[:, None], z, 0.0, M0, z, pcfg)
    per_it = t_lsqr / max(it, 1)
    bw = 2.0 * m * n * 4 / (per_it * 1e-3) / 1e12
    total = t_draw + t_apply + t_svd + t_orth + t_ref + t_lsqr
    print(f"[spls-phases] default call's steps (CUDA events, warm): SASO "
          f"draw (d {d}, vec_nnz 8) {t_draw:.2f} ms, apply {t_apply:.2f} "
          f"ms, svd_econ of the {d}x{n} sketch {t_svd:.2f} ms "
          f"({100 * t_svd / total:.1f} %), orthogonalizer {t_orth:.2f} ms, "
          f"refinement {t_ref:.2f} ms, LSQR {t_lsqr:.2f} ms for "
          f"{it} iterations = {per_it:.3f} ms an iteration = {bw:.3f} TB/s "
          f"at 2mn·4 bytes ({100 * bw / (PEAK_BYTES / 1e12):.1f} % of 3.35 "
          f"TB/s); the steps sum to {total:.2f} ms; "
          f"LSQR under torch.profiler: wall {wall * 1e3:.2f} ms, {launches} "
          f"device launches, card busy {busy:.2f} ms (idle {idle:.1f} %; "
          f"{it} host reads of the stop test); top: {text}", flush=True)
    print(f"[spls-phases] refinement's effect: LSQR {it} iterations with "
          f"it, {it0} without; PCG {pit} with, {pit0} without; refinement "
          f"fail {bool(fail)}, rank {int(rank)}", flush=True)
    gate(not bool(fail) and int(rank) == n, "spls: refinement failed")
    gate(it < SPLS_ITERS and it0 < SPLS_ITERS, "spls-phases: iterations")
    # which step makes the f32 x differ from run to run: each step again
    # on the previous step's output of the second pass, bit for bit, and
    # the whole chain from the gather form of the apply, twice
    (S1, Ask1, sig1, M1, x1), (S2, Ask2, sig2, M2, x2) = passes
    xerr = [float(torch.linalg.norm(v - xt) / torch.linalg.norm(xt))
            for v in (x1, x2)]

    def chain(A_sk):
        _, sg, vt = svd_econ(A_sk)
        Mr = refine_right_precond(A_sk, make_right_orthogonalizer(
            vt.T, sg, 0.0)[0], 0.0)[0]
        return Mr, lsqr(A, b, Mr, lcfg)[0]

    same = dict(
        draw=torch.equal(S1.rows, S2.rows) and torch.equal(S1.vals, S2.vals),
        apply=torch.equal(Ask1, Ask2),
        svd=torch.equal(svd_econ(Ask2)[1], sig2),
        chain=torch.equal(chain(Ask2)[1], x2),
        lsqr=torch.equal(lsqr(A, b, M2, lcfg)[0], x2))
    Ag1, Ag2 = (saso_left_apply(S2, A, method="gather") for _ in range(2))
    (_, xg1), (_, xg2) = chain(Ag1), chain(Ag2)
    xerr_g = [float(torch.linalg.norm(v - xt) / torch.linalg.norm(xt))
              for v in (xg1, xg2)]
    print(f"[spls-phases] bit-equal on repeat: {same}; x-error of the two "
          f"passes {xerr[0]:.4e}, {xerr[1]:.4e}; gather-form apply "
          f"bit-equal {torch.equal(Ag1, Ag2)}, its two x bit-equal "
          f"{torch.equal(xg1, xg2)}, x-error {xerr_g[0]:.4e}, "
          f"{xerr_g[1]:.4e}", flush=True)


def grid_laplacian(k: int):
    """The 5-point Laplacian of a k x k grid (n k², SPD) as COO arrays."""
    import numpy as np
    import scipy.sparse as sp
    T = sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(k, k))
    E = sp.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    K = (sp.kron(sp.identity(k), T) + sp.kron(E, sp.identity(k))).tocoo()
    return K.row.astype(np.int64), K.col.astype(np.int64), K.data, K


def phase_solver_linops(dev, card: str) -> None:
    """The solver operators on the 5-point Laplacian of a 128x128 grid
    (n 16384), 64 right-hand sides, f32: CholSolverLinOp (full and half)
    and LUSolverLinOp (matmat, tmatmat), with device solves and host
    solves: the host factorization (with packing) seconds, one solve by
    CUDA events (warm), each packed factor's padded width L and bytes,
    and the relative residual ‖K·X − B‖/‖B‖ (half: ‖L̃·X − B‖/‖B‖; tmatmat:
    Kᵀ), gated by the backward error of f32 sparse triangular solves with
    rows of at most w entries: w·eps32·‖K‖₁·‖X‖/‖B‖ (the Laplacian is
    diagonally dominant, so |L||U| does not grow past K's scale; half:
    ‖L̃‖ ≤ ‖K‖₁^½); then ABRIK over
    CompositeLinOp(K⁻¹, D), D 16384x64 Gaussian, k 8, b 8, 6 iterations:
    its σ against the f64 host SVD of K⁻¹D (gated max|σ − σ_ref| ≤
    1e-4·σ₁ from both sides: f32 rounding at σ₁'s scale), no kernel
    launch."""
    import numpy as np
    import scipy.sparse.linalg as spla
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import ABRIKConfig, abrik
    from randlapack_tpu_torch.extras import CholSolverLinOp, LUSolverLinOp
    from randlapack_tpu_torch.linops import CompositeLinOp, DenseLinOp
    rows, cols, vals, K = grid_laplacian(GRID)
    n = K.shape[0]
    Kc = K.tocsr()
    norm1 = float(abs(Kc).sum(axis=0).max())
    g = torch.Generator(device=dev).manual_seed(12)
    B = torch.randn((n, SOLVER_RHS), generator=g, device=dev)
    Bh = B.double().cpu().numpy()
    kinds = [("chol", lambda ds: CholSolverLinOp(rows, cols, vals, n,
                                                 device_solves=ds,
                                                 device=dev), "matmat"),
             ("chol half", lambda ds: CholSolverLinOp(
                 rows, cols, vals, n, half=True, device_solves=ds,
                 device=dev), "matmat"),
             ("lu", lambda ds: LUSolverLinOp(rows, cols, vals, n,
                                             device_solves=ds, device=dev),
              "matmat"),
             ("lu", None, "tmatmat")]
    made = {}
    reset_counts()
    for kind, make, f in kinds:
        for ds in (True, False):
            key = (kind, ds)
            if key not in made:
                t0 = time.perf_counter()
                made[key] = make(ds)
                torch.cuda.synchronize()
                made[key + ("t",)] = time.perf_counter() - t0
            op = made[key]
            getattr(op, f)(B)
            X, ms = event_ms(lambda: getattr(op, f)(B))
            Xh = X.double().cpu().numpy()
            if kind == "chol half":
                fac = op.factors
                R = (fac.L @ Xh)[fac.perm_r] - Bh
            else:
                R = (Kc.T if f == "tmatmat" else Kc) @ Xh - Bh
            res = float(np.linalg.norm(R) / np.linalg.norm(Bh))
            fac = op.factors
            w = max(int(np.diff(M.tocsr().indptr).max())
                    for M in (fac.L, fac.U) if M is not None)
            scale = norm1 ** 0.5 if kind == "chol half" else norm1
            res_gate = w * EPS32 * scale * float(
                np.linalg.norm(Xh) / np.linalg.norm(Bh))
            widths = ""
            if ds:
                names = ["L", "U"] if kind != "chol half" else ["L"]
                if f == "tmatmat":
                    names = ["Ut", "Lt"]
                widths = ", packed " + ", ".join(
                    f"{nm} width {op.packed(nm).width} "
                    f"({op.packed(nm).nbytes / 2 ** 20:.1f} MiB)"
                    for nm in names)
            print(f"[solver-linops] {kind} {f} n {n} (grid {GRID}^2, "
                  f"{len(vals)} nnz), {SOLVER_RHS} rhs f32, "
                  f"{'device' if ds else 'host'} solves on {card}: "
                  f"factorization + packing {made[key + ('t',)]:.3f} s, one "
                  f"solve {ms:.2f} ms (CUDA events){widths}; |KX-B|/|B| "
                  f"{res:.3e} (gate {res_gate:.3e}, w {w})", flush=True)
            gate(X.is_cuda and bool(torch.isfinite(X).all()),
                 f"solver-linops {kind}: output")
            gate(res <= res_gate, f"solver-linops {kind} {f}: residual {res}")
    counts = read_counts()
    gate(counts == NO_LAUNCHES, f"solver-linops: launches {counts}")
    D = torch.randn((n, 64), generator=g, device=dev)
    comp = CompositeLinOp(made[("chol", True)], DenseLinOp(D))
    cfg = ABRIKConfig(block_size=8, max_iters=6)
    reset_counts()
    (U, S, Vt, info, _), ms = event_ms(
        lambda: abrik(comp, 8, cfg, RNGState(13)))
    counts = read_counts()
    KinvD = spla.splu(K.tocsc()).solve(D.double().cpu().numpy())
    s_ref = np.linalg.svd(KinvD, compute_uv=False)[:8]
    s = S.double().cpu().numpy()
    gap = float(np.max(np.abs(s - s_ref) / s_ref))
    print(f"[solver-linops] abrik over CompositeLinOp(CholSolverLinOp, "
          f"DenseLinOp(D {n}x64)), k 8, b 8, 6 iterations: {ms:.2f} ms, "
          f"sigma {s[:3]} vs the f64 host SVD {s_ref[:3]}, largest relative "
          f"gap {gap:.3e}; launches {'none' if counts == NO_LAUNCHES else counts}",
          flush=True)
    gate(float(np.max(np.abs(s - s_ref))) <= 1e-4 * s_ref[0],
         f"solver-linops abrik: sigma {s} against {s_ref}")
    gate(counts == NO_LAUNCHES, f"solver-linops abrik: launches {counts}")


def phase_trailing_wy(dev) -> dict:
    """trailing_wy_update at BQRRP's shapes (A 8192², V 8192x256, T upper
    256², columns from 2048 live) against its plain version: exactly one
    K1 and one K2 launch, A unchanged, the error against the f64 result
    within 4x that of the plain fp32 version (PERF.md §2's K1/K2 gate),
    max|d| relative to the plain output; its time beside K1 + the Tᵀ·W
    product + K2 (+ the copy of A). Returns the launch counts."""
    from randlapack_tpu_torch.ops import wy
    g = torch.Generator(device=dev).manual_seed(14)
    A = torch.randn((WY_N, WY_N), generator=g, device=dev)
    V = torch.randn((WY_N, WY_B), generator=g, device=dev) / math.sqrt(WY_N)
    T = torch.triu(torch.randn((WY_B, WY_B), generator=g, device=dev))
    mask = (torch.arange(WY_N, device=dev) >= WY_DEAD).float()
    A0 = A.clone()
    reset_counts()
    out = wy.trailing_wy_update(A, V, T, mask)
    torch.cuda.synchronize()
    counts = read_counts()
    plain = A - (V @ (T.T @ (V.T @ (A * mask)))) * mask
    A64, V64, T64, m64 = (t.double() for t in (A, V, T, mask))
    ref = A64 - (V64 @ (T64.T @ (V64.T @ (A64 * m64)))) * m64
    err, err_plain = relf(out, ref), relf(plain, ref)
    dmax = float((out - plain).abs().max() / plain.abs().max())
    t_all = cuda_ms(lambda: wy.trailing_wy_update(A, V, T, mask), 20)
    W = wy.masked_vt_a(V, A, mask)
    Z = T.T @ W
    Ac = A.clone()
    t_k1 = cuda_ms(lambda: wy.masked_vt_a(V, A, mask), 20)
    t_mm = cuda_ms(lambda: T.T @ W, 20)
    t_k2 = cuda_ms(lambda: wy.a_minus_vz_masked(Ac, V, Z, mask), 20)
    t_copy = cuda_ms(lambda: A.clone(), 20)
    t_plain = cuda_ms(lambda: A - (V @ (T.T @ (V.T @ (A * mask)))) * mask,
                      20)
    print(f"[trailing-wy] trailing_wy_update A {WY_N}^2, b {WY_B}, live from "
          f"{WY_DEAD}: {t_all:.4f} ms; K1 {t_k1:.4f} + T^T W {t_mm:.4f} + K2 "
          f"{t_k2:.4f} + copy of A {t_copy:.4f} = "
          f"{t_k1 + t_mm + t_k2 + t_copy:.4f} ms; plain {t_plain:.4f} ms; "
          f"error vs f64 {err:.3e} (plain fp32 {err_plain:.3e}, gate "
          f"{F64_ERR_FACTOR:g}x); max|d|/max|plain| {dmax:.3e}; A unchanged "
          f"{torch.equal(A, A0)}; launches "
          f"{({k: v for k, v in counts.items() if v})}", flush=True)
    gate(counts == {**NO_LAUNCHES, "masked_vt_a": 1, "a_minus_vz_masked": 1},
         f"trailing-wy: launches {counts}")
    gate(torch.equal(A, A0), "trailing-wy: A changed")
    gate(err <= F64_ERR_FACTOR * err_plain, f"trailing-wy: error {err}")
    return counts


def phase_mm_native(dev) -> None:
    """A Matrix Market file of 1e7 entries written and read by the native
    route and by scipy (each route forced by extras.io.PREFER_NATIVE and
    asserted by extras.io.ROUTES): the four times, the arrays equal (f64
    values exact), and the route a default call takes with this scipy."""
    import os
    import tempfile
    import numpy as np
    import scipy
    from randlapack_tpu_torch.extras import io
    t0 = time.perf_counter()
    native = io.native_module()
    t_build = time.perf_counter() - t0
    gate(native is not None, "mm-native: the native reader did not build")
    rng = np.random.default_rng(15)
    m = n = 1 << 20
    rows = rng.integers(0, m, MM_NNZ).astype(np.int32)
    cols = rng.integers(0, n, MM_NNZ).astype(np.int32)
    vals = rng.standard_normal(MM_NNZ)
    order = np.lexsort((cols, rows))

    def timed(fn, prefer):
        io.PREFER_NATIVE = prefer
        try:
            t0 = time.perf_counter()
            return fn(), time.perf_counter() - t0
        finally:
            io.PREFER_NATIVE = None

    def same(read):
        r, c, v, shape = read
        o = np.lexsort((c, r))
        return (shape == (m, n) and np.array_equal(r[o], rows[order])
                and np.array_equal(c[o], cols[order])
                and np.array_equal(v[o], vals[order]))

    with tempfile.TemporaryDirectory() as tmp:
        pn, ps = os.path.join(tmp, "n.mtx"), os.path.join(tmp, "s.mtx")
        before = dict(io.ROUTES)
        _, t_wn = timed(lambda: io.mm_write(pn, rows, cols, vals, (m, n)),
                        True)
        _, t_ws = timed(lambda: io.mm_write(ps, rows, cols, vals, (m, n)),
                        False)
        rn, t_rn = timed(lambda: io.mm_read(pn), True)
        rs, t_rs = timed(lambda: io.mm_read(ps), False)
        took = {k: io.ROUTES[k] - before[k] for k in io.ROUTES}
        default = "native" if io.prefer_native() else "scipy"
        t0 = time.perf_counter()
        rd = io.mm_read(pn)
        t_rd = time.perf_counter() - t0
        size = os.path.getsize(pn), os.path.getsize(ps)
    equal = same(rn) and same(rs) and same(rd)
    print(f"[mm-native] {MM_NNZ} entries ({size[0] / 2 ** 20:.1f} / "
          f"{size[1] / 2 ** 20:.1f} MiB native / scipy file), scipy "
          f"{scipy.__version__}: build or load {t_build:.2f} s; write "
          f"native {t_wn:.2f} s, scipy {t_ws:.2f} s; read native "
          f"{t_rn:.2f} s, scipy {t_rs:.2f} s; a default read takes "
          f"{default} ({t_rd:.2f} s); routes {took}; arrays equal {equal}",
          flush=True)
    gate(took == {"read_native": 1, "read_scipy": 1, "write_native": 1,
                  "write_scipy": 1}, f"mm-native: routes {took}")
    gate(equal, "mm-native: a route read different arrays")


def phase_spls_small_vs_plain(dev) -> None:
    """spls (every branch), lsqr, both preconditioners and the three
    solver operators on the card against the CPU, f64, small sizes, the
    same SASO on both: iterations within 1, x within 100·κ·eps (LSQR,
    run to its stall stop) or 10·κ²·eps (PCG, run to tol 1e-12; κ 1e3),
    A·M's σ within 1e-9, solves within 1e-12 of the largest entry."""
    import dataclasses
    import numpy as np
    import scipy.sparse as sp
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import (LSQRConfig, PCGSaddleConfig,
                                            lsqr, right_precond_saso,
                                            rpc_data_svd_saso)
    from randlapack_tpu_torch.drivers import SPLSConfig, spls
    from randlapack_tpu_torch.extras import CholSolverLinOp, LUSolverLinOp
    from randlapack_tpu_torch.sketching import SparseDist, fill_sparse
    f64 = torch.float64
    g = torch.Generator().manual_seed(16)
    m, n = 600, 50
    U = torch.linalg.qr(torch.randn(m, n, generator=g, dtype=f64))[0]
    V = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=f64))[0]
    A = (U * torch.logspace(0, -3, n, dtype=f64)) @ V.T
    b = A @ torch.randn(n, generator=g, dtype=f64)
    B3 = A @ torch.randn(n, 3, generator=g, dtype=f64)
    S, _ = fill_sparse(SparseDist(4 * n, m, 8), RNGState(3), dtype=f64,
                       device="cpu")
    Sg = dataclasses.replace(S, rows=S.rows.to(dev), vals=S.vals.to(dev))
    worst = 0.0
    reset_counts()
    eps, kap = float(torch.finfo(f64).eps), 1e3
    lsqr_gate, pcg_gate = 100 * kap * eps, 10 * kap ** 2 * eps
    # LSQR and PCG at μ 0 run until converged (tol 1e-12): before that
    # their iterates are not defined to rounding at this κ, and PCG's x at
    # tol 1e-10 moves with the sketch's summation order (the card's scatter
    # sums in no fixed order) by more than 10·κ²·eps (printed, not gated);
    # converged it does not (tests/test_torch_spls.py::
    # test_converged_x_ignores_the_sketch_summation_order)
    def card_vs_cpu(kw, mu, rhs, tol):
        cfg = SPLSConfig(pcg=PCGSaddleConfig(tol=tol, max_iters=200), **kw)
        xg, _, ig, _ = spls(A.to(dev), rhs.to(dev), mu, cfg, RNGState(3),
                            sketch=Sg)
        xc, _, ic, _ = spls(A, rhs, mu, cfg, RNGState(3), sketch=S)
        return (float(torch.linalg.norm(xg.cpu() - xc)
                      / torch.linalg.norm(xc)), ig, ic)

    for kw, mu, rhs, tol, xgate in [
            ({}, 0.0, b, 1e-12, lsqr_gate),
            ({"refine_precond": False}, 0.0, b, 1e-12, lsqr_gate),
            ({"precond": "qr"}, 0.0, b, 1e-12, lsqr_gate),
            ({"solver": "pcg"}, 0.0, b, 1e-12, pcg_gate),
            ({}, 1e-4, b, 1e-12, 1e-10), ({}, 1e-6, B3, 1e-10, pcg_gate)]:
        d, ig, ic = card_vs_cpu(kw, mu, rhs, tol)
        worst = max(worst, d / xgate)
        gate(abs(ig - ic) <= 1 and d <= xgate,
             f"spls {kw} mu {mu} card vs CPU: {ig}/{ic} iterations, {d}")
    d_pcg10 = card_vs_cpu({"solver": "pcg"}, 0.0, b, 1e-10)[0]
    Mg, rg, fg, _ = right_precond_saso(A.to(dev), 4 * n, 0.0, RNGState(3),
                                       sketch=Sg)
    Mc, rc, fc, _ = right_precond_saso(A, 4 * n, 0.0, RNGState(3), sketch=S)
    sg = torch.linalg.svdvals(A @ Mg.cpu())
    sc = torch.linalg.svdvals(A @ Mc)
    d_m = float((sg - sc).abs().max() / sc[0])
    Vg, sig_g, _ = rpc_data_svd_saso(A.to(dev), 4 * n, RNGState(3),
                                     sketch=Sg)
    Vc, sig_c, _ = rpc_data_svd_saso(A, 4 * n, RNGState(3), sketch=S)
    d_s = float((sig_g.cpu() - sig_c).abs().max() / sig_c[0])
    xg, _, ig = lsqr(A.to(dev), b.to(dev), Mg, LSQRConfig(tol=1e-12))
    xc, _, ic = lsqr(A, b, Mc, LSQRConfig(tol=1e-12))
    d_l = float(torch.linalg.norm(xg.cpu() - xc) / torch.linalg.norm(xc))
    gate(int(rg) == int(rc) and bool(fg) == bool(fc) is False
         and d_m <= 1e-9 and d_s <= 1e-12 and d_l <= lsqr_gate
         and abs(ig - ic) <= 1, "preconditioners / lsqr card vs CPU")
    rng = np.random.default_rng(17)
    Ms = sp.random(400, 400, density=0.02, random_state=rng)
    K = (Ms @ Ms.T + sp.eye(400) * 4).tocoo()
    Bs = torch.tensor(rng.standard_normal((400, 6)))
    d_op = 0.0
    for name, make in [("chol", lambda d: CholSolverLinOp(
            K.row, K.col, K.data, 400, f64, device=d)),
            ("half", lambda d: CholSolverLinOp(K.row, K.col, K.data, 400,
                                               f64, half=True, device=d)),
            ("lu", lambda d: LUSolverLinOp(K.row, K.col, K.data, 400, f64,
                                           device=d))]:
        og, oc = make(dev), make("cpu")
        for f in ("matmat", "tmatmat"):
            ref = getattr(oc, f)(Bs)
            got = getattr(og, f)(Bs.to(dev)).cpu()
            d_op = max(d_op, float((got - ref).abs().max()
                                   / ref.abs().max()))
    counts = read_counts()
    print(f"[spls-small-vs-plain] {m}x{n} f64 card vs CPU, one SASO: spls "
          f"(6 branches) worst rel |dx| {worst:.3f} of its gate (LSQR "
          f"{lsqr_gate:.1e}, PCG {pcg_gate:.1e}; PCG stopped at tol 1e-10, "
          f"not gated: {d_pcg10 / pcg_gate:.3f}); right_precond_saso "
          f"sigma(A M) {d_m:.3e}, rank {int(rg)}; rpc_data_svd_saso sigma "
          f"{d_s:.3e}; lsqr {ig}/{ic} iterations, rel |dx| {d_l:.3e}; "
          f"solver operators (chol, half, lu; matmat, tmatmat) n 400 rel "
          f"max|d| {d_op:.3e}; launches "
          f"{'none' if counts == NO_LAUNCHES else counts}", flush=True)
    gate(d_op <= 1e-12, f"solver operators card vs CPU: {d_op}")
    gate(counts == NO_LAUNCHES, f"spls-small-vs-plain: launches {counts}")


# -- the trailing-precision modes: K1/K2's forms and the drivers in them ------

def form_bound(flops: float, nbytes: float, form: str) -> dict:
    """The least time of a K1/K2 form: its products at the tensor cores'
    dense rate for the form's type (TF32 495, bf16 989 TFLOP/s; three
    products for "bf16x3"), against its bytes at 3.35 TB/s."""
    t_ops = {"tf32": flops / PEAK_TF32, "bf16": flops / PEAK_BF16,
             "bf16x3": 3 * flops / PEAK_BF16}[form]
    t_bytes = nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def form_library_ms(form: str, fn32, reps: int):
    """The library call beside a form: for "tf32" the fp32 call with TF32
    allowed (set here and put back), which takes the kernel's own fp32
    operands; none for "bf16x3" (no one call takes three bf16 products).
    The "bf16" calls round their operands to bf16 first and are
    ``mm_bf16_library`` (K1) and ``addmm_bf16_library`` (K2)."""
    if form == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return cuda_ms(fn32, reps), "TF32 allowed"
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    return None, None


def addmm_bf16_library(A, V, Z, reps: int) -> dict:
    """K2·bf16's library call: ``torch.addmm(A, Vb, Zb,
    out_dtype=torch.float32, alpha=-1)``, V and Z rounded to bf16 first
    (the two ``.bfloat16()`` passes timed apart), the fp32 A updated in
    place through ``out=A`` where the card takes it, else out of place;
    unmasked, fp32 accumulation. Returns its times and how it ran, or
    None with the card's words where it refuses both."""
    Vb, Zb = V.bfloat16(), Z.bfloat16()
    refused = []
    for how, out in (("in place, out=A", dict(out=A)), ("out of place", {})):
        def call():
            return torch.addmm(A, Vb, Zb, out_dtype=torch.float32,
                               alpha=-1.0, **out)
        try:
            call()
            torch.cuda.synchronize()
        except (RuntimeError, TypeError) as e:      # the card's words
            refused.append(f"{how}: {type(e).__name__}: {e}")
            continue
        return dict(ms=cuda_ms(call, reps), how=how, refused=refused,
                    rounding_ms=cuda_ms(lambda: (V.bfloat16(), Z.bfloat16()),
                                        reps))
    return dict(ms=None, how=None, refused=refused, rounding_ms=None)


def mm_bf16_library(V, A, reps: int) -> dict:
    """K1·bf16's library call: ``torch.mm(Vb.T, Ab,
    out_dtype=torch.float32)``, V and A rounded to bf16 first (the two
    ``.bfloat16()`` passes timed apart; A's is most of them), unmasked,
    fp32 accumulation. Returns its times, or None with the card's words
    where it refuses the call."""
    Vb, Ab = V.bfloat16(), A.bfloat16()

    def call():
        return torch.mm(Vb.T, Ab, out_dtype=torch.float32)
    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:          # the card's words
        return dict(ms=None, refused=f"{type(e).__name__}: {e}",
                    rounding_ms=None)
    return dict(ms=cuda_ms(call, reps), refused=None,
                rounding_ms=cuda_ms(lambda: (V.bfloat16(), A.bfloat16()),
                                    reps))


def yardstick_launches(counts: dict) -> dict:
    """The launches of the earlier K1/K2 forms (``YARDSTICKS``)."""
    return {k: counts[k] for k in YARDSTICKS}


def phase_wy_modes(dev) -> dict:
    """K1 and K2 in each trailing-precision form at the main path's shapes
    (V 8192x256 with A 8192x8192; K2 at k 1024): each against its plain
    version (max|d| <= 1e-5 max|plain|: the same rounded operands, fp32
    sums in another order), its error against the f64 product (<= 2x the
    plain version's; also, printed, with the accumulator never restarted,
    as against every stage, ``wy.CHUNK``), two launches bit-equal, the
    times of the kernel, the plain version and the library call by CUDA
    events, and the bound. The ring forms (csrc/wy_ring.cu: "tf32",
    "bf16" and "bf16x3" of both kernels) are timed in turns with the
    earlier forms of csrc/wy.cu ("tf32_wy", "bf16_wy", "bf16x3_wy") and
    gated faster at the main shapes and at HQRRP's (V 8192x128; K2 k 128
    and 512, where they are held to their plain versions again), their
    pre-passes held bit for bit to ``wy.tf32_tiles_reference`` /
    ``wy.bf16_tiles_reference``. The bf16 library calls are
    ``mm_bf16_library`` (K1) and ``addmm_bf16_library`` (K2)."""
    from randlapack_tpu_torch.ops import wy
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    out = {}
    m, b, w, k = N, 256, N, 1024
    V = torch.randn(m, b, generator=g, device=dev)
    A = torch.randn(m, w, generator=g, device=dev)
    mk = (torch.rand(w, generator=g, device=dev) < 0.5).float()
    ref = V.double().T @ (A.double() * mk.double())
    T = wy.tf32_tiles(V.T)
    gate(torch.equal(T.cpu().view(torch.int32),
                     wy.tf32_tiles_reference(V.T.cpu()).view(torch.int32)),
         "tf32_tiles of V^T differ from the plain pre-pass")
    for split in (False, True):
        T = wy.bf16_tiles(V.T, split)
        gate(torch.equal(
            T.cpu().view(torch.int16),
            wy.bf16_tiles_reference(V.T.cpu(), split).view(torch.int16)),
            f"bf16_tiles of V^T (split {split}) differ from the plain "
            f"pre-pass")
    del T
    print(f"[wy-modes] pre-passes of V^T {b}x{m} (TF32; bf16 with and "
          f"without the lo halves): bit-equal to the plain versions",
          flush=True)
    for form in MODES.values():
        plain = getattr(wy, f"masked_vt_a_{form}_reference")
        W = wy.masked_vt_a_form(V, A, mk, form)
        Wp = plain(V, A, mk)
        err, scale = float((W - Wp).abs().max()), float(Wp.abs().max())
        e_k, e_p = relf(W, ref), relf(Wp, ref)
        alt = 0                 # the accumulator never restarted
        W0 = wy.masked_vt_a_form(V, A, mk, form, chunk=alt)
        e_0, d_0 = relf(W0, ref), float((W0 - Wp).abs().max()) / scale
        del W0
        gate(err <= 1e-5 * scale, f"masked_vt_a_{form}: max|d| {err}")
        gate(torch.equal(W, wy.masked_vt_a_form(V, A, mk, form)),
             f"masked_vt_a_{form}: two launches differ")
        gate(e_k <= 2 * e_p, f"masked_vt_a_{form}: error against f64 "
             f"{e_k}, the plain version's {e_p}")
        ms0, ms = in_turns(
            lambda: wy.masked_vt_a_form(V, A, mk, form, chunk=alt),
            lambda: wy.masked_vt_a_form(V, A, mk, form), 100)
        plain_ms = cuda_ms(lambda: plain(V, A, mk), 10)
        more = {}
        if form == "bf16":
            info = mm_bf16_library(V, A, 100)
            lib_ms = info["ms"]
            lib = lib_call = lib_ms is not None and (
                f"torch.mm(V.bfloat16().T, A.bfloat16(), out_dtype="
                f"torch.float32), unmasked, V and A rounded beforehand (the "
                f"two .bfloat16() passes {info['rounding_ms']:.4f} ms)")
            more = dict(library_rounding_ms=info["rounding_ms"],
                        library_refused=info["refused"])
            if info["refused"]:
                print(f"[wy-modes] mm(..., out_dtype=torch.float32) "
                      f"refused, {info['refused']}", flush=True)
        else:
            lib_ms, lib = form_library_ms(form, lambda: torch.mm(V.T, A),
                                          100)
            lib_call = lib and f"torch.mm(V.T, A), unmasked, {lib}"
        out[f"masked_vt_a_{form}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **form_bound(2 * m * b * w, 4 * (m * b + m * w + w + b * w),
                         form),
            library_ms=lib_ms, library_call=lib_call or None, **more,
            err_vs_f64=e_k, plain_err_vs_f64=e_p, chunk=wy.CHUNK,
            err_vs_f64_never_restarted=e_0, ms_never_restarted=ms0,
            rel_diff_never_restarted=d_0)
        rec = out[f"masked_vt_a_{form}"]
        wy_ms, rec["ms_turns"] = in_turns(
            lambda: wy.masked_vt_a_form(V, A, mk, f"{form}_wy"),
            lambda: wy.masked_vt_a_form(V, A, mk, form), 100)
        rec["earlier_form_ms"] = wy_ms
        extra = (f"; in turns with the earlier form ({form}_wy): "
                 f"{rec['ms_turns']:.4f} against {wy_ms:.4f} ms")
        gate(rec["ms_turns"] < wy_ms, f"masked_vt_a_{form} "
             f"{rec['ms_turns']} ms not faster than {wy_ms} ms")
        print(f"[wy-modes] masked_vt_a {form} m={m} b={b} w={w}: max|d| "
              f"{err:.3e} (max|plain| {scale:.3e}); error against f64: "
              f"kernel {e_k:.3e} (chunk {wy.CHUNK}; never restarted: "
              f"{e_0:.3e}, max|d| {d_0:.2e} of max|plain|), plain "
              f"{e_p:.3e}; two launches bit-equal; kernel {ms:.4f} ms (never "
              f"restarted {ms0:.4f} ms, in turns), plain "
              f"{plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms ({lib})'}"
              f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}){extra}",
              flush=True)
    del W, Wp, ref
    Vk = torch.randn(m, k, generator=g, device=dev)
    Z = torch.randn(k, w, generator=g, device=dev)
    for X, what in ((Vk, "V"), (Z.T, "Z^T")):
        for split in (False, True):
            T = wy.bf16_tiles(X, split)
            gate(torch.equal(
                T.cpu().view(torch.int16),
                wy.bf16_tiles_reference(X.cpu(), split).view(torch.int16)),
                f"bf16_tiles of {what} (split {split}) differ from the "
                f"plain pre-pass")
    del T
    print(f"[wy-modes] bf16 pre-pass of V {m}x{k} and Z^T {w}x{k}, with "
          f"and without the lo halves: bit-equal to the plain version",
          flush=True)
    ref = A.double() - (Vk.double() @ Z.double()) * mk.double()
    for form in MODES.values():
        plain = getattr(wy, f"a_minus_vz_masked_{form}_reference")
        Ak = wy.a_minus_vz_masked_form(A.clone(), Vk, Z, mk, form)
        Ap = plain(A, Vk, Z, mk)
        err, scale = float((Ak - Ap).abs().max()), float(Ap.abs().max())
        e_k, e_p = relf(Ak, ref), relf(Ap, ref)
        alt = 0
        A0 = wy.a_minus_vz_masked_form(A.clone(), Vk, Z, mk, form, chunk=alt)
        e_0, d_0 = relf(A0, ref), float((A0 - Ap).abs().max()) / scale
        del A0
        gate(err <= 1e-5 * scale, f"a_minus_vz_masked_{form}: max|d| {err}")
        gate(torch.equal(Ak, wy.a_minus_vz_masked_form(A.clone(), Vk, Z, mk,
                                                       form)),
             f"a_minus_vz_masked_{form}: two launches differ")
        gate(e_k <= 2 * e_p, f"a_minus_vz_masked_{form}: error against f64 "
             f"{e_k}, the plain version's {e_p}")
        ms0, ms = in_turns(
            lambda: wy.a_minus_vz_masked_form(Ak, Vk, Z, mk, form,
                                              chunk=alt),
            lambda: wy.a_minus_vz_masked_form(Ak, Vk, Z, mk, form), 20)
        plain_ms = cuda_ms(lambda: plain(A, Vk, Z, mk), 5)
        more = {}
        if form == "bf16":
            info = addmm_bf16_library(Ak, Vk, Z, 20)
            lib_ms = info["ms"]
            lib = lib_call = info["how"] and (
                f"torch.addmm(A, V.bfloat16(), Z.bfloat16(), out_dtype="
                f"torch.float32, alpha=-1), {info['how']}, unmasked, V and Z "
                f"rounded beforehand (the two .bfloat16() passes "
                f"{info['rounding_ms']:.4f} ms)")
            more = dict(library_rounding_ms=info["rounding_ms"],
                        library_refused=info["refused"])
            for words in info["refused"]:
                print(f"[wy-modes] addmm(..., out_dtype=torch.float32) "
                      f"refused, {words}", flush=True)
        else:
            lib_ms, lib = form_library_ms(
                form, lambda: Ak.addmm_(Vk, Z, alpha=-1.0), 20)
            lib_call = lib and f"A.addmm_(V, Z, alpha=-1), unmasked, {lib}"
        out[f"a_minus_vz_masked_{form}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **form_bound(2 * m * k * w + 2 * m * w,
                         4 * (2 * m * w + m * k + k * w + w), form),
            library_ms=lib_ms, library_call=lib_call, **more,
            err_vs_f64=e_k, plain_err_vs_f64=e_p, chunk=wy.CHUNK,
            err_vs_f64_never_restarted=e_0, ms_never_restarted=ms0,
            rel_diff_never_restarted=d_0)
        rec = out[f"a_minus_vz_masked_{form}"]
        wy_ms, rec["ms_turns"] = in_turns(
            lambda: wy.a_minus_vz_masked_form(Ak, Vk, Z, mk, f"{form}_wy"),
            lambda: wy.a_minus_vz_masked_form(Ak, Vk, Z, mk, form), 20)
        rec["earlier_form_ms"] = wy_ms
        extra = (f"; in turns with the earlier form ({form}_wy): "
                 f"{rec['ms_turns']:.4f} against {wy_ms:.4f} ms")
        gate(rec["ms_turns"] < wy_ms, f"a_minus_vz_masked_{form} "
             f"{rec['ms_turns']} ms not faster than {wy_ms} ms")
        print(f"[wy-modes] a_minus_vz_masked {form} m={m} k={k} w={w}: "
              f"max|d| {err:.3e} (max|plain| {scale:.3e}); error against "
              f"f64: kernel {e_k:.3e} (chunk {wy.CHUNK}; never restarted: "
              f"{e_0:.3e}, max|d| {d_0:.2e} of max|plain|), plain {e_p:.3e}; two launches bit-equal; "
              f"kernel {ms:.4f} ms (never restarted {ms0:.4f} ms, in turns), "
              f"plain "
              f"{plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms ({lib})'}"
              f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}){extra}",
              flush=True)
    del Ak, Ap, Vk, Z, ref
    # HQRRP's shapes: V 8192x128 (K1), k 128 and 512 (K2), in turns
    turns = {}
    for kk in (128, 512):
        Vh = torch.randn(m, kk, generator=g, device=dev)
        Zh = torch.randn(kk, w, generator=g, device=dev)
        for form in MODES.values() if kk == 128 else ():
            W = wy.masked_vt_a_form(Vh, A, mk, form)
            Wp = getattr(wy, f"masked_vt_a_{form}_reference")(Vh, A, mk)
            err = float((W - Wp).abs().max()) / float(Wp.abs().max())
            wy_ms, new_ms = in_turns(
                lambda: wy.masked_vt_a_form(Vh, A, mk, f"{form}_wy"),
                lambda: wy.masked_vt_a_form(Vh, A, mk, form), 100)
            gate(err <= 1e-5, f"masked_vt_a_{form} b={kk}: max|d| {err}")
            gate(new_ms < wy_ms, f"masked_vt_a_{form} b={kk}: {new_ms} ms "
                 f"not faster than {wy_ms} ms")
            out[f"masked_vt_a_{form}"][f"b{kk}"] = dict(
                ms=new_ms, earlier_form_ms=wy_ms, max_rel_diff=err)
            print(f"[wy-modes] masked_vt_a {form} m={m} b={kk} w={w}: max|d| "
                  f"{err:.2e} of max|plain|; {new_ms:.4f} ms against the "
                  f"earlier form's {wy_ms:.4f} ms in turns", flush=True)
            del W, Wp
        for form in MODES.values():
            Ak = wy.a_minus_vz_masked_form(A.clone(), Vh, Zh, mk, form)
            Ap = getattr(wy, f"a_minus_vz_masked_{form}_reference")(
                A, Vh, Zh, mk)
            err = float((Ak - Ap).abs().max()) / float(Ap.abs().max())
            gate(err <= 1e-5,
                 f"a_minus_vz_masked_{form} k={kk}: max|d| {err}")
            wy_ms, new_ms = in_turns(
                lambda: wy.a_minus_vz_masked_form(Ak, Vh, Zh, mk,
                                                  f"{form}_wy"),
                lambda: wy.a_minus_vz_masked_form(Ak, Vh, Zh, mk, form), 20)
            gate(new_ms < wy_ms, f"a_minus_vz_masked_{form} k={kk}: "
                 f"{new_ms} ms not faster than {wy_ms} ms")
            turns[form, kk] = dict(ms=new_ms, earlier_form_ms=wy_ms,
                                   max_rel_diff=err)
            print(f"[wy-modes] a_minus_vz_masked {form} m={m} k={kk} w={w}: "
                  f"max|d| {err:.2e} of max|plain|; {new_ms:.4f} ms against "
                  f"the earlier form's {wy_ms:.4f} ms in turns",
                  flush=True)
            del Ak, Ap
    for (form, kk), t in turns.items():
        out[f"a_minus_vz_masked_{form}"][f"k{kk}"] = t
    return out


def trailing_norms(R) -> torch.Tensor:
    """‖R[i:, i:]‖_F for every i, in f64 (benchmarks/qr_quality.py's
    ``trailing_norms``)."""
    n = min(R.shape)
    sq = torch.triu(R[:n, :n].double()) ** 2
    return torch.sqrt(torch.diagonal(
        sq.flip(0, 1).cumsum(0).cumsum(1).flip(0, 1)))


# the matrix, state and geqp3 yardstick [bqrrp-speed] builds,
# [hqrrp-speed] reuses and [precision] reuses the yardstick of
SPEED_INPUT = {}
# what [rsvd], [abrik] and [spls] compute in f64 on their inputs and
# [precision] reuses on the same ones: config 1's optimal rank-256 tail,
# config 5's σ from the f64 call, config 2's κ
PRECISION_INPUT = {}


def speed_quality(A, Q, R, J, fail, tq) -> dict:
    """Residual, orthogonality, ``fail`` and the trailing-norm ratios
    against geqp3 over the leading half (docs/pivot_quality_f32.md)."""
    res = float(torch.linalg.norm(Q @ R - A[:, J]) / torch.linalg.norm(A))
    orth = float(torch.linalg.norm(
        Q.T @ Q - torch.eye(Q.shape[1], dtype=Q.dtype, device=Q.device)))
    ratio = tq[:N // 2] / trailing_norms(R)[:N // 2]
    return dict(res=res, orth=orth, fail=bool(fail),
                finite=bool(torch.isfinite(Q).all()
                            and torch.isfinite(R).all()),
                rmin=float(ratio.min()), rmax=float(ratio.max()))


def speed_refusals(tp: str, q: dict) -> list:
    """The gates a run in mode ``tp`` fails: ``fail``, non-finite output,
    the residual against the mode's gate (RES_GATE for "highest"),
    orthogonality, the pivot band."""
    res_gate = MODE_RES_GATE.get(tp, RES_GATE)
    bad = []
    if q["fail"]:
        bad.append("fail")
    if not q["finite"]:
        bad.append("non-finite")
    if not q["res"] <= res_gate:
        bad.append(f"residual {q['res']:.3e} > {res_gate:.3e}")
    if not q["orth"] <= ORTH_GATE:
        bad.append(f"orthogonality {q['orth']:.3e}")
    if not PIVOT_BAND[0] <= q["rmin"] <= q["rmax"] <= PIVOT_BAND[1]:
        bad.append(f"pivot ratios [{q['rmin']:.3f}, {q['rmax']:.3f}]")
    return bad


def mode_turns(run_highest, run_mode, tp: str) -> tuple:
    """Five runs each of ``run_highest()`` and ``run_mode()`` in turns
    (H M M H H M M H H M), CUDA events: the best of each."""
    times = {"highest": [], tp: []}
    for who in ("highest", tp, tp, "highest") * 2 + ("highest", tp):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        (run_highest if who == "highest" else run_mode)()
        end.record()
        torch.cuda.synchronize()
        times[who].append(start.elapsed_time(end) / 1e3)
    return min(times["highest"]), min(times[tp]), times


def busy_share(fn) -> tuple:
    """Card-busy milliseconds and the idle share of one profiled call."""
    _, wall, rows = device_profile(fn)
    busy = sum(ms for _, ms, _ in rows)
    return busy, 1.0 - busy / (wall * 1e3)


def phase_bqrrp_speed(dev, card: str) -> dict:
    """bench.py's BQRRP speed mode (bench.py:302-327: b 256, 2 pivot
    candidates, 2 stages, update defer 4) on phase_main's matrix and
    sketch, in each trailing-precision mode: launches (the mode's K1 form
    32, its K2 form 8, K3 32, the "highest" K1/K2 none), the mode's
    residual gate, orthogonality, ``fail`` and the trailing-norm ratios
    against LAPACK geqp3 in f64; best of 5 in turns with "highest" by CUDA
    events; card-busy time and idle share from one profiled call. Then the
    controls, which the same gates must refuse: the first group's trailing
    K2 left out, and three bf16 products with lo·hi dropped. Returns the
    launch counts by mode."""
    import scipy.linalg
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import (BQRRPConfig, bqrrp_factored,
                                              bqrrp_q)
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.ops import wy
    bq = sys.modules["randlapack_tpu_torch.drivers.bqrrp"]
    A, st = fast_decay_matrix(N, N, RNGState(0), device=dev)
    t0 = time.perf_counter()
    Rq = scipy.linalg.qr(A.double().cpu().numpy(), mode="r",
                         pivoting=True)[0]
    tq = trailing_norms(torch.from_numpy(Rq).to(dev))
    t_qp3 = time.perf_counter() - t0
    del Rq
    SPEED_INPUT.update(A=A, st=st, tq=tq)
    print(f"[bqrrp-speed] yardstick: LAPACK geqp3 (scipy {scipy.__version__}"
          f") of the {N}x{N} matrix in f64 on the host, {t_qp3:.1f} s",
          flush=True)
    base = dict(block_size=256, pivot_candidates=2, stages=2, update_defer=4)
    hi_cfg = BQRRPConfig(**base)

    def quality(cfg):
        fac, _ = bqrrp_factored(A, cfg, st)
        return speed_quality(A, bqrrp_q(fac), fac.R, fac.J, fac.fail, tq)

    busy, idle = busy_share(lambda: bqrrp_factored(A, hi_cfg, st))
    print(f"[bqrrp-speed] highest, one profiled call: card busy {busy:.2f} "
          f"ms, idle {100 * idle:.1f} %", flush=True)
    counts = {}
    for tp, form in MODES.items():
        cfg = BQRRPConfig(**base, trailing_precision=tp)
        bqrrp_factored(A, cfg, st)                      # warm-up
        torch.cuda.synchronize()
        reset_counts()
        fac, _ = bqrrp_factored(A, cfg, st)
        torch.cuda.synchronize()
        counts[tp] = read_counts()
        expected = {**NO_LAUNCHES, f"masked_vt_a_{form}": 32,
                    f"a_minus_vz_masked_{form}": 8, "getrfnp": 32}
        gate(counts[tp] == expected,
             f"bqrrp {tp}: launches {counts[tp]} != {expected}")
        q = speed_quality(A, bqrrp_q(fac), fac.R, fac.J, fac.fail, tq)
        t_hi, t_m, runs = mode_turns(lambda: bqrrp_factored(A, hi_cfg, st),
                                     lambda: bqrrp_factored(A, cfg, st), tp)
        busy, idle = busy_share(lambda: bqrrp_factored(A, cfg, st))
        print(f"[bqrrp-speed] bqrrp_factored {N}x{N} f32 b256/pc2/stages2/"
              f"defer4 trailing={tp} ({form}) on {card}: best of 5 "
              f"{t_m:.4f} s against highest {t_hi:.4f} s in turns "
              f"({t_hi / t_m:.3f}x; runs {[round(x, 4) for x in runs[tp]]} "
              f"and {[round(x, 4) for x in runs['highest']]}); card busy "
              f"{busy:.2f} ms, idle {100 * idle:.1f} %; residual "
              f"{q['res']:.3e} (gate {MODE_RES_GATE[tp]:.3e}), orth "
              f"{q['orth']:.3e} (gate {ORTH_GATE:.2e}), fail {q['fail']}, "
              f"pivot ratios against geqp3 [{q['rmin']:.3f}, "
              f"{q['rmax']:.3f}] (band {PIVOT_BAND}); launches "
              f"{ {c: v for c, v in counts[tp].items() if v} }, the earlier "
              f"forms' {yardstick_launches(counts[tp])}", flush=True)
        refused = speed_refusals(tp, q)
        gate(not refused, f"bqrrp {tp}: {refused}")
    q = quality(hi_cfg)
    print(f"[bqrrp-speed] highest beside them: residual {q['res']:.3e}, "
          f"orth {q['orth']:.3e}, pivot ratios [{q['rmin']:.3f}, "
          f"{q['rmax']:.3f}]", flush=True)
    gate(not speed_refusals("highest", q), "bqrrp highest")

    # -- controls: wrong answers the gates must refuse ---------------------
    mixed = bq.a_minus_vz_masked_mixed, bq.masked_vt_a_mixed
    calls = []

    def skip_first_group(A_, V, Z, mask, tp):
        calls.append(1)
        return A_ if len(calls) == 1 else mixed[0](A_, V, Z, mask, tp)

    def two_products(X, Y):
        xh, xl = (t.float() for t in wy._bf16_halves(X))
        yh, yl = (t.float() for t in wy._bf16_halves(Y))
        return xh @ yh + xh @ yl                      # lo·hi dropped

    controls = {
        ("high", "the first group's trailing K2 left out"): dict(
            a_minus_vz_masked_mixed=skip_first_group),
        ("bf16_3x_emul", "three bf16 products with lo·hi dropped"): dict(
            masked_vt_a_mixed=lambda V, A_, mask, tp: two_products(
                V.T, A_ * mask[None, :]),
            a_minus_vz_masked_mixed=lambda A_, V, Z, mask, tp: A_.sub_(
                two_products(V, Z) * mask[None, :]))}
    for (tp, what), patch in controls.items():
        calls.clear()
        for name, fn in patch.items():
            setattr(bq, name, fn)
        try:
            q = quality(BQRRPConfig(**base, trailing_precision=tp))
        finally:
            bq.a_minus_vz_masked_mixed, bq.masked_vt_a_mixed = mixed
        refused = speed_refusals(tp, q)
        print(f"[bqrrp-speed-controls] {tp}, {what}: residual "
              f"{q['res']:.3e}, orth {q['orth']:.3e}, fail {q['fail']}, "
              f"pivot ratios [{q['rmin']:.3f}, {q['rmax']:.3f}]: refused by "
              f"{refused or 'nothing'}", flush=True)
        gate(bool(refused), f"control not refused: {tp}, {what}")
    return counts


def phase_hqrrp_speed(dev, card: str) -> dict:
    """bench.py's HQRRP speed mode (bench.py:458-474: b 128, update defer
    4) in each trailing-precision mode on [bqrrp-speed]'s matrix (its
    geqp3 yardstick reused): launches (the mode's K1 form 64, one a block;
    its K2 form 16, one a group of 4; K5 64, K6 64; "highest" K1/K2 none),
    the same gates, best of 5 in turns with "highest", card-busy time.
    Returns the launch counts by mode."""
    from randlapack_tpu_torch.drivers import HQRRPConfig, hqrrp
    A, st, tq = SPEED_INPUT["A"], SPEED_INPUT["st"], SPEED_INPUT["tq"]
    hi_cfg = HQRRPConfig(block_size=128, update_defer=4)
    hqrrp(A, hi_cfg, st)                                # warm-up
    busy, idle = busy_share(lambda: hqrrp(A, hi_cfg, st))
    print(f"[hqrrp-speed] highest, one profiled call: card busy {busy:.2f} "
          f"ms, idle {100 * idle:.1f} %", flush=True)
    counts = {}
    for tp, form in MODES.items():
        cfg = HQRRPConfig(block_size=128, update_defer=4,
                          trailing_precision=tp)
        hqrrp(A, cfg, st)                               # warm-up
        torch.cuda.synchronize()
        reset_counts()
        Q, R, J, _, fail, _ = hqrrp(A, cfg, st)
        torch.cuda.synchronize()
        counts[tp] = read_counts()
        expected = {**NO_LAUNCHES, f"masked_vt_a_{form}": 64,
                    f"a_minus_vz_masked_{form}": 16,
                    "qrcp_select_pivots": 64, "qrcp_panel": 64}
        gate(counts[tp] == expected,
             f"hqrrp {tp}: launches {counts[tp]} != {expected}")
        q = speed_quality(A, Q, R, J, fail, tq)
        del Q, R
        t_hi, t_m, runs = mode_turns(lambda: hqrrp(A, hi_cfg, st),
                                     lambda: hqrrp(A, cfg, st), tp)
        busy, idle = busy_share(lambda: hqrrp(A, cfg, st))
        print(f"[hqrrp-speed] hqrrp {N}x{N} f32 b128/defer4 trailing={tp} "
              f"({form}) on {card}: best of 5 {t_m:.4f} s against highest "
              f"{t_hi:.4f} s in turns ({t_hi / t_m:.3f}x); card busy "
              f"{busy:.2f} ms, idle {100 * idle:.1f} %; residual "
              f"{q['res']:.3e} (gate {MODE_RES_GATE[tp]:.3e}), orth "
              f"{q['orth']:.3e}, fail {q['fail']}, pivot ratios against "
              f"geqp3 [{q['rmin']:.3f}, {q['rmax']:.3f}]; launches "
              f"{ {c: v for c, v in counts[tp].items() if v} }, the earlier "
              f"forms' {yardstick_launches(counts[tp])}", flush=True)
        refused = speed_refusals(tp, q)
        gate(not refused, f"hqrrp {tp}: {refused}")
    del SPEED_INPUT["A"]              # [precision] remakes it, keeps tq
    return counts


def phase_cqrrpt_modes(dev, card: str) -> dict:
    """BASELINE config 3 (CQRRPT of the 131072x2048 f32 matrix, explicit
    BQRRP b 256 on the sketch) with the sketch BQRRP's trailing products in
    each mode (``bqrrp_trailing_precision``) beside "highest": J against
    "highest"'s, max|dR|/max|R|, residual and orthogonality; gated on 8 K2
    launches of the mode's form (one a block of the sketch BQRRP) and J a
    permutation; "bf16_3x_emul" on config 3's gates (residual,
    orthogonality, ``fail``); the one-product modes, which this
    configuration's sketch QRCP cannot afford, on CQRRPT's contract
    (``fail`` raised or a finite output within the residual gate).
    Returns the launch counts by mode."""
    import dataclasses
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import CQRRPTConfig, QRCPKind, cqrrpt
    from randlapack_tpu_torch.gen import fast_decay_matrix
    A, st = fast_decay_matrix(TALL_M, TALL_N, RNGState(2), decay=9.0,
                              device=dev)
    n = A.shape[1]
    cfg3 = CQRRPTConfig(sketch="srht", qrcp=QRCPKind.bqrrp,
                        bqrrp_block=256, bqrrp_pivot_candidates=2,
                        trsm_mode="blockinv")
    (_, Rh, Jh, _, _, _), t_hi, _, _ = timed_run(lambda: cqrrpt(A, cfg3, st),
                                                 3)
    counts = {}
    for tp, form in MODES.items():
        cfg = dataclasses.replace(cfg3, bqrrp_trailing_precision=tp)
        (Q, R, J, rank, fail, _), times, counts[tp], peak = timed_run(
            lambda: cqrrpt(A, cfg, st), 3)
        k = int(rank)
        res, orth = tall_quality(A, Q, R, J, k)
        orth_gate = RES_GATE * math.sqrt(k)
        same_j = torch.equal(J, Jh)
        dR = float((R - Rh).abs().max()) / float(Rh.abs().max())
        print(f"[cqrrpt-modes] {TALL_M}x{n} f32 config 3, "
              f"bqrrp_trailing_precision={tp} ({form}) on {card}: best of 3 "
              f"{min(times):.4f} s against highest {min(t_hi):.4f} s; J "
              f"equal to highest's {same_j}, max|dR|/max|R| {dR:.3e}; "
              f"residual {res:.3e} (gate {RES_GATE:.2e}), orth {orth:.3e} "
              f"(config 3's gate {orth_gate:.2e}), rank {k}, fail "
              f"{bool(fail)}, peak memory {peak:.2f} GiB, launches "
              f"{ {c: v for c, v in counts[tp].items() if v} }", flush=True)
        expected = {**NO_LAUNCHES, f"a_minus_vz_masked_{form}": 8}
        gate(counts[tp] == expected,
             f"cqrrpt {tp}: launches {counts[tp]} != {expected}")
        gate(torch.equal(torch.sort(J).values, torch.arange(n, device=dev)),
             f"cqrrpt {tp}: J is not a permutation")
        finite = bool(torch.isfinite(Q).all() and torch.isfinite(R).all())
        if tp == "bf16_3x_emul":
            # config 3's gates. J and R are printed, not gated: the sketch
            # BQRRP's R rows read the trailing updates, so no mode leaves
            # them as "highest" has them at this configuration (ROADMAP
            # §3); the JAX package's test_cqrrpt_insensitive_to_sketch_
            # trailing holds them only through geqp3, which never reads
            # the option
            gate(finite and not bool(fail), f"cqrrpt {tp}: fail {fail}, "
                 f"finite {finite}")
            gate(res <= RES_GATE, f"cqrrpt {tp}: residual {res}")
            gate(orth <= orth_gate, f"cqrrpt {tp}: orthogonality {orth}")
        else:
            # one product of TF32 or bf16 is too coarse for config 3's
            # sketch QRCP (ROADMAP §3: its R rows read the trailing
            # updates): held to CQRRPT's contract, ``fail`` raised or a
            # finite output within the residual gate
            gate(bool(fail) or (finite and res <= RES_GATE),
                 f"cqrrpt {tp}: fail False with residual {res}, finite "
                 f"{finite}")
        del Q, R
    return counts


# -- the driver-level precision= ---------------------------------------------

PRECISIONS = ("highest", "high", "default")
# the drivers whose wall is paced by the host: their card-busy time is
# read from one profiled call
HOST_PACED = ("bqrrp", "rsvd", "cqrrpt", "abrik")
# [precision]'s gates (PERF.md §2, set before the first card run). Each
# reading's bound is an upper one, a pair a band. "highest" keeps each
# driver's own gates (above). "high" and "default" come from
# tools/precision_residuals.py, the drivers on the CPU with every
# precision= product's operands rounded to TF32 or bf16: the reading r at
# the larger of two emulated sizes, times its growth g ≥ 1 from the
# smaller size to that one for each doubling d left to the card's size,
# times 2 (4 for "high": the library's TF32 rounding, to nearest or
# truncated, is not known off the card): 2·r·g^d. RSVD's error ratio
# takes the factor on the mode's excess over "highest": 1.12·(1 +
# 2·(r/r_highest − 1)). KRILL and SPLS do not converge in "high" and
# "default" (PCG and LSQR with rounded operator products; ROADMAP §3):
# they are held to the driver's contract, a finite output within the
# iteration budget.
_BAND = (PIVOT_BAND[0], PIVOT_BAND[1])
PRECISION_GATES = {
    "bqrrp": {
        "highest": dict(res=RES_GATE, orth=ORTH_GATE, rmin=_BAND, rmax=_BAND),
        "high": dict(res=2.8e-3, orth=0.0761, rmin=_BAND, rmax=_BAND),
        "default": dict(res=1.12e-2, orth=0.302, rmin=_BAND, rmax=_BAND)},
    "rsvd": {
        "highest": dict(ratio=RSVD_TAIL_FACTOR, orth=RSVD_ORTH_GATE),
        "high": dict(ratio=1.12, orth=0.0193),
        "default": dict(ratio=1.244, orth=0.0748)},
    "cqrrpt": {
        "highest": dict(res=RES_GATE, orth=RES_GATE * math.sqrt(TALL_N),
                        rank=(TALL_N, TALL_N)),
        "high": dict(res=1.85e-3, orth=0.132, rank=(TALL_N, TALL_N)),
        "default": dict(res=7.44e-3, orth=1.17, rank=(TALL_N, TALL_N))},
    "abrik": {
        "highest": dict(sgap=1e-4, orth=ABRIK_ORTH_GATE,
                        iters=(ABRIK_Q, ABRIK_Q)),
        "high": dict(sgap=8.51e-5, orth=5.68e-3, iters=(ABRIK_Q, ABRIK_Q)),
        "default": dict(sgap=3.16e-4, orth=1.73e-2,
                        iters=(ABRIK_Q, ABRIK_Q))},
    "krill": {
        "highest": dict(backward=1.0, iters=(0, 199)),
        "high": dict(iters=(0, 200)),
        "default": dict(iters=(0, 200))},
    "spls": {
        # rel: [spls-gates]' (1 + 2κ)·eps32, κ from the f64 R of A, set
        # by precision_cases (the residual moves with the SASO scatter's
        # atomics between runs)
        "highest": dict(rel=None, ne=math.sqrt(SPLS_N) * EPS32,
                        iters=(0, SPLS_ITERS - 1)),
        "high": dict(iters=(0, SPLS_ITERS)),
        "default": dict(iters=(0, SPLS_ITERS))},
}
# the precision each driver's [precision-controls] wrong answer runs at:
# one where its gates hold the driver to more than its contract
CONTROL_PRECISION = {"bqrrp": "high", "rsvd": "high", "cqrrpt": "high",
                     "abrik": "high", "krill": "highest",
                     "spls": "highest"}


def _f64_res_orth(A, Q, R, J):
    """‖QR − A[:, J]‖_F/‖A‖_F and ‖QᵀQ − I‖_F, in f64."""
    Qd, Rd = Q.double(), R.double()
    AJ = A.index_select(1, J).double()
    res = float(torch.linalg.norm(Qd @ Rd - AJ) / torch.linalg.norm(AJ))
    orth = float(torch.linalg.norm(
        Qd.T @ Qd - torch.eye(Qd.shape[1], dtype=Qd.dtype, device=Qd.device)))
    return res, orth


def _finite(*ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def _setup_seconds(t0: float, dev) -> float:
    """Seconds since ``t0``, the device's queue drained first."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def precision_cases(dev, scale: dict | None = None) -> dict:
    """The [precision] phase's drivers at full width (``scale`` None) or
    with each size divided by ``scale[name]`` (the CPU emulation,
    tools/precision_residuals.py). Each case: ``run(precision)`` → the
    driver's output, ``quality(output)`` → its readings, ``control(run,
    precision)`` → a wrong answer's readings with what was wrong, and
    ``expected(output)`` → the launch counts its path must show on the
    card."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import (PCGConfig, PCGSaddleConfig,
                                            QBConfig)
    from randlapack_tpu_torch.drivers import (
        ABRIKConfig, BQRRPConfig, CQRRPTConfig, KrillConfig, QRCPKind,
        RSVDConfig, SPLSConfig, abrik, bqrrp_factored, bqrrp_q, cqrrpt,
        krill_full_rpchol, rsvd_fixed_rank, spls)
    from randlapack_tpu_torch.gen import fast_decay_matrix
    bq = sys.modules["randlapack_tpu_torch.drivers.bqrrp"]
    scale = scale or {}
    cases = {}

    # -- BQRRP, the 8192² headline (bench.py:108-190) ----------------------
    t0 = time.perf_counter()
    s = scale.get("bqrrp", 1)
    n = N // s
    if s == 1 and "tq" in SPEED_INPUT:
        # [bqrrp-speed]'s matrix (one GEMM) and its host geqp3 yardstick
        A, st = fast_decay_matrix(n, n, RNGState(0), device=dev)
        tq = SPEED_INPUT["tq"]
    else:
        import scipy.linalg
        A, st = fast_decay_matrix(n, n, RNGState(0), device=dev)
        tq = trailing_norms(torch.from_numpy(scipy.linalg.qr(
            A.double().cpu().numpy(), mode="r", pivoting=True)[0]).to(dev))
    bcfg = BQRRPConfig(block_size=256, pivot_candidates=2, stages=2,
                       update_defer=4)

    def bqrrp_quality(fac, A=A, tq=tq):
        res, orth = _f64_res_orth(A, bqrrp_q(fac), fac.R, fac.J)
        ratio = tq[:n // 2] / trailing_norms(fac.R)[:n // 2]
        return dict(res=res, orth=orth, fail=bool(fac.fail),
                    finite=_finite(fac.V, fac.R),
                    rmin=float(ratio.min()), rmax=float(ratio.max()))

    def bqrrp_control(run, p):
        mixed, calls = bq.a_minus_vz_masked_mixed, []

        def skip_first_group(A_, V, Z, mask, tp):
            calls.append(1)
            return A_ if len(calls) == 1 else mixed(A_, V, Z, mask, tp)
        bq.a_minus_vz_masked_mixed = skip_first_group
        try:
            return "the first group's trailing K2 left out", \
                bqrrp_quality(run(p))
        finally:
            bq.a_minus_vz_masked_mixed = mixed

    cases["bqrrp"] = dict(
        setup_s=_setup_seconds(t0, dev),
        what=f"bqrrp_factored {n}x{n} f32 b256/pc2/stages2/defer4, "
        "trailing highest",
        run=lambda p: bqrrp_factored(A, bcfg, st, p)[0],
        quality=bqrrp_quality, control=bqrrp_control,
        expected=lambda _: EXPECTED_LAUNCHES)

    # -- RSVD, BASELINE config 1 (bench.py:336-357) --------------------------
    t0 = time.perf_counter()
    s = scale.get("rsvd", 1)
    rn, rk, rb = RSVD_N // s, RSVD_K // s, RSVD_B // s
    Ar, str_ = fast_decay_matrix(rn, rn, RNGState(1), decay=80.0, device=dev)
    if s == 1 and "rsvd_tail" in PRECISION_INPUT:
        tail = PRECISION_INPUT["rsvd_tail"]
    else:
        sig = torch.linalg.svdvals(Ar.double())
        tail = float(torch.linalg.norm(sig[rk:]) / torch.linalg.norm(sig))
    rcfg = RSVDConfig(QBConfig(block_size=rb))

    def rsvd_quality(out, Ar=Ar):
        U, S, Vt = out[:3]
        Ad = Ar.double()
        res = float(torch.linalg.norm(Ad - (U.double() * S.double())
                                      @ Vt.double()) / torch.linalg.norm(Ad))
        eye = torch.eye(rk, dtype=torch.float64, device=Ar.device)
        return dict(ratio=res / tail, err=float(out[3]),
                    orth=max(float(torch.linalg.norm(
                        U.double().T @ U.double() - eye)), float(
                        torch.linalg.norm(Vt.double() @ Vt.double().T
                                          - eye))),
                    finite=_finite(U, S, Vt))

    def rsvd_control(run, p):
        U, S, Vt, err, st2 = run(p)
        S = S.clone()
        S[-rb:] = 0.0
        return "the last QB block's triplets dropped", \
            rsvd_quality((U, S, Vt, err, st2))

    cases["rsvd"] = dict(
        setup_s=_setup_seconds(t0, dev),
        what=f"rsvd_fixed_rank {rn}x{rn} f32 decay 80, rank {rk}, block "
        f"{rb} (tail {tail:.4e})",
        run=lambda p: rsvd_fixed_rank(Ar, rk, rcfg, str_, p),
        quality=rsvd_quality, control=rsvd_control,
        expected=lambda _: NO_LAUNCHES)

    # -- CQRRPT, BASELINE config 3 -------------------------------------------
    t0 = time.perf_counter()
    s = scale.get("cqrrpt", 1)
    Ac, stc = fast_decay_matrix(TALL_M // s, TALL_N // s, RNGState(2),
                                decay=9.0, device=dev)
    ccfg = CQRRPTConfig(sketch="srht", qrcp=QRCPKind.bqrrp, bqrrp_block=256,
                        bqrrp_pivot_candidates=2, trsm_mode="blockinv")

    def cqrrpt_quality(out, Ac=Ac):
        Q, R, J, rank, fail = out[:5]
        res, orth = _f64_res_orth(Ac, Q, R, J)
        return dict(res=res, orth=orth, fail=bool(fail), rank=int(rank),
                    finite=_finite(Q, R))

    def cqrrpt_control(run, p):
        Q, R, J, rank, fail, st2 = run(p)
        R = R.clone()
        R[0] *= 1.1
        return "R's first row scaled by 1.1", \
            cqrrpt_quality((Q, R, J, rank, fail))

    cases["cqrrpt"] = dict(
        setup_s=_setup_seconds(t0, dev),
        what=f"cqrrpt {Ac.shape[0]}x{Ac.shape[1]} f32 decay 9, srht, bqrrp "
        "b256 pc2, blockinv",
        run=lambda p: cqrrpt(Ac, ccfg, stc, p),
        quality=cqrrpt_quality, control=cqrrpt_control,
        expected=lambda _: NO_LAUNCHES)

    # -- ABRIK, BASELINE config 5 (bench.py:482-500) -------------------------
    t0 = time.perf_counter()
    s = scale.get("abrik", 1)
    am, an, ak, ab = ABRIK_M // s, ABRIK_N // s, ABRIK_K // s, ABRIK_B // s
    Aa, sta = fast_decay_matrix(am, an, RNGState(5), decay=12.0, device=dev)
    acfg = ABRIKConfig(block_size=ab, max_iters=ABRIK_Q)
    if s == 1 and "abrik_S64" in PRECISION_INPUT:
        S64 = PRECISION_INPUT["abrik_S64"]
    else:
        v0 = torch.randn((an, ab), generator=sta.spawn(dev)[0], device=dev)
        S64 = abrik(Aa.double(), ak, acfg, sta, v0=v0.double())[1]

    def abrik_quality(out):
        U, S, Vt = out[:3]
        eye = torch.eye(ak, dtype=torch.float64, device=U.device)
        return dict(sgap=float((S.double() - S64).abs().max() / S64[0]),
                    orth=float(torch.linalg.norm(U.double().T @ U.double()
                                                 - eye)),
                    iters=int(out[3]["num_krylov_iters"]),
                    finite=_finite(U, S, Vt))

    def abrik_control(run, p):
        U, S, Vt, info, st2 = run(p)
        return "sigma_0 scaled by 1.01", abrik_quality(
            (U, S * torch.where(torch.arange(ak, device=S.device) == 0,
                                1.01, 1.0), Vt, info, st2))

    cases["abrik"] = dict(
        setup_s=_setup_seconds(t0, dev),
        what=f"abrik {am}x{an} f32 decay 12, k {ak}, block {ab}, "
        f"{ABRIK_Q} iterations (against the f64 call's sigma)",
        run=lambda p: abrik(Aa, ak, acfg, sta, precision=p),
        quality=abrik_quality, control=abrik_control,
        expected=lambda _: NO_LAUNCHES)

    # -- KRILL, n 65536, k 1024, f32 -----------------------------------------
    t0 = time.perf_counter()
    s = scale.get("krill", 1)
    kn, kk, mu = KRILL_N // s, KRILL_K // s, 1e-2
    G, H = krill_problem(kn, 1, mu, dev)
    kcfg = KrillConfig(k=kk, rpchol_block=64,
                       pcg=PCGConfig(tol=1e-5, max_iters=200))
    ones = torch.ones((kn, 1), dtype=H.dtype, device=H.device)
    nrm_K = float(torch.linalg.norm(G.with_reg(False).matmat(ones))
                  / math.sqrt(kn))

    def krill_quality(out):
        X, hist, iters = out[:3]
        res = torch.linalg.norm(G.matmat(X) - H, dim=0)
        back = float(((res / ((nrm_K + mu) * torch.linalg.norm(X, dim=0)))
                      / EPS32).max())
        return dict(backward=back, iters=int(iters),
                    recursive=float((hist[iters] / hist[0]).max()),
                    finite=_finite(X))

    def krill_control(run, p):
        X, hist, iters, st2 = run(p)
        return "x halved", krill_quality((X / 2, hist, iters, st2))

    cases["krill"] = dict(
        setup_s=_setup_seconds(t0, dev),
        what=f"krill_full_rpchol n {kn} d 8 f32, k {kk}, mu {mu:g}",
        run=lambda p: krill_full_rpchol(G, H, mu, kcfg, RNGState(6), p),
        quality=krill_quality, control=krill_control,
        expected=lambda out: {**NO_LAUNCHES, "kernel_matmat": out[2] + 1})

    # -- SPLS, BASELINE config 2 ---------------------------------------------
    t0 = time.perf_counter()
    s = scale.get("spls", 1)
    sm, sn = SPLS_M // s, SPLS_N // s
    As, _ = fast_decay_matrix(sm, sn, RNGState(3), decay=7.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    xt = torch.randn(sn, generator=g, device=dev)
    bs = As @ xt
    As64 = As.double()
    fro2 = float(torch.linalg.norm(As64) ** 2)
    if s == 1 and "spls_kappa" in PRECISION_INPUT:
        kappa = PRECISION_INPUT["spls_kappa"]
    else:
        sv = torch.linalg.svdvals(torch.linalg.qr(As64, mode="r")[1])
        kappa = float(sv[0] / sv[-1])
    scfg = SPLSConfig(pcg=PCGSaddleConfig(tol=SPLS_TOL,
                                          max_iters=SPLS_ITERS))

    def spls_quality(out):
        q = ls_quality(As64, fro2, bs, out[0], xt)
        return dict(rel=q["rel"], ne=q["ne"], iters=int(out[2]),
                    finite=_finite(out[0]))

    def spls_control(run, p):
        x, hist, iters, st2 = run(p)
        return "x halved", spls_quality((x / 2, hist, iters, st2))

    cases["spls"] = dict(
        setup_s=_setup_seconds(t0, dev),
        what=f"spls {sm}x{sn} f32 decay 7, lsqr (default), tol "
        f"{SPLS_TOL:g}",
        run=lambda p: spls(As, bs, 0.0, scfg, RNGState(4), p),
        quality=spls_quality, control=spls_control,
        expected=lambda _: NO_LAUNCHES,
        gates={"highest": dict(rel=(1 + 2 * kappa) * EPS32)})
    return cases


def precision_refusals(name: str, p: str, q: dict,
                       measured: dict | None = None) -> list:
    """The gates of ``PRECISION_GATES[name][p]`` (with the bounds the
    case computes from its input, ``measured``, in place of None) that the
    readings ``q`` fail: every reading the table names at most its bound,
    ``fail`` and non-finite output refused where the table does not
    allow them."""
    gates = {**PRECISION_GATES[name][p], **(measured or {}).get(p, {})}
    bad = [] if q.get("finite", True) else ["non-finite"]
    if q.get("fail") and not gates.get("fail_allowed"):
        bad.append("fail")
    for key, bound in gates.items():
        if key == "fail_allowed":
            continue
        lo, hi = bound if isinstance(bound, tuple) else (None, bound)
        v = q[key]
        if not ((lo is None or v >= lo) and v <= hi):
            bad.append(f"{key} {v:.4g} outside {bound}")
    return bad


def _fmt(q: dict) -> str:
    return ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in q.items())


def phase_precision(dev, card: str) -> dict:
    """Every driver of the slice at full width in "high" and "default"
    beside "highest" (``precision=``; the kernels keep their fp32 forms,
    as the Pallas kernels do): best of 3 each in turns by CUDA events,
    card-busy ms of one profiled call, the readings against
    ``PRECISION_GATES`` (PERF.md §2, from tools/precision_residuals.py),
    the launch counts of each run ("highest"'s in every precision), and
    the TF32 switches unchanged after every call. Then
    [precision-controls]: one wrong answer a driver's gate must refuse.
    Returns BQRRP's launch counts by precision."""
    t0 = time.perf_counter()
    cases = precision_cases(dev)
    print(f"[precision] inputs {time.perf_counter() - t0:.1f} s", flush=True)
    tf32_before = (torch.backends.cuda.matmul.allow_tf32,
                   torch.get_float32_matmul_precision())
    counts_by = {}
    for name, case in cases.items():
        t0 = time.perf_counter()
        run = case["run"]
        times = {p: [] for p in PRECISIONS}
        for p in ("highest", "high", "default", "default", "high",
                  "highest", "highest", "high", "default"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            run(p)
            end.record()
            torch.cuda.synchronize()
            times[p].append(start.elapsed_time(end) / 1e3)
        for p in PRECISIONS:
            torch.cuda.synchronize()
            reset_counts()
            out = run(p)
            torch.cuda.synchronize()
            counts = read_counts()
            busy = (busy_share(lambda: run(p)) if name in HOST_PACED
                    else None)
            q = case["quality"](out)
            expected = case["expected"](out)
            gate(counts == expected, f"precision {name} {p}: launches "
                 f"{ {c: v for c, v in counts.items() if v} } != "
                 f"{ {c: v for c, v in expected.items() if v} }")
            gate((torch.backends.cuda.matmul.allow_tf32,
                  torch.get_float32_matmul_precision()) == tf32_before,
                 f"precision {name} {p}: a TF32 switch changed")
            gates = {**PRECISION_GATES[name][p],
                     **case.get("gates", {}).get(p, {})}
            refused = precision_refusals(name, p, q, case.get("gates"))
            print(f"[precision] {case['what']}, precision={p} on {card}: "
                  f"best of 3 {min(times[p]):.4f} s (runs "
                  f"{[round(x, 4) for x in times[p]]}; highest "
                  f"{min(times['highest']):.4f} s, x"
                  f"{min(times['highest']) / min(times[p]):.3f}); "
                  + (f"card busy {busy[0]:.2f} ms, idle {100 * busy[1]:.1f} "
                     "%" if busy else "card busy not profiled (not "
                     "host-paced)") + f"; {_fmt(q)}; gates "
                  f"{gates}; launches "
                  f"{ {c: v for c, v in counts.items() if v} or 'none'}",
                  flush=True)
            gate(not refused, f"precision {name} {p}: {refused}")
            if name == "bqrrp":
                counts_by[p] = counts
        print(f"[precision] {name}: {case['setup_s']:.1f} s for its input, "
              f"{time.perf_counter() - t0:.1f} s for its runs, readings and "
              "profiles", flush=True)
    for name, case in cases.items():
        p = CONTROL_PRECISION[name]
        what, q = case["control"](case["run"], p)
        refused = precision_refusals(name, p, q, case.get("gates"))
        print(f"[precision-controls] {name} {p}, {what}: {_fmt(q)}: refused "
              f"by {refused or 'nothing'}", flush=True)
        gate(bool(refused), f"precision control not refused: {name}, {what}")
    SPEED_INPUT.clear()
    return counts_by


# -- the distributed layer (randlapack_tpu_torch.parallel) --------------------

# dist_bqrrp_factored at the headline's 8192² f32 on PAR_P gloo ranks of one
# card, each holding 2048 rows; block 256, two stages, update defer 1 (the
# JAX function's config): 32 blocks, one K1, K2 and K3 launch each a rank
PAR_P = 4
PAR_B, PAR_STAGES = 256, 2
DIST_LAUNCHES = {**NO_LAUNCHES, "masked_vt_a": 32, "a_minus_vz_masked": 32,
                 "getrfnp": 32}
# the other entries' sizes: the tall orthogonalization and sketch entries
# on 131072×256 (a sketch of d = 1.25·256 rows, a rangefinder of 64
# columns), CQRRPT/CQRRT at config 3, RSVD at config 1, SPLS at config 2,
# REVD2 of the n 8192 kernel matrix at rank 256, KRILL at n 16384, k 256
PAR_TALL_M, PAR_TALL_N, PAR_TALL_D, PAR_TALL_K = 131072, 256, 320, 64
PAR_REVD2_N, PAR_REVD2_K = 8192, 256
PAR_KRILL_N, PAR_KRILL_K, PAR_KRILL_ITERS = 16384, 256, 100
PAR_REPS = 3
# the row-sharded modes of the single-device QR drivers at full width, on
# the headline's 8192² f32 matrix and state: the explicit BQRRP (b 256, two
# stages, update defer 1 as the JAX function forces) in "highest" (no
# kernel) and in "high" (K2·TF32 once a block), HQRRP at b 128 with
# Householder panels (K5 and K6 once a block) and, on smooth_matrix, with
# CholQR panels (K5 and K3 once a block); ABRIK at BASELINE config 5 (CQRRT
# on the shards, no kernel). Each rank launches these counts
PAR_HQ_B = 128
DIST_QR_LAUNCHES = {
    "dist_bqrrp": NO_LAUNCHES,
    "dist_bqrrp high": {**NO_LAUNCHES, "a_minus_vz_masked_tf32": 32},
    "dist_hqrrp": {**NO_LAUNCHES, "qrcp_select_pivots": 64,
                   "qrcp_panel": 64},
    "dist_hqrrp cholqr": {**NO_LAUNCHES, "qrcp_select_pivots": 64,
                          "getrfnp": 64},
    "dist_abrik": NO_LAUNCHES}


def _sha(t) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _psum_f64(mesh, *vals):
    """Sums over the ranks (in f64) of the given 0-d tensors."""
    return mesh.psum(torch.stack([v.double() for v in vals])).tolist()


def _gathered_orth(mesh, Q):
    """‖QᵀQ − I‖_F of a row-sharded Q, the Gram psummed in f64."""
    Qd = Q.double()
    G = mesh.psum(Qd.T @ Qd)
    return float(torch.linalg.norm(G - torch.eye(G.shape[0], dtype=G.dtype,
                                                 device=G.device)))


def _tall_input(mesh, make):
    """Every rank builds the whole input (one seed) and keeps its rows."""
    full = make()
    r0, r1 = mesh.rows(full.shape[0] // mesh.size)
    return full, full[r0:r1].contiguous()


def par_tsqr(mesh, dev):
    """dist_gram, dist_cholqr (1 and 2 passes), dist_shifted_cholqr3,
    dist_sketch_left and dist_rangefinder_step on a 131072×256 Gaussian
    matrix: G against the f64 product (at most 4× torch.mm's fp32 error),
    Q's residual and orthogonality (RES_GATE, RES_GATE·√k), S·A likewise,
    the rangefinder's capture within 3× the optimal rank-64 tail (the JAX
    test's gate). The single-process port functions on the whole input:
    gram_syrk, cholqr, cholqr2, shifted_cholqr3, the sketch's product, and
    (no single-device rangefinder step exists in either package) cholqr2
    of A·Ω with QᵀA."""
    from randlapack_tpu_torch.ops.cholqr import (cholqr, cholqr2, gram_syrk,
                                                 shifted_cholqr3)
    from randlapack_tpu_torch.ops.kernels import gaussian_sketch_matrix
    from randlapack_tpu_torch.parallel import (dist_cholqr, dist_gram,
                                               dist_rangefinder_step,
                                               dist_shifted_cholqr3,
                                               dist_sketch_left)
    g = torch.Generator(device=dev).manual_seed(21)
    A, Al = _tall_input(mesh, lambda: torch.randn(
        (PAR_TALL_M, PAR_TALL_N), generator=g, device=dev))
    ml = Al.shape[0]
    S = gaussian_sketch_matrix(PAR_TALL_D, ml, 22, device=dev,
                               col0=mesh.rank * ml)
    Om = torch.randn((PAR_TALL_N, PAR_TALL_K), generator=g, device=dev)
    runs = {"dist_gram": lambda: dist_gram(Al, mesh),
            "dist_cholqr passes=1": lambda: dist_cholqr(Al, mesh, passes=1),
            "dist_cholqr passes=2": lambda: dist_cholqr(Al, mesh),
            "dist_shifted_cholqr3": lambda: dist_shifted_cholqr3(Al, mesh),
            "dist_sketch_left": lambda: dist_sketch_left(S, Al, mesh),
            "dist_rangefinder_step": lambda: dist_rangefinder_step(
                Al, Om, mesh)}

    def rangefinder():
        Q, _, fail = cholqr2(A @ Om)
        B = Q.T @ A
        return Q, B, B.T, fail
    Sf = gaussian_sketch_matrix(PAR_TALL_D, PAR_TALL_M, 22, device=dev)
    singles = {"dist_gram": ("gram_syrk", lambda: gram_syrk(A)),
               "dist_cholqr passes=1": ("cholqr", lambda: cholqr(A)),
               "dist_cholqr passes=2": ("cholqr2", lambda: cholqr2(A)),
               "dist_shifted_cholqr3": ("shifted_cholqr3",
                                        lambda: shifted_cholqr3(A)),
               "dist_sketch_left": ("S @ A", lambda: Sf @ A),
               "dist_rangefinder_step": ("cholqr2(A @ Om), Q.T @ A",
                                         rangefinder)}
    A64 = A.double()
    k_gate = RES_GATE * math.sqrt(PAR_TALL_N)

    def check(name, out):
        if name == "dist_gram":
            G64 = A64.T @ A64
            err, lib = relf(out, G64), relf(A.T @ A, G64)
            return dict(err=err, gate=F64_ERR_FACTOR * lib, G=_sha(out)), \
                err <= F64_ERR_FACTOR * lib
        if name == "dist_sketch_left":
            ref = Sf.double() @ A64
            err, lib = relf(out, ref), relf(Sf @ A, ref)
            return dict(err=err, gate=F64_ERR_FACTOR * lib, SA=_sha(out)), \
                err <= F64_ERR_FACTOR * lib
        if name == "dist_rangefinder_step":
            Q, B, _, fail = out
            E = Al.double() - Q.double() @ B.double()
            e2, a2 = _psum_f64(mesh, (E * E).sum(), (Al.double() ** 2).sum())
            sig = torch.linalg.svdvals(A64)
            tail = float(torch.linalg.norm(sig[PAR_TALL_K:])
                         / torch.linalg.norm(sig))
            res = math.sqrt(e2 / a2)
            orth = _gathered_orth(mesh, Q)
            gk = RES_GATE * math.sqrt(PAR_TALL_K)
            return dict(capture=res, tail=tail, orth=orth, fail=bool(fail),
                        B=_sha(B)), \
                res <= 3 * tail and orth <= gk and not bool(fail)
        Q, R, fail = out
        E = Q.double() @ R.double() - Al.double()
        e2, a2 = _psum_f64(mesh, (E * E).sum(), (Al.double() ** 2).sum())
        res, orth = math.sqrt(e2 / a2), _gathered_orth(mesh, Q)
        return dict(res=res, orth=orth, fail=bool(fail), R=_sha(R)), \
            res <= RES_GATE and orth <= k_gate and not bool(fail)
    return runs, singles, check


def par_tall_qr(mesh, dev):
    """dist_cqrrpt and dist_cqrrt at config 3 (131072×2048 f32,
    fast_decay_matrix decay 9 from RNGState(2), as [cqrrpt] builds it; the
    Gaussian sketch of each rank's columns): the gates of
    tests/test_qr_drivers.py at f32 and the rank k, as tall_gates. The
    single-process port drivers on the whole input: cqrrpt and cqrrt with
    a Gaussian sketch of the same d = 1.25·n (cqrrpt's QRCP geqp3, as
    here)."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import (CQRRPTConfig, CQRRTConfig,
                                              cqrrpt, cqrrt)
    from randlapack_tpu_torch.drivers.cqrrt import SketchKind
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.parallel import dist_cqrrpt, dist_cqrrt
    A, Al = _tall_input(mesh, lambda: fast_decay_matrix(
        TALL_M, TALL_N, RNGState(2), decay=9.0, device=dev)[0])
    runs = {"dist_cqrrpt": lambda: dist_cqrrpt(Al, mesh, RNGState(8)),
            "dist_cqrrt": lambda: dist_cqrrt(Al, mesh, RNGState(8))}
    singles = {"dist_cqrrpt": ("cqrrpt", lambda: cqrrpt(
        A, CQRRPTConfig(sketch="gaussian"), RNGState(8))),
        "dist_cqrrt": ("cqrrt", lambda: cqrrt(
            A, CQRRTConfig(sketch=SketchKind.gaussian), RNGState(8)))}

    def check(name, out):
        if name == "dist_cqrrpt":
            Q, R, J, rank, fail, _ = out
            k = int(rank)
            perm = torch.equal(torch.sort(J).values,
                               torch.arange(TALL_N, device=dev))
        else:
            Q, R, fail, _ = out
            J, k, perm = torch.arange(TALL_N, device=dev), TALL_N, True
        Qk, Rk = Q[:, :k].double(), R[:k].double()
        AJ = Al.index_select(1, J).double()
        E = Qk @ Rk - AJ
        e2, a2 = _psum_f64(mesh, (E * E).sum(), (AJ * AJ).sum())
        res, orth = math.sqrt(e2 / a2), _gathered_orth(mesh, Q[:, :k])
        ok = (res <= RES_GATE and orth <= RES_GATE * math.sqrt(k)
              and not bool(fail) and perm)
        return dict(res=res, orth=orth, rank=k, fail=bool(fail),
                    R=_sha(R), J=_sha(J)), ok
    return runs, singles, check


def par_rsvd(mesh, dev, tail):
    """dist_rsvd at config 1 (4096² f32, decay 80, rank 256; two
    rangefinder cycles, the JAX function's default): ‖A − U·S·Vt‖_F/‖A‖_F
    within RSVD_TAIL_FACTOR of the optimal tail ([rsvd]'s), U and Vt
    orthonormal to RSVD_ORTH_GATE, S descending, fail False. The
    single-process port driver: rsvd_fixed_rank with [rsvd]'s QB block
    (it has no failure flag: read as False)."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import QBConfig
    from randlapack_tpu_torch.drivers import RSVDConfig, rsvd_fixed_rank
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.parallel import dist_rsvd
    A, Al = _tall_input(mesh, lambda: fast_decay_matrix(
        RSVD_N, RSVD_N, RNGState(1), decay=80.0, device=dev)[0])
    del A
    runs = {"dist_rsvd": lambda: dist_rsvd(Al, RSVD_K, mesh, RNGState(9))}

    def single():
        U, S, Vt, _, st = rsvd_fixed_rank(
            Al, RSVD_K, RSVDConfig(QBConfig(block_size=RSVD_B)),
            RNGState(9))
        return U, S, Vt, torch.zeros((), dtype=torch.bool), st
    singles = {"dist_rsvd": ("rsvd_fixed_rank", single)}

    def check(name, out):
        U, S, Vt, fail, _ = out
        E = Al.double() - (U.double() * S.double()) @ Vt.double()
        e2, a2 = _psum_f64(mesh, (E * E).sum(), (Al.double() ** 2).sum())
        ratio = math.sqrt(e2 / a2) / tail
        orth_u = _gathered_orth(mesh, U)
        Vd = Vt.double()
        orth_v = float(torch.linalg.norm(Vd @ Vd.T - torch.eye(
            RSVD_K, dtype=Vd.dtype, device=dev)))
        ok = (ratio <= RSVD_TAIL_FACTOR and max(orth_u, orth_v)
              <= RSVD_ORTH_GATE and bool((S[:-1] >= S[1:]).all())
              and not bool(fail))
        return dict(tail_ratio=ratio, orth_u=orth_u, orth_v=orth_v,
                    fail=bool(fail), S=_sha(S)), ok
    return runs, singles, check


def par_spls(mesh, dev, kappa):
    """dist_spls at config 2 (100000×2000 f32, decay 7, b = A·x_t, μ 0;
    PCG tol 1e-6, at most 60 iterations; the Gaussian sketch of each
    rank's columns, d = 4n = 8000): [spls]'s f32 gates, the
    normal-equations residual ≤ √n·eps32 and ‖Ax−b‖/‖b‖ ≤ (1+2κ)·eps32,
    κ from [spls]'s f64 R of A, in f64 with the sums psummed. The
    single-process port driver: spls with [spls]'s config (LSQR on a SASO
    sketch)."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps.determiter import PCGSaddleConfig
    from randlapack_tpu_torch.drivers import SPLSConfig, spls
    from randlapack_tpu_torch.parallel import dist_spls
    A, xt, _ = spls_problem(dev)
    r0, r1 = mesh.rows(SPLS_M // mesh.size)
    bl = (A[r0:r1] @ xt).contiguous()
    Al = A[r0:r1].contiguous()
    del A
    runs = {"dist_spls": lambda: dist_spls(
        Al, bl, 0.0, mesh, RNGState(4), tol=SPLS_TOL, max_iters=SPLS_ITERS)}
    singles = {"dist_spls": ("spls", lambda: spls(
        Al, bl, 0.0, SPLSConfig(pcg=PCGSaddleConfig(
            tol=SPLS_TOL, max_iters=SPLS_ITERS)), RNGState(4)))}

    def check(name, out):
        x, _, iters, _ = out
        A64, x64, b64 = Al.double(), x.double(), bl.double()
        r = b64 - A64 @ x64
        ne = mesh.psum(A64.T @ r)
        r2, b2, f2 = _psum_f64(mesh, (r * r).sum(), (b64 * b64).sum(),
                               (A64 * A64).sum())
        rel = math.sqrt(r2 / b2)
        ne_rel = float(torch.linalg.norm(ne) / (f2 * torch.linalg.norm(x64)))
        ok = (ne_rel <= math.sqrt(SPLS_N) * EPS32
              and rel <= (1 + 2 * kappa) * EPS32 and iters < SPLS_ITERS
              and bool(torch.isfinite(x).all()))
        return dict(rel=rel, ne=ne_rel, iters=iters, x=_sha(x)), ok
    return runs, singles, check


def par_revd2(mesh, dev):
    """dist_revd2 at rank 256 of the 8192² PSD matrix A = B·Bᵀ, B an
    8192×512 Gaussian matrix with columns scaled by e^(−j/128) (λ falls
    by e⁻⁴ over the first 256: the power iterations' CholQR2 holds in
    f32, where a squared-exponential kernel matrix's spectrum falls past
    1/√eps32 within rank 256 and breaks it in either package): fail
    False, ‖VᵀV − I‖_F ≤ 10·eps32^0.75·√k, λ ≥ 0 descending, the top-8
    eigenpair residuals ‖Avᵢ − λᵢvᵢ‖/λ₁ ≤ 1e-3 ([revd2]'s gates). The
    single-process port driver: revd2_fixed_rank (SYRF's LU-stabilized
    power passes)."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import REVD2Config, revd2_fixed_rank
    from randlapack_tpu_torch.parallel import dist_revd2
    g = torch.Generator(device=dev).manual_seed(23)
    B = torch.randn((PAR_REVD2_N, 2 * PAR_REVD2_K), generator=g,
                    device=dev) * torch.exp(-torch.arange(
                        2 * PAR_REVD2_K, device=dev) / 128.0)
    r0, r1 = mesh.rows(PAR_REVD2_N // mesh.size)
    Al = (B[r0:r1] @ B.T).contiguous()
    del B
    runs = {"dist_revd2": lambda: dist_revd2(Al, PAR_REVD2_K, mesh,
                                             RNGState(10))}
    singles = {"dist_revd2": ("revd2_fixed_rank", lambda: revd2_fixed_rank(
        Al, PAR_REVD2_K, REVD2Config(), RNGState(10)))}

    def check(name, out):
        V, lam, err, nu, fail, _ = out
        V8 = mesh.gather_rows(V[:, :8].contiguous()).double()
        KV = Al.double() @ V8
        E = KV - V[:, :8].double() * lam[:8].double()
        pairs = torch.sqrt(mesh.psum((E * E).sum(0))) / float(lam[0])
        orth = _gathered_orth(mesh, V)
        ok = (not bool(fail) and orth <= RES_GATE * math.sqrt(PAR_REVD2_K)
              and bool((lam >= 0).all() and (lam[:-1] >= lam[1:]).all())
              and float(pairs.max()) <= 1e-3
              and bool(torch.isfinite(err)))
        return dict(orth=orth, pair_res=float(pairs.max()),
                    lam0=float(lam[0]), err=float(err), nu=float(nu),
                    fail=bool(fail), lam=_sha(lam)), ok
    return runs, singles, check


def par_krill(mesh, dev):
    """dist_krill at n 16384, k 256, μ 1e-2, tol 1e-5 (bench.py's recipe,
    the sharded plain-PyTorch K(X_local, X)·V, 4096×16384 a rank at p 4):
    iterations below the cap, PCG's recursive residual ≤ 1e-5 and the
    backward error ≤ 1 eps32 (krill_run's gates; ‖K‖₂ ≥ ‖K·e‖/‖e‖). The
    single-process port driver: krill_full_rpchol on the unsharded
    operator (its products through K4)."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps.determiter import PCGConfig
    from randlapack_tpu_torch.drivers import KrillConfig, krill_full_rpchol
    from randlapack_tpu_torch.parallel import (DistSquaredExpKernelLinOp,
                                               dist_krill)
    G, H = krill_problem(PAR_KRILL_N, 1, 1e-2, dev)
    runs = {"dist_krill": lambda: dist_krill(
        G.X, G.bandwidth, 1e-2, H, mesh, RNGState(6), k=PAR_KRILL_K,
        tol=1e-5, max_iters=PAR_KRILL_ITERS)}
    kcfg = KrillConfig(k=PAR_KRILL_K, rpchol_block=64, pcg=PCGConfig(
        tol=1e-5, max_iters=PAR_KRILL_ITERS))
    singles = {"dist_krill": ("krill_full_rpchol", lambda: krill_full_rpchol(
        G, H, 1e-2, kcfg, RNGState(6)))}

    def check(name, out):
        Xs, hist, iters, _ = out
        Gd = DistSquaredExpKernelLinOp(G.X, G.bandwidth, 1e-2, mesh)
        res = float(torch.linalg.norm(Gd.matmat(Xs) - H))
        ones = torch.ones((PAR_KRILL_N, 1), device=dev)
        nrm_K = float(torch.linalg.norm(Gd.with_reg(False).matmat(ones))
                      / math.sqrt(PAR_KRILL_N))
        backward = res / ((nrm_K + 1e-2) * float(torch.linalg.norm(Xs))) \
            / EPS32
        final = float(hist[iters, 0] / hist[0, 0])
        ok = (iters < PAR_KRILL_ITERS and final <= 1e-5 and backward <= 1.0
              and bool(torch.isfinite(Xs).all()))
        return dict(iters=iters, recursive=final, backward=backward,
                    x=_sha(Xs)), ok
    return runs, singles, check


def par_entries(mesh, dev, tail, kappa):
    """Every entry but the flagship: (name, run, single, check) in order,
    ``single`` the single-process port function's (name, run) on the same
    whole input (for a mesh of one rank)."""
    for build in (par_tsqr, par_tall_qr, lambda m, d: par_rsvd(m, d, tail),
                  lambda m, d: par_spls(m, d, kappa), par_revd2, par_krill):
        runs, singles, check = build(mesh, dev)
        for name, fn in runs.items():
            yield name, fn, singles[name], check
        del runs, singles, check
        torch.cuda.empty_cache()


def par_time(mesh, fn, warm: bool = True):
    """``fn()`` PAR_REPS times after a warm-up (none without ``warm``),
    wall seconds around a synchronize (the ranks start each run together:
    a barrier of one psum), the launch counts of the last run, then one
    more run with the collectives timed: its wall and the collectives'
    share of it."""
    from randlapack_tpu_torch.parallel.mesh import collective_timer
    barrier = torch.zeros(1, device=mesh.device)
    if warm:
        fn()
    times, counts, out = [], None, None
    for _ in range(PAR_REPS):
        mesh.psum(barrier)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = read_counts()
    share, calls = 0.0, 0            # one rank: every collective is the
    if mesh.size > 1:                # identity
        mesh.psum(barrier)
        torch.cuda.synchronize()
        with collective_timer() as st:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        share, calls = st["seconds"] / wall, st["calls"]
    return out, times, counts, share, calls


def par_flagship(mesh, dev):
    """dist_bqrrp_factored at 8192² f32 (the headline's matrix and
    state), block 256, two stages; bqrrp_q on the sharded factors; the
    gates (residual, orthogonality, fail, J a permutation), this rank's
    launches, R and J (replicated) by digest, and on rank 0 the
    trailing norms of R over the leading half."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import bqrrp_q
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.parallel import dist_bqrrp_factored
    A, st = fast_decay_matrix(N, N, RNGState(0), device=dev)
    r0, r1 = mesh.rows(N // mesh.size)
    Al = A[r0:r1].contiguous()
    del A
    fac, times, counts, share, calls = par_time(
        mesh, lambda: dist_bqrrp_factored(Al, mesh, st, block_size=PAR_B,
                                          stages=PAR_STAGES)[0])
    Q = bqrrp_q(fac, mesh=mesh)
    E = Q @ fac.R - Al.index_select(1, fac.J)
    e2, a2 = _psum_f64(mesh, (E * E).sum(), (Al * Al).sum())
    del E
    G = mesh.psum(Q.T @ Q)
    orth = float(torch.linalg.norm(G - torch.eye(N, device=dev)))
    del G, Q
    perm = torch.equal(torch.sort(fac.J).values, torch.arange(N, device=dev))
    out = dict(times=times, counts=counts, share=share, calls=calls,
               res=math.sqrt(e2 / a2), orth=orth, fail=bool(fac.fail),
               perm=perm, R=_sha(fac.R), J=_sha(fac.J),
               finite=bool(torch.isfinite(fac.R).all()))
    if mesh.rank == 0:
        out["tn"] = trailing_norms(fac.R)[:N // 2].cpu()
        out["J_host"] = fac.J.cpu()
    return out


def smooth_matrix(dev):
    """The 8192² f32 matrix Q₁·diag(e^(−6i/n))·Q₂ᵀ (Q₁, Q₂ the Q factors
    of two Gaussian matrices, seed 24) and RNGState(0): fast_decay_matrix's
    spectrum without the cliff its square Gaussian factor puts at the
    tail. The headline's matrix ends in a trailing block of condition
    5e3–1.5e5 (512² in f64), past 1/√eps32, where f32 CholQR2 panels may
    break down in either package (tests/test_torch_hqrrp.py::
    test_f32_cholqr_panels_break_on_an_ill_conditioned_last_block)."""
    from randlapack_tpu_torch import RNGState
    g = torch.Generator(device=dev).manual_seed(24)
    Q1 = torch.linalg.qr(torch.randn((N, N), generator=g, device=dev))[0]
    Q2 = torch.linalg.qr(torch.randn((N, N), generator=g, device=dev))[0]
    s = torch.exp(-6.0 * torch.arange(N, device=dev) / N)
    return (Q1 * s[None, :]) @ Q2.T, RNGState(0)


def _qr_cfgs():
    """The row-sharded QR entries: (driver, config, smooth) by entry, the
    config without ``shard_axis``, ``smooth`` whether the input is
    smooth_matrix rather than the headline's matrix."""
    from randlapack_tpu_torch.drivers import (BQRRPConfig, HQRRPConfig,
                                              PanelQR)
    bq = dict(block_size=PAR_B, stages=PAR_STAGES, update_defer=1)
    return {"dist_bqrrp": ("bqrrp", BQRRPConfig(**bq), False),
            "dist_bqrrp high": ("bqrrp", BQRRPConfig(
                **bq, trailing_precision="high"), False),
            "dist_hqrrp": ("hqrrp", HQRRPConfig(block_size=PAR_HQ_B), False),
            "dist_hqrrp cholqr": ("hqrrp", HQRRPConfig(
                block_size=PAR_HQ_B, panel_qr=PanelQR.cholqr), True)}


def _qr_call(driver, cfg, A, st, mesh=None):
    """One call of ``driver`` with ``cfg`` (in its row-sharded mode under
    ``mesh``): (Q, R, J, fail)."""
    import dataclasses
    from randlapack_tpu_torch import drivers
    from randlapack_tpu_torch.parallel import set_mesh
    fn = getattr(drivers, driver)
    if mesh is None:
        Q, R, J, _, fail, _ = fn(A, cfg, st)
        return Q, R, J, fail
    with set_mesh(mesh):
        Q, R, J, _, fail, _ = fn(
            A, dataclasses.replace(cfg, shard_axis=mesh.axis), st)
    return Q, R, J, fail


def _qr_metrics(mesh, Al, Q, R, J, fail) -> dict:
    """Residual and orthogonality of a row-sharded factorization (the sums
    and the Gram psummed, as the flagship's), fail, J a permutation, R
    finite, R and J by digest."""
    n = Al.shape[1]
    E = Q @ R - Al.index_select(1, J)
    e2, a2 = _psum_f64(mesh, (E * E).sum(), (Al * Al).sum())
    del E
    G = mesh.psum(Q.T @ Q)
    orth = float(torch.linalg.norm(G - torch.eye(n, device=Al.device)))
    del G
    perm = torch.equal(torch.sort(J).values,
                       torch.arange(n, device=Al.device))
    return dict(res=math.sqrt(e2 / a2), orth=orth, fail=bool(fail),
                perm=perm, finite=bool(torch.isfinite(R).all()),
                R=_sha(R), J=_sha(J))


def par_qr(mesh, dev) -> dict:
    """The row-sharded QR entries on this rank (DIST_QR_LAUNCHES): each
    through par_time (best of PAR_REPS, the collectives' share of one more
    run; no warm-up: the flagship has warmed the process, and a run takes
    seconds), its factorization's gates (_qr_metrics; for HQRRP also taus by
    digest, from hqrrp_lapack_format on the same call), and on rank 0 the
    trailing norms of R over the leading half and J. dist_abrik at config
    5: S, and the sharded abrik_factor's bases' orthogonality and Krylov
    relation ([abrik]'s gates) on the same draws."""
    import dataclasses
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import (ABRIKConfig, HQRRPConfig,
                                              abrik_factor,
                                              hqrrp_lapack_format)
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.parallel import dist_abrik, set_mesh
    r0, r1 = mesh.rows(N // mesh.size)
    inputs = {}
    for smooth in (False, True):
        A, st = (smooth_matrix(dev) if smooth
                 else fast_decay_matrix(N, N, RNGState(0), device=dev))
        inputs[smooth] = A[r0:r1].contiguous(), st
        del A
    out = {}
    for name, (driver, cfg, smooth) in _qr_cfgs().items():
        Al, st = inputs[smooth]
        res, times, counts, share, calls = par_time(
            mesh, lambda: _qr_call(driver, cfg, Al, st, mesh), warm=False)
        rec = dict(times=times, counts=counts, share=share, calls=calls,
                   **_qr_metrics(mesh, Al, *res))
        if isinstance(cfg, HQRRPConfig):
            with set_mesh(mesh):
                taus = hqrrp_lapack_format(Al, dataclasses.replace(
                    cfg, shard_axis=mesh.axis), st)[1]
            rec["taus"] = _sha(taus)
        if mesh.rank == 0:
            rec["tn"] = trailing_norms(res[1])[:N // 2].cpu()
            rec["J_host"] = res[2].cpu()
        out[name] = rec
        del res
        torch.cuda.empty_cache()
    del inputs
    A, ast, _ = abrik_problem(dev)
    r0, r1 = mesh.rows(ABRIK_M // mesh.size)
    Al = A[r0:r1].contiguous()
    del A
    (U, S, Vt, info, _), times, counts, share, calls = par_time(
        mesh, lambda: dist_abrik(Al, ABRIK_K, mesh, ast, block_size=ABRIK_B,
                                 max_iters=ABRIK_Q), warm=False)
    cfg = ABRIKConfig(block_size=ABRIK_B, max_iters=ABRIK_Q,
                      qr_explicit="cqrrt", shard_axis=mesh.axis)
    with set_mesh(mesh):
        Ub, Vb, B, _, iters, _ = abrik_factor(Al, ast, cfg)
    K = ABRIK_B * ABRIK_Q
    eye = torch.eye(K, dtype=torch.float64, device=dev)
    Ubd, Vbd = Ub.double(), Vb.double()
    orth_u = float(torch.linalg.norm(mesh.psum(Ubd.T @ Ubd) - eye))
    orth_v = float(torch.linalg.norm(Vbd.T @ Vbd - eye))
    E = Al.double() @ Vbd - Ubd @ B.double()
    e2, a2 = _psum_f64(mesh, (E * E).sum(), (Al.double() ** 2).sum())
    out["dist_abrik"] = dict(
        times=times, counts=counts, share=share, calls=calls,
        S=S.cpu(), S_sha=_sha(S), Vt=_sha(Vt),
        iters=(info["num_krylov_iters"], iters), orth_u=orth_u,
        orth_v=orth_v, kry=math.sqrt(e2 / a2),
        finite=bool(torch.isfinite(U).all() and torch.isfinite(S).all()
                    and torch.isfinite(Vt).all()))
    return out


def parallel_rank_body(mesh, tail, kappa):
    """One rank of [parallel]: the flagship, the row-sharded QR entries,
    then every other entry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    out = {"flagship": par_flagship(mesh, dev), "qr": par_qr(mesh, dev)}
    torch.cuda.empty_cache()
    for name, fn, _, check in par_entries(mesh, dev, tail, kappa):
        res, times, counts, share, calls = par_time(mesh, fn)
        metrics, ok = check(name, res)
        out[name] = dict(times=times, counts=counts, share=share,
                         calls=calls, metrics=metrics, ok=ok)
        del res
    return out


def nccl_rank_body(mesh):
    """One NCCL rank: the flagship call and dist_hqrrp (b 128; their R, J
    and HQRRP's Q by digest, and the launches of each) and dist_cholqr of
    the 131072×256 Gaussian matrix."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.parallel import dist_bqrrp_factored, dist_hqrrp
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    A, st = fast_decay_matrix(N, N, RNGState(0), device=dev)
    reset_counts()
    fac, _ = dist_bqrrp_factored(A, mesh, st, block_size=PAR_B,
                                 stages=PAR_STAGES)
    torch.cuda.synchronize()
    counts = read_counts()
    one = torch.ones(4, device=dev)
    torch.distributed.all_reduce(one)       # the group takes a CUDA tensor
    out = dict(backend=torch.distributed.get_backend(), R=_sha(fac.R),
               J=_sha(fac.J), counts=counts, all_reduce=one.tolist())
    del fac
    reset_counts()
    Q, R, J, _, _, _ = dist_hqrrp(A, mesh, st, block_size=PAR_HQ_B)
    torch.cuda.synchronize()
    out["hqrrp"] = dict(Q=_sha(Q), R=_sha(R), J=_sha(J),
                        counts=read_counts())
    del A, Q, R
    runs, _, check = par_tsqr(mesh, dev)
    out["cholqr"] = check("dist_cholqr passes=2",
                          runs["dist_cholqr passes=2"]())
    return out


def phase_parallel(dev, card: str) -> dict:
    """[parallel]: the distributed layer on one card. The kernels are
    built (phase_build) before any rank starts. PAR_P gloo ranks share the
    card in one spawn and run the flagship dist_bqrrp_factored (8192² f32,
    2048 rows a rank) and every other distributed entry at full size,
    best of 3, with the collectives' share of one more run; then each
    entry's single-process port function on the same whole input (par_*'s
    docstrings name it), best of 3, and the flagship's single-process
    counterpart bqrrp_factored(update_defer=1) on the same sketch: the
    trailing-norm
    ratios over the leading half within PIVOT_BAND, then one NCCL rank
    must reproduce it bit for bit. Gates (PERF.md §2, written before the
    first card run): the flagship's residual ≤ RES_GATE, orthogonality ≤
    ORTH_GATE, fail False, J a permutation, DIST_LAUNCHES on every rank,
    R and J the same bits on every rank; each entry's gates (its
    docstring) at p = PAR_P and on the single-process function;
    replicated outputs the same bits on every rank. K1 and K2 alone at
    the shard's shapes (V 2048×256, A 2048×8192 and stage 2's 2048×4096,
    k 256), each held against its plain version at 1e-4·max|plain|, then
    timed beside the plain version, torch.mm and their bounds.
    Returns the flagship's launches by rank."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import BQRRPConfig, bqrrp_factored
    from randlapack_tpu_torch.gen import fast_decay_matrix
    from randlapack_tpu_torch.ops import wy
    from randlapack_tpu_torch.parallel import make_mesh, run_ranks
    tail = PRECISION_INPUT["rsvd_tail"]
    kappa = PRECISION_INPUT["spls_kappa"]
    t0 = time.perf_counter()
    ranks = run_ranks(parallel_rank_body, PAR_P, tail, kappa,
                      backend="gloo", device="cuda", timeout=900)
    spawn_s = time.perf_counter() - t0
    fl = [r["flagship"] for r in ranks]
    f0 = fl[0]
    print(f"[parallel] dist_bqrrp_factored {N}x{N} f32 b{PAR_B}/stages"
          f"{PAR_STAGES}/defer1 on {PAR_P} gloo ranks of {card} ({N // PAR_P}"
          f" rows a rank; spawn and all entries {spawn_s:.1f} s): runs "
          f"{[round(t, 4) for t in f0['times']]} s, best "
          f"{min(f0['times']):.4f} s; collectives {100 * f0['share']:.1f} % "
          f"of a run ({f0['calls']} calls); residual {f0['res']:.3e} (gate "
          f"{RES_GATE:.2e}), orth {f0['orth']:.3e} (gate {ORTH_GATE:.2e}), "
          f"fail {f0['fail']}; launches a rank "
          f"{[{k: v for k, v in r['counts'].items() if v} for r in fl]}",
          flush=True)
    for r in fl:
        gate(r["counts"] == DIST_LAUNCHES,
             f"parallel: launches {r['counts']} != {DIST_LAUNCHES}")
        gate(r["R"] == f0["R"] and r["J"] == f0["J"],
             "parallel: R or J differ between ranks")
    gate(f0["res"] <= RES_GATE, f"parallel: residual {f0['res']}")
    gate(f0["orth"] <= ORTH_GATE, f"parallel: orthogonality {f0['orth']}")
    gate(not f0["fail"] and f0["perm"] and f0["finite"],
         "parallel: fail raised, J not a permutation or R not finite")

    # the single-process driver on the same matrix and sketch
    A, st = fast_decay_matrix(N, N, RNGState(0), device=dev)
    cfg = BQRRPConfig(block_size=PAR_B, stages=PAR_STAGES, update_defer=1)
    single = [None]

    def one():
        single[0] = bqrrp_factored(A, cfg, st)[0]
    bqrrp_factored(A, cfg, st)
    times1 = []
    for _ in range(PAR_REPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times1.append(time.perf_counter() - t1)
    fac1 = single[0]
    f0["R1"], f0["J1"] = _sha(fac1.R), _sha(fac1.J)
    ratio = trailing_norms(fac1.R)[:N // 2].cpu() / torch.as_tensor(f0["tn"])
    J4 = torch.as_tensor(f0["J_host"])
    differ = torch.nonzero(fac1.J.cpu() != J4)
    first = int(differ[0]) if len(differ) else N
    print(f"[parallel] the same on one process, bqrrp_factored(update_defer"
          f"=1): runs {[round(t, 4) for t in times1]} s, best "
          f"{min(times1):.4f} s ({min(f0['times']) / min(times1):.2f}x "
          f"faster than {PAR_P} ranks); J equal up to position {first} "
          f"of {N}; trailing-norm "
          f"ratios single/sharded over the leading half "
          f"[{float(ratio.min()):.4f}, {float(ratio.max()):.4f}] (band "
          f"{PIVOT_BAND})", flush=True)
    gate(PIVOT_BAND[0] <= float(ratio.min())
         and float(ratio.max()) <= PIVOT_BAND[1],
         f"parallel: trailing-norm ratios [{ratio.min()}, {ratio.max()}]")

    del fac1, single
    torch.cuda.empty_cache()
    mesh1 = make_mesh(device=dev)
    hq1 = par_qr_singles(ranks, mesh1, A, st, card)
    dist_counts = {name: {"dist_bqrrp_factored": [r["counts"][name]
                                                  for r in fl]}
                   for name in NO_LAUNCHES}
    for r in ranks:
        for entry, rec in r["qr"].items():
            for name, v in rec["counts"].items():
                dist_counts[name].setdefault(entry, []).append(v)

    # one NCCL rank reproduces the single-process calls bit for bit
    nccl, = run_ranks(nccl_rank_body, 1, backend="nccl", device="cuda",
                      timeout=600)
    bit = nccl["R"] == f0["R1"] and nccl["J"] == f0["J1"]
    nh = nccl["hqrrp"]
    bit_hq = (nh["Q"], nh["R"], nh["J"]) == hq1
    cq, ok = nccl["cholqr"]
    print(f"[parallel-nccl] one {nccl['backend']} rank: dist_bqrrp_factored "
          f"bit-equal to bqrrp_factored(update_defer=1) {bit} (launches "
          f"{ {k: v for k, v in nccl['counts'].items() if v} }); dist_hqrrp "
          f"b{PAR_HQ_B} bit-equal (Q, R, J) to hqrrp {bit_hq} (launches "
          f"{ {k: v for k, v in nh['counts'].items() if v} }); "
          f"dist_cholqr {PAR_TALL_M}x{PAR_TALL_N}: residual {cq['res']:.3e},"
          f" orth {cq['orth']:.3e}, fail {cq['fail']}", flush=True)
    gate(nccl["backend"] == "nccl" and nccl["all_reduce"] == [1.0] * 4,
         "parallel: the rank did not run NCCL")
    gate(bit, "parallel: one NCCL rank differs from the single process")
    gate(bit_hq, "parallel: one NCCL rank's dist_hqrrp differs from hqrrp")
    gate(nccl["counts"] == DIST_LAUNCHES,
         f"parallel-nccl: launches {nccl['counts']}")
    gate(nh["counts"] == DIST_QR_LAUNCHES["dist_hqrrp"],
         f"parallel-nccl: dist_hqrrp launches {nh['counts']}")
    gate(ok, f"parallel-nccl: dist_cholqr gates {cq}")
    del A
    torch.cuda.empty_cache()

    # every other entry: p ranks against the single-process port function
    # on the same whole input
    for name, _, (name1, fn1), check in par_entries(mesh1, dev, tail,
                                                    kappa):
        res, times, counts, _, _ = par_time(mesh1, fn1)
        m1, ok1 = check(name, res)
        del res
        rk = [r[name] for r in ranks]
        m4 = rk[0]["metrics"]
        shown = {k: v for k, v in m4.items() if not isinstance(v, str)}
        shown1 = {k: v for k, v in m1.items() if not isinstance(v, str)}
        print(f"[parallel] {name}: {PAR_P} ranks best "
              f"{min(rk[0]['times']):.4f} s (runs "
              f"{[round(t, 4) for t in rk[0]['times']]}), collectives "
              f"{100 * rk[0]['share']:.1f} % ({rk[0]['calls']} calls); "
              f"one process, {name1}, best {min(times):.4f} s; {PAR_P} "
              f"ranks {_fmt(shown)}; {name1} {_fmt(shown1)}", flush=True)
        for r in rk:
            gate(r["ok"], f"parallel {name}: gates at {PAR_P} ranks "
                 f"{r['metrics']}")
            gate(r["counts"] == NO_LAUNCHES,
                 f"parallel {name}: launches {r['counts']}")
            for k, v in r["metrics"].items():
                if isinstance(v, str):
                    gate(v == m4[k], f"parallel {name}: {k} differs "
                         "between ranks")
        gate(ok1, f"parallel {name}: gates of {name1} on one process {m1}")

    # K1 and K2 alone at the shard's shapes: V 2048×256 against the full
    # 8192-column window (stage 1) and stage 2's 4096-column window, each
    # held against its plain version before it is timed
    g = torch.Generator(device=dev).manual_seed(3)
    ml, b = N // PAR_P, PAR_B
    V = torch.randn((ml, b), generator=g, device=dev)
    for w in (N, N // PAR_STAGES):
        Ash = torch.randn((ml, w), generator=g, device=dev)
        Z = torch.randn((b, w), generator=g, device=dev)
        mask = (torch.rand(w, generator=g, device=dev) < 0.6).float()
        Wp = wy.masked_vt_a_reference(V, Ash, mask)
        k1_err = float((wy.masked_vt_a(V, Ash, mask) - Wp).abs().max())
        gate(k1_err <= 1e-4 * float(Wp.abs().max()),
             f"parallel: K1 at V {ml}x{b}, A {ml}x{w}, max|d| {k1_err}")
        Ap = wy.a_minus_vz_masked_reference(Ash, V, Z, mask)
        k2_err = float((wy.a_minus_vz_masked(Ash.clone(), V, Z, mask)
                        - Ap).abs().max())
        gate(k2_err <= 1e-4 * float(Ap.abs().max()),
             f"parallel: K2 at V {ml}x{b}, A {ml}x{w}, max|d| {k2_err}")
        k1 = cuda_ms(lambda: wy.masked_vt_a(V, Ash, mask), 20)
        k1_plain = cuda_ms(lambda: wy.masked_vt_a_reference(V, Ash, mask),
                           20)
        k1_mm = cuda_ms(lambda: torch.mm(V.T, Ash), 20)
        k1_b = bound(2.0 * ml * w * b + ml * w,
                     4.0 * (ml * b + ml * w + w + b * w), tensor=True)
        k2_plain = cuda_ms(
            lambda: wy.a_minus_vz_masked_reference(Ash, V, Z, mask), 20)
        A2 = Ash.clone()
        k2 = cuda_ms(lambda: wy.a_minus_vz_masked(A2, V, Z, mask), 20)
        k2_mm = cuda_ms(lambda: A2.addmm_(V, Z, alpha=-1), 20)
        k2_b = bound(2.0 * ml * w * b + 2 * ml * w,
                     4.0 * (2 * ml * w + ml * b + b * w + w), tensor=True)
        print(f"[parallel-kernels] the shard's shapes (V {ml}x{b}, A "
              f"{ml}x{w}, k {b}): masked_vt_a {k1:.4f} ms (plain "
              f"{k1_plain:.4f} ms, torch.mm(V.T, A) {k1_mm:.4f} ms, bound "
              f"{k1_b['bound_ms']:.4f} ms by {k1_b['bound_by']}, max|d| "
              f"{k1_err:.3e} of max|plain| {float(Wp.abs().max()):.3e}); "
              f"a_minus_vz_masked {k2:.4f} ms (plain {k2_plain:.4f} ms, "
              f"A.addmm_(V, Z, alpha=-1) {k2_mm:.4f} ms, bound "
              f"{k2_b['bound_ms']:.4f} ms by {k2_b['bound_by']}, max|d| "
              f"{k2_err:.3e} of max|plain| {float(Ap.abs().max()):.3e})",
              flush=True)
        del Ash, Z, A2, Wp, Ap
    par_kernels_tf32(dev)
    return {name: {e: c for e, c in entries.items() if any(c)}
            for name, entries in dist_counts.items()}


def par_qr_singles(ranks, mesh1, A, st, card: str):
    """[parallel]'s row-sharded QR entries: each rank's gates (launches,
    the factorization's gates, R, J and taus the same bits on every rank),
    then the single-process port function on the same whole input (A or
    smooth_matrix) and state, best of PAR_REPS, its own gates and the
    trailing-norm ratios single/sharded over the leading half within
    PIVOT_BAND; dist_abrik's
    [abrik] gates and its top σ within 1e-4·σ₀ of abrik(qr_explicit=
    "cqrrt") on the same draws. Returns the digests (Q, R, J) of the
    single-process hqrrp (b PAR_HQ_B) for the NCCL rank."""
    import dataclasses
    from randlapack_tpu_torch.drivers import abrik
    hq1 = None
    inputs = {False: (A, st), True: smooth_matrix(A.device)}
    for name, (driver, cfg, smooth) in _qr_cfgs().items():
        Ai, sti = inputs[smooth]
        rk = [r["qr"][name] for r in ranks]
        r0 = rk[0]
        res_gate = (MODE_RES_GATE["high"] if name.endswith("high")
                    else RES_GATE)
        for r in rk:
            gate(r["counts"] == DIST_QR_LAUNCHES[name],
                 f"parallel {name}: launches {r['counts']}")
            gate(all(r[k] == r0[k] for k in ("R", "J", "taus") if k in r),
                 f"parallel {name}: R, J or taus differ between ranks")
        gate(r0["res"] <= res_gate and r0["orth"] <= ORTH_GATE
             and not r0["fail"] and r0["perm"] and r0["finite"],
             f"parallel {name}: residual {r0['res']}, orth {r0['orth']}, "
             f"fail {r0['fail']}, J a permutation {r0['perm']}, R finite "
             f"{r0['finite']}")
        out, times, _, _, _ = par_time(mesh1,
                                       lambda: _qr_call(driver, cfg, Ai, sti))
        Q1, R1, J1, fail1 = out
        res1 = float(torch.linalg.norm(Q1 @ R1 - Ai.index_select(1, J1))
                     / torch.linalg.norm(Ai))
        orth1 = float(torch.linalg.norm(Q1.T @ Q1 - torch.eye(
            N, device=Ai.device)))
        ratio = trailing_norms(R1)[:N // 2].cpu() / torch.as_tensor(r0["tn"])
        differ = torch.nonzero(J1.cpu() != torch.as_tensor(r0["J_host"]))
        first = int(differ[0]) if len(differ) else N
        if name == "dist_hqrrp":
            hq1 = (_sha(Q1), _sha(R1), _sha(J1))
        del out, Q1, R1, J1
        torch.cuda.empty_cache()
        tp = getattr(cfg, "trailing_precision", "highest")
        print(f"[parallel] {name} {N}x{N} f32 ({driver}, {cfg.block_size}"
              f"-column blocks, trailing {tp}) on {PAR_P} gloo ranks of "
              f"{card}: best {min(r0['times']):.4f} s (runs "
              f"{[round(t, 4) for t in r0['times']]}), collectives "
              f"{100 * r0['share']:.1f} % ({r0['calls']} calls); residual "
              f"{r0['res']:.3e} (gate {res_gate:.2e}), orth {r0['orth']:.3e} "
              f"(gate {ORTH_GATE:.2e}), fail {r0['fail']}; launches a rank "
              f"{[{k: v for k, v in r['counts'].items() if v} for r in rk]};"
              f" one process, {driver} with the same config, best "
              f"{min(times):.4f} s (residual {res1:.3e}, orth {orth1:.3e}, "
              f"fail {bool(fail1)}); J equal up to position {first} of {N}; "
              f"trailing-norm ratios single/sharded over the leading half "
              f"[{float(ratio.min()):.4f}, {float(ratio.max()):.4f}] (band "
              f"{PIVOT_BAND})", flush=True)
        gate(res1 <= res_gate and orth1 <= ORTH_GATE and not bool(fail1),
             f"parallel {name}: gates of {driver} on one process")
        gate(PIVOT_BAND[0] <= float(ratio.min())
             and float(ratio.max()) <= PIVOT_BAND[1],
             f"parallel {name}: trailing-norm ratios [{ratio.min()}, "
             f"{ratio.max()}]")
    del inputs
    torch.cuda.empty_cache()
    Aa, ast, acfg = abrik_problem(A.device)
    acfg = dataclasses.replace(acfg, qr_explicit="cqrrt")
    (_, S1, _, info1, _), times, _, _, _ = par_time(
        mesh1, lambda: abrik(Aa, ABRIK_K, acfg, ast))
    del Aa
    rk = [r["qr"]["dist_abrik"] for r in ranks]
    r0 = rk[0]
    sgap = float((torch.as_tensor(r0["S"]).double() - S1.double().cpu())
                 .abs().max() / float(S1[0]))
    print(f"[parallel] dist_abrik {ABRIK_M}x{ABRIK_N} f32 (BASELINE config "
          f"5: k {ABRIK_K}, block {ABRIK_B}, {ABRIK_Q} iterations, cqrrt) on "
          f"{PAR_P} gloo ranks: best {min(r0['times']):.4f} s (runs "
          f"{[round(t, 4) for t in r0['times']]}), collectives "
          f"{100 * r0['share']:.1f} % ({r0['calls']} calls); the sharded "
          f"abrik_factor on the same draws: |Ub^T Ub - I|_F "
          f"{r0['orth_u']:.3e}, |Vb^T Vb - I|_F {r0['orth_v']:.3e} (gate "
          f"{ABRIK_ORTH_GATE:.3e}), |A Vb - Ub B|_F/|A|_F {r0['kry']:.3e} "
          f"(gate 1e-4), iterations {r0['iters']}; one process, abrik(qr_"
          f"explicit=\"cqrrt\"), best {min(times):.4f} s: top {ABRIK_K} "
          f"sigma max |ds|/s0 {sgap:.3e} (gate 1e-4); launches a rank "
          f"{[{k: v for k, v in r['counts'].items() if v} for r in rk]}",
          flush=True)
    for r in rk:
        gate(r["counts"] == DIST_QR_LAUNCHES["dist_abrik"],
             f"parallel dist_abrik: launches {r['counts']}")
        gate(r["S_sha"] == r0["S_sha"] and r["Vt"] == r0["Vt"],
             "parallel dist_abrik: S or Vt differ between ranks")
    gate(max(r0["orth_u"], r0["orth_v"]) <= ABRIK_ORTH_GATE
         and r0["kry"] <= 1e-4 and r0["finite"]
         and r0["iters"] == (ABRIK_Q, ABRIK_Q)
         and info1["num_krylov_iters"] == ABRIK_Q,
         f"parallel dist_abrik: gates {r0['orth_u']}, {r0['orth_v']}, "
         f"{r0['kry']}, iterations {r0['iters']}")
    gate(sgap <= 1e-4, f"parallel dist_abrik: sigma against one process "
         f"{sgap}")
    return hq1


def par_kernels_tf32(dev) -> None:
    """[parallel-kernels] K1·TF32 at the HQRRP shard's shapes (V 2048×128,
    A 2048×8192) and K2·TF32 at the BQRRP shard's (V 2048×256, Z 256×8192,
    A 2048×8192), the forms a trailing mode launches there: each held
    against its plain version at 1e-5·max|plain| ([wy-modes]' gate), then
    timed beside its plain version, its bound and the fp32 library call
    with TF32 allowed."""
    from randlapack_tpu_torch.ops import wy
    g = torch.Generator(device=dev).manual_seed(4)
    ml, w = N // PAR_P, N
    A = torch.randn((ml, w), generator=g, device=dev)
    mask = (torch.rand(w, generator=g, device=dev) < 0.6).float()
    b = PAR_HQ_B
    V = torch.randn((ml, b), generator=g, device=dev)
    Wp = wy.masked_vt_a_tf32_reference(V, A, mask)
    err = float((wy.masked_vt_a_form(V, A, mask, "tf32") - Wp).abs().max())
    scale = float(Wp.abs().max())
    gate(err <= 1e-5 * scale, f"parallel: K1·TF32 at V {ml}x{b}, A {ml}x{w}"
         f", max|d| {err}")
    ms = cuda_ms(lambda: wy.masked_vt_a_form(V, A, mask, "tf32"), 100)
    plain = cuda_ms(lambda: wy.masked_vt_a_tf32_reference(V, A, mask), 20)
    lib, _ = form_library_ms("tf32", lambda: torch.mm(V.T, A), 100)
    bd = form_bound(2 * ml * b * w, 4 * (ml * b + ml * w + w + b * w),
                    "tf32")
    print(f"[parallel-kernels] masked_vt_a tf32 at the HQRRP shard (V {ml}x"
          f"{b}, A {ml}x{w}): {ms:.4f} ms (plain {plain:.4f} ms, torch.mm(V.T"
          f", A) with TF32 allowed {lib:.4f} ms, bound {bd['bound_ms']:.4f} "
          f"ms by {bd['bound_by']}, max|d| {err:.3e} of max|plain| "
          f"{scale:.3e})", flush=True)
    b = PAR_B
    V = torch.randn((ml, b), generator=g, device=dev)
    Z = torch.randn((b, w), generator=g, device=dev)
    Ap = wy.a_minus_vz_masked_tf32_reference(A, V, Z, mask)
    err = float((wy.a_minus_vz_masked_form(A.clone(), V, Z, mask, "tf32")
                 - Ap).abs().max())
    scale = float(Ap.abs().max())
    gate(err <= 1e-5 * scale, f"parallel: K2·TF32 at V {ml}x{b}, A {ml}x{w}"
         f", max|d| {err}")
    A2 = A.clone()
    ms = cuda_ms(lambda: wy.a_minus_vz_masked_form(A2, V, Z, mask, "tf32"),
                 100)
    plain = cuda_ms(
        lambda: wy.a_minus_vz_masked_tf32_reference(A, V, Z, mask), 20)
    lib, _ = form_library_ms("tf32", lambda: A2.addmm_(V, Z, alpha=-1.0),
                             100)
    bd = form_bound(2 * ml * b * w + 2 * ml * w,
                    4 * (2 * ml * w + ml * b + b * w + w), "tf32")
    print(f"[parallel-kernels] a_minus_vz_masked tf32 at the BQRRP shard (V "
          f"{ml}x{b}, Z {b}x{w}, A {ml}x{w}): {ms:.4f} ms (plain {plain:.4f} "
          f"ms, A.addmm_(V, Z, alpha=-1) with TF32 allowed {lib:.4f} ms, "
          f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}, max|d| "
          f"{err:.3e} of max|plain| {scale:.3e})", flush=True)


# [edge]: the port's driver paths and kernels under tools/fuzz_sweep.py's
# mutators, at small shapes (1024² BQRRP at b 128 and HQRRP at b 64,
# 8192×256 CQRRPT with the sketch QRCP through HQRRP, KRILL and REVD2 over
# an n 4096 kernel operator, and 2 gloo ranks of dist_bqrrp_factored and
# dist_hqrrp), fixed seeds. A run that flags ``fail`` or misses its f32
# gate is run again on the CPU with the same draws: if the CPU run is
# sound, the card's is a kernel fault and the phase raises; if not, the
# line says "shared". Every kernel a run launched is held on that run's
# operands (its first launch) against its plain version, and each kernel
# and form alone on mutated operands (randlapack_tpu_torch.utils.
# kernel_checks, whose gates are those of phase_kernels above)
EDGE_N = 1024
EDGE_MUTATORS = ("colscale", "neardup", "zerotiny", "kahan", "2^60",
                 "2^-60", "1e25", "1e-25")


def edge_input(shape, how, seed):
    from randlapack_tpu_torch.utils import kernel_checks
    g = torch.Generator()
    g.manual_seed(seed)
    A = torch.randn(shape, generator=g) * torch.exp(
        -3 * torch.rand(shape[1], generator=g))[None, :]
    return kernel_checks.mutate(A, how, g)


def edge_paths():
    """name -> (input shape, run(A, dev) -> outputs, the f32 gates)."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.comps import PCGConfig
    from randlapack_tpu_torch.drivers import (BQRRPConfig, CQRRPTConfig,
                                              HQRRPConfig, KrillConfig,
                                              PanelQR, QRCPKind,
                                              REVD2Config, bqrrp_factored,
                                              bqrrp_q, cqrrpt, hqrrp,
                                              krill_full_rpchol,
                                              revd2_fixed_rank)
    from randlapack_tpu_torch.interop import saso_from_numpy, saso_to_numpy
    from randlapack_tpu_torch.pdkernels import SquaredExpKernelLinOp
    from randlapack_tpu_torch.sketching import SparseDist, fill_sparse
    g = torch.Generator()
    g.manual_seed(5)
    n = EDGE_N
    S_bq = torch.randn((160, n), generator=g) / 160 ** 0.5
    G_hq = torch.rand((74, n), generator=g) * 2 - 1
    saso, _ = fill_sparse(SparseDist(320, 8192, 2), RNGState(7),
                          device="cpu")
    G_cq = torch.rand((138, 320), generator=g) * 2 - 1
    kn = 1024                   # the kernel operator's n
    noise = -torch.log(-torch.log(torch.rand((4, kn), generator=g)))
    omega = torch.randn((kn, 64), generator=g)
    v0 = torch.randn((kn, 1), generator=g)
    H = torch.randn((kn, 1), generator=g)

    def qr_out(Q, R, J, fail, k=None):
        return dict(Q=Q, R=R, J=J, fail=bool(fail), k=k)

    def bq(tp):
        def run(A, dev):
            fac, _ = bqrrp_factored(A.to(dev), BQRRPConfig(
                block_size=128, trailing_precision=tp), RNGState(0),
                sketch=S_bq.to(dev))
            return qr_out(bqrrp_q(fac), fac.R, fac.J, fac.fail)
        return run

    def hq(panel, tp="highest"):
        def run(A, dev):
            Q, R, J, _, fail, _ = hqrrp(A.to(dev), HQRRPConfig(
                block_size=64, panel_qr=panel, trailing_precision=tp),
                RNGState(0), sketch=G_hq.to(dev))
            return qr_out(Q, R, J, fail)
        return run

    def cq(A, dev):
        f, rows, vals = saso_to_numpy(saso)
        Q, R, J, k, fail, _ = cqrrpt(
            A.to(dev), CQRRPTConfig(qrcp=QRCPKind.hqrrp, bqrrp_block=128),
            RNGState(0), sketch=saso_from_numpy(f, rows, vals, device=dev),
            qrcp_sketch=G_cq.to(dev))
        return qr_out(Q, R, J, fail, int(k))

    def kop(X, dev):
        return SquaredExpKernelLinOp(X.to(dev), 3.8, 1e-2, block=2048)

    def krill(X, dev):
        x, _, it, _ = krill_full_rpchol(
            kop(X, dev), H.to(dev), 1e-2, KrillConfig(
                k=64, rpchol_block=16, pcg=PCGConfig(tol=1e-5,
                                                      max_iters=200)),
            RNGState(0), noise=noise.to(dev))
        return dict(x=x, iters=it)

    def revd2(X, dev):
        V, lam, _, _, fail, _ = revd2_fixed_rank(
            kop(X, dev), 64, REVD2Config(), RNGState(0),
            omega=omega.to(dev), v0=v0.to(dev))
        return dict(V=V, lam=lam, fail=bool(fail))

    def qr_gates(tp):
        def gates(A, o):
            Q, R, J, k = o["Q"], o["R"], o["J"], o["k"]
            if k is not None:
                Q, R = Q[:, :k], R[:k]
            perm = torch.equal(torch.sort(J.cpu()).values,
                               torch.arange(A.shape[1]))
            if o["fail"]:
                return False, f"fail, J a permutation {perm}"
            if not bool(torch.isfinite(Q).all() and torch.isfinite(R).all()):
                return False, "non-finite output"
            res, orth = _f64_res_orth(A.to(Q.device), Q, R, J)
            ok = perm and res <= MODE_RES_GATE.get(tp, RES_GATE) and \
                orth <= 10 * EPS32 ** 0.75 * math.sqrt(Q.shape[1])
            return ok, f"res {res:.2e} orth {orth:.2e}"
        return gates

    def krill_gates(X, o):
        """PCG stopped before its cap, and the backward error
        ‖r‖/(‖K + μI‖₂‖x‖) within 10·tol (PCG's relative-residual stop
        bounds it by tol; f32 drift between the recursive and the true
        residual takes the rest; PERF.md §2's one eps32 holds only where
        PCG reaches f32's floor, as on the main path), ‖K + μI‖₂ by 30
        power steps in f64."""
        x = o["x"].double()
        K = kop(X.double(), x.device)
        r = K.matmat(x) - H.double().to(x.device)
        v = torch.ones_like(x)
        for _ in range(30):
            v = K.matmat(v)
            Kn = float(torch.linalg.vector_norm(v))
            v = v / Kn
        back = float(torch.linalg.vector_norm(r) / (
            Kn * torch.linalg.vector_norm(x))) / EPS32
        return back <= 10 * 1e-5 / EPS32 and o["iters"] < 200, \
            f"backward {back:.3f} eps, {o['iters']} iterations"

    def revd2_gates(X, o):
        V, lam = o["V"].double(), o["lam"]
        orth = float(torch.linalg.norm(V.T @ V - torch.eye(
            64, dtype=torch.float64, device=V.device)))
        ok = (not o["fail"] and orth <= 10 * EPS32 ** 0.75 * 8
              and bool((lam >= 0).all() and (lam[:-1] >= lam[1:]).all()))
        return ok, f"orth {orth:.2e}, fail {o['fail']}"

    paths = {f"bqrrp_factored {n}x{n} b128 {tp}": ((n, n), bq(tp),
                                                    qr_gates(tp))
             for tp in ("highest", *MODES)}
    paths[f"hqrrp {n}x{n} b64 qrcp"] = ((n, n), hq(PanelQR.qrcp),
                                        qr_gates("highest"))
    paths[f"hqrrp {n}x{n} b64 qrcp high"] = ((n, n), hq(PanelQR.qrcp,
                                                        "high"),
                                             qr_gates("high"))
    paths[f"hqrrp {n}x{n} b64 cholqr"] = ((n, n), hq(PanelQR.cholqr),
                                          qr_gates("highest"))
    paths["cqrrpt 8192x256 qrcp=hqrrp b128"] = ((8192, 256), cq,
                                                qr_gates("highest"))
    paths[f"krill_full_rpchol n{kn} d8 k64"] = ((8, kn), krill,
                                                 krill_gates)
    paths[f"revd2_fixed_rank n{kn} d8 k64"] = ((8, kn), revd2, revd2_gates)
    return paths


def edge_rank_body(mesh, mutators):
    """2 gloo ranks: dist_bqrrp_factored (K1-K3) and dist_hqrrp (K5, K6)
    on 1024x512 under each mutator, and beside each the single-process
    driver on the whole input (its ``fail`` must agree); the gates and
    each kernel's hold on this rank's first launch, per mutator."""
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.drivers import (BQRRPConfig, HQRRPConfig,
                                              bqrrp_factored, bqrrp_q,
                                              hqrrp)
    from randlapack_tpu_torch.parallel import (dist_bqrrp_factored,
                                               dist_hqrrp, row_sharded)
    from randlapack_tpu_torch.utils import kernel_checks
    out = {}
    for how in mutators:
        A = edge_input((1024, 512), how, 3)
        g = torch.Generator()
        g.manual_seed(4)
        S = torch.randn((160, 1024), generator=g) / 160 ** 0.5
        G = torch.rand((74, 1024), generator=g) * 2 - 1
        r0, r1 = mesh.rows(1024 // mesh.size)
        As = row_sharded(mesh).put(A)
        for name in ("dist_bqrrp_factored", "dist_hqrrp"):
            with kernel_checks.Recorder() as rec:
                if name == "dist_bqrrp_factored":
                    fac, _ = dist_bqrrp_factored(
                        As, mesh, RNGState(0), block_size=128,
                        sketch=S[:, r0:r1].to(mesh.device))
                    Q, R, J, fail = (bqrrp_q(fac, mesh=mesh), fac.R, fac.J,
                                     fac.fail)
                else:
                    Q, R, J, _, fail, _ = dist_hqrrp(
                        As, mesh, RNGState(0), block_size=64,
                        sketch=G[:, r0:r1].to(mesh.device))
            Qw = mesh.gather_rows(Q)
            res, orth = _f64_res_orth(A.to(Q.device), Qw, R, J)
            held = {k: v["ok"] for k, v in rec.hold().items()}
            Ad = A.to(mesh.device)
            if name == "dist_bqrrp_factored":
                f1, _ = bqrrp_factored(Ad, BQRRPConfig(block_size=128),
                                       RNGState(0), sketch=S.to(mesh.device))
                Q1, R1, J1, fail1 = bqrrp_q(f1), f1.R, f1.J, f1.fail
            else:
                Q1, R1, J1, _, fail1, _ = hqrrp(
                    Ad, HQRRPConfig(block_size=64), RNGState(0),
                    sketch=G.to(mesh.device))
            out[(name, how)] = dict(
                res=res, orth=orth, fail=bool(fail), single_fail=bool(fail1),
                single=_f64_res_orth(Ad, Q1, R1, J1), launches=rec.launches,
                held=held)
    return out


def edge_run(run, gates, A, dev):
    """``gates(A, run(A, dev))``, an exception counted as unsound."""
    try:
        return gates(A, run(A, dev))
    except (RuntimeError, ValueError) as e:   # a LinAlgError, a refusal
        return False, f"raised {type(e).__name__}: {str(e)[:80]}"


def phase_edge(dev) -> None:
    """[edge]: the driver paths and kernels under the mutators (see the
    comment above EDGE_N)."""
    from randlapack_tpu_torch.parallel import run_ranks
    from randlapack_tpu_torch.utils import kernel_checks
    t0 = time.perf_counter()
    runs = shared = 0
    for name, (shape, run, gates) in edge_paths().items():
        rows, launches = [], Counter()
        for i, how in enumerate(EDGE_MUTATORS):
            A = edge_input(shape, how, 10 + i)
            with kernel_checks.Recorder() as rec:
                ok, detail = edge_run(run, gates, A, dev)
                torch.cuda.synchronize()
            runs += 1
            launches.update(rec.launches)
            for kname, r in rec.hold().items():
                gate(r["ok"], f"edge: {name} {how}: {kname} against its "
                     f"plain version: {r['why']}")
            if not ok:
                cpu_ok, cpu_detail = edge_run(run, gates, A, "cpu")
                gate(not cpu_ok, f"edge: {name} {how}: the card run is "
                     f"unsound ({detail}) where the CPU's is sound "
                     f"({cpu_detail})")
                shared += 1
                detail += f" [shared: the CPU run too, {cpu_detail}]"
            rows.append(f"{how} {detail}")
        print(f"[edge] {name}: " + "; ".join(rows) + f"; launches over "
              f"the {len(EDGE_MUTATORS)} runs {dict(launches)}, every "
              f"kernel held on each run's operands", flush=True)
    par = run_ranks(edge_rank_body, 2, EDGE_MUTATORS, backend="gloo",
                    device="cuda", timeout=600)
    for name in ("dist_bqrrp_factored", "dist_hqrrp"):
        rows = []
        for how in EDGE_MUTATORS:
            r = par[0][(name, how)]
            gate(all(all(p[(name, how)]["held"].values()) for p in par),
                 f"edge: {name} {how}: a kernel differs from its plain "
                 f"version on a rank's operands")
            def sound(fail, res, orth):
                return not fail and res <= RES_GATE and \
                    orth <= 10 * EPS32 ** 0.75 * math.sqrt(512)
            ok = sound(r["fail"], r["res"], r["orth"])
            gate(r["fail"] == r["single_fail"]
                 and (ok or not sound(r["single_fail"], *r["single"])),
                 f"edge: {name} {how}: {r}")
            runs += 1
            rows.append(f"{how} res {r['res']:.2e} orth {r['orth']:.2e}"
                        + ("" if ok else f", fail {r['fail']} [shared: one "
                           f"process too, res {r['single'][0]:.2e}]"))
        print(f"[edge] {name} 1024x512, 2 gloo ranks: " + "; ".join(rows)
              + f"; rank 0's launches {par[0][(name, how)]['launches']}",
              flush=True)
    cases = 0
    by_kernel = {}
    for kname, how in kernel_checks.cases():
        r = kernel_checks.hold(kname, *kernel_checks.operands(
            kname, how, False, dev))
        gate(r["ok"], f"edge: {kname} on {how} operands: {r['why']}")
        by_kernel.setdefault(kname, []).append(
            f"{how} {r['max_abs_err']:.1e}" + (f" ({r['why']})"
                                                if r["why"] else ""))
        cases += 1
    for kname, rows in by_kernel.items():
        print(f"[edge-kernel] {kname} against its plain version, max|d|: "
              + "; ".join(rows), flush=True)
    print(f"[edge] {runs} driver runs ({shared} unsound on the CPU too), "
          f"{cases} kernel cases: every gate held, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import randlapack_tpu_torch  # noqa: F401  (fails outside the repo)
    from randlapack_tpu_torch.ops import wy
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
    run(phase_lu, dev)
    timed = run(phase_kernels, dev)
    timed.update(run(phase_wy_modes, dev))
    counts = {"bqrrp": run(phase_main, dev, f"{smi}")}
    speed = {"bqrrp": run(phase_bqrrp_speed, dev, f"{smi}")}
    run(phase_old_vs_new, dev)
    run(phase_k3_old_vs_new, dev)
    run(phase_remainder, dev)
    run(phase_small_vs_plain, dev)
    counts["hqrrp"] = run(phase_hqrrp, dev, f"{smi}")
    speed["hqrrp"] = run(phase_hqrrp_speed, dev, f"{smi}")
    run(phase_hqrrp_phases, dev)
    run(phase_hqrrp_cholqr, dev)
    run(phase_hqrrp_small_vs_plain, dev)
    counts["krill"] = run(phase_krill, dev)
    counts["op"] = run(phase_sketch, dev)
    counts["cqrrpt"] = run(phase_cqrrpt, dev, f"{smi}",
                           timed["gaussian_sketch"]["ms"])
    speed["cqrrpt"] = run(phase_cqrrpt_modes, dev, f"{smi}")
    run(phase_rsvd, dev, f"{smi}")
    run(phase_rsvd_8192, dev, f"{smi}")
    run(phase_svd_route_turns, dev)
    revd2_counts = run(phase_revd2, dev, f"{smi}")
    run(phase_nystrom, dev, f"{smi}")
    run(phase_abrik, dev, f"{smi}")
    run(phase_abrik_phases, dev)
    run(phase_abrik_vs_rsvd, dev)
    run(phase_abrik_sparse, dev, f"{smi}")
    run(phase_cholqr_linops_sparse, dev, f"{smi}")
    run(phase_linops_small_vs_plain, dev)
    counts["spls"] = run(phase_spls, dev, f"{smi}")
    run(phase_spls_phases, dev)
    run(phase_solver_linops, dev, f"{smi}")
    counts["trailing_wy"] = run(phase_trailing_wy, dev)
    run(phase_mm_native, dev)
    run(phase_spls_small_vs_plain, dev)
    precision_counts = run(phase_precision, dev, f"{smi}")
    dist_counts = run(phase_parallel, dev, f"{smi}")
    run(phase_k4_k7_old_vs_new, dev)
    run(phase_k5_k6_old_vs_new, dev)
    run(phase_edge, dev)
    if "--profile" in sys.argv[1:]:
        run(phase_kernel_anatomy, dev)
        run(phase_profile, dev)
    print("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f"; all {sum(seconds.values()):.1f} s", flush=True)
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[path][name], **timed[name])
               for name, (src, rep, path) in KERNELS.items()]
    for k in kernels:   # K5/K6 also run inside CQRRPT's sketch QRCP
        if KERNELS[k["name"]][2] == "hqrrp":
            k["cqrrpt_launches"] = counts["cqrrpt"][k["name"]]
        elif k["name"] == "kernel_matmat":    # and K4 inside REVD2
            k["revd2_launches"] = revd2_counts["kernel_matmat"]
        elif k["name"] in ("masked_vt_a", "a_minus_vz_masked"):
            # and K1/K2 once each inside trailing_wy_update
            k["trailing_wy_launches"] = counts["trailing_wy"][k["name"]]
        if KERNELS[k["name"]][2] == "bqrrp":
            # the BQRRP headline's launches at the driver-level precisions
            k["precision_launches"] = {
                p: precision_counts[p][k["name"]] for p in PRECISIONS}
        # the distributed entries that launch it, each of the PAR_P ranks
        k["dist_launches"] = dist_counts[k["name"]]
    # K1/K2's trailing-precision forms: launches in the BQRRP speed mode,
    # beside HQRRP's and CQRRPT's
    for tp, form in MODES.items():
        for base in ("masked_vt_a", "a_minus_vz_masked"):
            src, rep, _ = KERNELS[base]
            entry = wy.FORM_KERNELS[form][base == "a_minus_vz_masked"]
            if not entry.endswith("_mode"):
                src = RING_SOURCE
            name = f"{base}_{form}"
            kernels.append(dict(
                name=name, route="cuda", source=src, replaces=rep,
                launches=speed["bqrrp"][tp][name], **timed[name],
                trailing_precision=tp,
                hqrrp_launches=speed["hqrrp"][tp][name],
                cqrrpt_launches=speed["cqrrpt"][tp][name],
                dist_launches=dist_counts[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
