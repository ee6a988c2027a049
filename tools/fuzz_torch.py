"""Differential fuzz of the PyTorch port, on the twelve driver families of
tools/fuzz_sweep.py under its global scales and column mutators. Run each
round with fresh seeds.

    python tools/fuzz_torch.py SEED TRIALS                 # CPU, f64
    python tools/fuzz_torch.py SEED TRIALS --device cuda   # the card, f32

Every trial's input is made once, as a numpy array from the seed (the
port's generators on the CPU, then the global scale and the mutator), and
handed to every run of the trial.

CPU mode (f64) holds the port against the JAX package. Every draw the JAX
driver makes is made by JAX and injected into the port
(tests/_torch_pairs.py: ``sketch=``, ``qrcp_sketch=``, ``noise=``,
``omegas=``, ``v0=``, ...). Both runs are held to tools/fuzz_sweep.py's
invariants (``check_qr`` and each family's own), ``fail`` must agree, and
pivots and R agree by ROADMAP.md §3's rank-aware rules. Each disagreement
prints one line, classified:
  port-fault  the port unsound where the JAX package is sound, a failure
              flag or an exception the JAX package does not raise, or
              pivots or R that part away from a tie;
  departure   the port sound where the JAX package is not (or flags a
              failure the port does not need);
  shared      both unsound alike, or pivots that part at a tie of |R_ii|,
              which rounding decides (ROADMAP.md §3, "Constraints").
The distributed families run the JAX drivers on p of 8 virtual devices and
the port on p gloo ranks (p 2 or 4).

Card mode (f32, imports no JAX) runs the port on the card and the same
call on the CPU port with the same draws (numpy and the port's samplers),
both held to the drivers' f32 gates (PERF.md §2). A card run that is
unsound (``fail`` raised, non-finite output, a missed gate, an exception)
where the CPU run is sound is a kernel fault when the path launched a
kernel, and card-library when it launched none (the card's cuBLAS and
cuSOLVER against the CPU's); where both are unsound the line says
shared-f32. Each trial prints the launch counts of its path, and
every kernel the path launched is held on that trial's operands (its first
launch) against its plain version (randlapack_tpu_torch.utils.
kernel_checks). The trailing-precision modes take their own residual gate
(2u of the mode), and the card mode adds "bf16_3x_emul" to the modes
drawn.

Both modes end with per-family counts and exit 1 on any port or kernel
fault or unexpected exception.
"""
from __future__ import annotations

import argparse
import math
import os
import random
import sys
import traceback
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import randlapack_tpu_torch as rt  # noqa: E402
from randlapack_tpu_torch import drivers as td  # noqa: E402
from randlapack_tpu_torch import gen as tgen  # noqa: E402

from _torch_pairs import (PortRNG, abrik_draws, bqrrp_sketch,  # noqa: E402
                          compare_pivoted, hqrrp_sketch, qb_omegas,
                          rpchol_noise, sequential_draw, spls_sketch,
                          tall_qr_draws, to_device)

FAMILIES = ["bqrrp", "factored", "hqrrp", "cqrrpt", "spls", "dist",
            "dist_spls", "abrik", "cqrrt", "sparse", "rsvd", "krill"]
MTS = ["polynomial", "exponential", "gaussian", "step"]
EPS32 = float(np.finfo(np.float32).eps)
# the f32 residual gate of each trailing mode: the JAX tests' 10·eps^0.75
# in "highest", 2u of the operands' rounding otherwise (PERF.md §2)
MODE_RES32 = {"highest": 10 * EPS32 ** 0.75, "high": 2 * 2.0 ** -11,
              "default": 2 * 2.0 ** -8, "bf16_3x_emul": 2 * 2.0 ** -16}


class Trial:
    """One trial's settings: ``f32`` selects the card mode's gates."""

    def __init__(self, seed, f32):
        self.seed, self.f32 = seed, f32


# -- copies of tools/fuzz_sweep.py's helpers (numpy, no JAX) ------------------

def check_qr(A, Q, R, J, fail, gate):
    """tools/fuzz_sweep.py:40-51 (``check_qr``): J a permutation and
    ``fail`` raised or ‖Q·R[:k] − A[:, J]‖_F/‖A‖_F under ``gate`` (1e-9
    there). Returns ``(ok, detail)``; the residual is taken in f64."""
    n, kq = A.shape[1], Q.shape[1]
    with np.errstate(all="ignore"):
        res = float(np.linalg.norm(Q.astype(np.float64) @ R[:kq].astype(
            np.float64) - A.astype(np.float64)[:, J])
            / max(float(np.linalg.norm(A.astype(np.float64))), 1e-300))
    ok_piv = sorted(np.asarray(J).tolist()) == list(range(n))
    ok = ok_piv and (bool(fail) or res < gate)
    return ok, f"res={res:.3e} piv_ok={ok_piv} fail={bool(fail)}"


def rand_scale(rng):
    """tools/fuzz_sweep.py:57-62: mostly power-of-2 extremes (the guard
    band), sometimes arbitrary."""
    k = rng.choice([0, 0, -80, -60, -30, 30, 60, 80])
    if rng.random() < 0.3:
        return 10.0 ** rng.choice([-25, -12, 12, 25])
    return 2.0 ** k


def mutate_columns(A, rng, trial):
    """tools/fuzz_sweep.py:65-103 (``mutate_columns``) with its random
    values from numpy (seeded from the trial as the JAX key was): mixed
    2^±50 column scales, near-duplicate columns (1e-9 relative noise), a
    zero and a 1e-300-scaled column, or the Kahan column structure.
    Returns ``(A_mutated, tag_suffix)``."""
    n = A.shape[1]
    key = np.random.default_rng(1_000_003 * trial + 7)
    roll = rng.random()
    if roll < 0.25:
        ks = key.integers(-50, 51, n).astype(A.dtype)
        return A * (2.0 ** ks)[None, :], ":colscale"
    if roll < 0.45:
        kdup = max(1, n // 3)
        noise = 1e-9 * key.standard_normal((A.shape[0], kdup))
        A = A.copy()
        A[:, n - kdup:] = A[:, :kdup] + noise * np.abs(A[:, :kdup]).max()
        return A, ":neardup"
    if roll < 0.55:
        A = A.copy()
        A[:, n // 2] = 0.0
        A[:, max(0, n // 2 - 1)] *= 1e-300
        return A, ":zerodenorm"
    if roll < 0.65:
        theta = 0.9 + 0.8 * float(key.random())
        K = tgen.kahan_matrix(n, torch.float64, theta, device="cpu").numpy()
        return A @ K, ":kahan"
    return A, ""


# -- inputs (the port's generators on the CPU) --------------------------------

def mat(m, n, mt, cond, seed):
    A, _ = tgen.mat_gen(tgen.MatGenInfo(m, n, tgen.MatType(mt),
                                        cond_num=cond),
                        rt.RNGState(seed), device="cpu")
    return A.numpy()


def exp_singvals(n, cond):
    return tgen.gen_exp_singvals(n, cond, torch.float64, device="cpu")


# -- the families: settings, the port's run, the JAX run, the invariants -----
# ``build(rng, t, trial)`` draws the settings and input; ``port(c, draws,
# device, dtype)`` and ``jax(c, seed)`` run them (numpy results);
# ``sound(c, out, f32)`` is the invariant, ``parity(c, oj, ot)`` the CPU
# comparison (None, "tie" or a message).

def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x) if x is not None else None


def _dt(x, device, dtype):
    return to_device(x, device, dtype)


def _finite(*xs):
    return all(x is None or np.isfinite(np.asarray(x, np.float64)).all()
               for x in xs)


class QR:
    """bqrrp, factored, hqrrp, cqrrpt (tools/fuzz_sweep.py:114-189)."""

    @staticmethod
    def build(kind, rng, t, trial, scale):
        m = rng.choice([33, 64, 97, 150, 256, 320])
        n = rng.choice([30, 64, 100, 190, 256])
        b = rng.choice([8, 16, 32, 48, 64])
        if kind == "cqrrpt" and m < 2 * n:
            m = 4 * n
        A = mat(m, n, rng.choice(MTS), 10 ** rng.choice([1, 3, 6, 9]),
                t.seed + trial) * scale
        A, mut = mutate_columns(A, rng, trial)
        tp = rng.choice(["highest", "high", "default"]
                        + (["bf16_3x_emul"] if t.f32 else []))
        if kind == "bqrrp":
            kw = dict(block_size=b, stages=rng.choice([1, 2, 3]),
                      pivot_candidates=rng.choice([None, 2, 4]),
                      trailing_precision=tp,
                      d_factor=rng.choice([1.0, 1.25, 2.0]))
        elif kind == "factored":
            kw = dict(block_size=b, update_defer=rng.choice([1, 2, 3]),
                      sketch_r=rng.choice(["auto", "qr", "gram"]),
                      trailing_precision=tp,
                      pivot_candidates=rng.choice([None, 2]))
        elif kind == "hqrrp":
            kw = dict(block_size=b, oversample=rng.choice([0, 5, 10]),
                      update_defer=rng.choice([1, 2, 3, 4]),
                      trailing_precision=tp,
                      panel_qr=rng.choice(["qrcp", "geqrf", "cholqr"]))
        else:
            kw = dict(sketch=rng.choice(["saso", "srht", "gaussian"]),
                      qrcp=rng.choice(["geqp3", "hqrrp", "bqrrp"]),
                      bqrrp_block=rng.choice([16, 32]),
                      bqrrp_stages=rng.choice([1, 2]),
                      bqrrp_pivot_candidates=rng.choice([None, 2, 4]),
                      bqrrp_update_defer=rng.choice([1, 2, 4]),
                      bqrrp_trailing_precision=tp,
                      q_form=rng.choice(["inverse", "trsm"]),
                      gram_block=rng.choice([0, 16, 32, 512]),
                      trsm_mode=rng.choice(["xla", "blockinv"]),
                      trsm_block=rng.choice([16, 32, 256]),
                      d_factor=rng.choice([1.25, 2.0, 4.0]),
                      orthogonalization=rng.random() < 0.3)
        return dict(kind=kind, A=A, kw=kw, tp=tp,
                    tag=f" m{m} n{n} b{b} {tp}{mut}")

    @staticmethod
    def port(c, draws, device, dtype):
        A, kw, kind = _dt(c["A"], device, dtype), dict(c["kw"]), c["kind"]
        st = rt.RNGState(0)
        if kind == "bqrrp":
            S = bqrrp_sketch(draws, A.shape, kw["block_size"], kw["d_factor"])
            out = td.bqrrp(A, td.BQRRPConfig(**kw), st,
                           sketch=_dt(S, device, dtype))
        elif kind == "factored":
            S = bqrrp_sketch(draws, A.shape, kw["block_size"])
            fac, _ = td.bqrrp_factored(A, td.BQRRPConfig(**kw), st,
                                       sketch=_dt(S, device, dtype))
            out = (td.bqrrp_q(fac), fac.R, fac.J, fac.rank, fac.fail)
        elif kind == "hqrrp":
            G = hqrrp_sketch(draws, A.shape, kw["block_size"],
                             kw["oversample"])
            kw["panel_qr"] = td.PanelQR(kw["panel_qr"])
            out = td.hqrrp(A, td.HQRRPConfig(**kw), st,
                           sketch=_dt(G, device, dtype))
        else:
            cfg = td.CQRRPTConfig(**{**kw, "qrcp": td.QRCPKind(kw["qrcp"])})
            op, qs, noise = tall_qr_draws(
                draws, A.shape, kw["sketch"], kw["d_factor"], cfg.vec_nnz,
                kw["qrcp"], kw["bqrrp_block"], kw["orthogonalization"])
            out = td.cqrrpt(A, cfg, st, sketch=_dt(op, device, dtype),
                            qrcp_sketch=_dt(qs, device, dtype),
                            noise=_dt(noise, device, dtype))
        return dict(zip(("Q", "R", "J", "rank", "fail"),
                        (_np(x) for x in out[:5])))

    @staticmethod
    def jax(c, seed):
        import jax.numpy as jnp
        from randlapack_tpu import RNGState as JRNG
        from randlapack_tpu import drivers as jd
        A, kw, kind, st = jnp.asarray(c["A"]), dict(c["kw"]), c["kind"], \
            JRNG(seed)
        if kind == "bqrrp":
            out = jd.bqrrp(A, jd.BQRRPConfig(**kw), st)
        elif kind == "factored":
            fac, _ = jd.bqrrp_factored(A, jd.BQRRPConfig(**kw), st)
            out = (jd.bqrrp_q(fac), fac.R, fac.J, fac.rank, fac.fail)
        elif kind == "hqrrp":
            kw["panel_qr"] = jd.PanelQR(kw["panel_qr"])
            out = jd.hqrrp(A, jd.HQRRPConfig(**kw), st)
        else:
            kw["qrcp"] = jd.QRCPKind(kw["qrcp"])
            out = jd.cqrrpt(A, jd.CQRRPTConfig(**kw), st)
        return dict(zip(("Q", "R", "J", "rank", "fail"),
                        (np.asarray(x) for x in out[:5])))

    @staticmethod
    def sound(c, o, f32):
        gate = MODE_RES32[c["tp"]] if f32 else 1e-9
        Q, R = o["Q"], o["R"]
        if c["kind"] == "cqrrpt":
            k = int(o["rank"])
            Q, R = Q[:, :k], R[:k]
        ok, detail = check_qr(c["A"], Q, R, o["J"], o["fail"], gate)
        return ok and (bool(o["fail"]) or _finite(Q, R)), detail

    @staticmethod
    def parity(c, oj, ot):
        if int(oj["rank"]) != int(ot["rank"]) and c["kind"] != "factored":
            # the rank is read from R's diagonal: a tie at the cutoff
            # moves it by rounding, as the pivots
            msg = compare_pivoted(oj["R"], oj["J"], ot["R"], ot["J"])
            return msg or "tie"
        return compare_pivoted(oj["R"], oj["J"], ot["R"], ot["J"])


def _orth(Q):
    Q = np.asarray(Q, np.float64)
    with np.errstate(all="ignore"):
        return float(np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1])))


class CQRRT:
    """cqrrt (tools/fuzz_sweep.py:190-226)."""

    @staticmethod
    def build(kind, rng, t, trial, scale):
        n = rng.choice([24, 40, 64, 100])
        m = rng.choice([4, 8, 16]) * n
        A = mat(m, n, rng.choice(MTS), 10 ** rng.choice([1, 3, 6]),
                t.seed + trial) * scale
        A, mut = mutate_columns(A, rng, trial)
        orth_mode = rng.random() < 0.5
        kw = dict(sketch=rng.choice(["saso", "srht", "gaussian"]),
                  d_factor=rng.choice([1.25, 2.0]),
                  orthogonalization=orth_mode)
        return dict(kind=kind, A=A, kw=kw,
                    tag=f" m{m} n{n} orth{int(orth_mode)}{mut}")

    @staticmethod
    def port(c, draws, device, dtype):
        A, kw = _dt(c["A"], device, dtype), c["kw"]
        cfg = td.CQRRTConfig(**{**kw, "sketch": td.SketchKind(kw["sketch"])})
        op, _, noise = tall_qr_draws(draws, A.shape, kw["sketch"],
                                     kw["d_factor"], cfg.vec_nnz,
                                     orth=kw["orthogonalization"])
        out = td.cqrrt(A, cfg, rt.RNGState(0), sketch=_dt(op, device, dtype),
                       noise=_dt(noise, device, dtype))
        if kw["orthogonalization"]:
            return dict(Q=_np(out[0]), R=_np(out[1]), rank=int(out[2]),
                        fail=bool(out[3]))
        return dict(Q=_np(out[0]), R=_np(out[1]), fail=bool(out[2]))

    @staticmethod
    def jax(c, seed):
        import jax.numpy as jnp
        from randlapack_tpu import RNGState as JRNG
        from randlapack_tpu import drivers as jd
        kw = c["kw"]
        cfg = jd.CQRRTConfig(**{**kw, "sketch": jd.SketchKind(kw["sketch"])})
        out = jd.cqrrt(jnp.asarray(c["A"]), cfg, JRNG(seed))
        if kw["orthogonalization"]:
            return dict(Q=np.asarray(out[0]), R=np.asarray(out[1]),
                        rank=int(out[2]), fail=bool(out[3]))
        return dict(Q=np.asarray(out[0]), R=np.asarray(out[1]),
                    fail=bool(out[2]))

    @staticmethod
    def sound(c, o, f32):
        A, Q, R = c["A"], o["Q"], o["R"]
        n = A.shape[1]
        if c["kw"]["orthogonalization"]:
            orth = _orth(Q)
            gate = 10 * EPS32 ** 0.75 * math.sqrt(n) if f32 \
                else 1e-8 * math.sqrt(n)
            return (o["fail"] or orth < gate), f"orth={orth:.3e}"
        with np.errstate(all="ignore"):
            res = float(np.linalg.norm(Q.astype(np.float64) @ R.astype(
                np.float64) - A) / max(np.linalg.norm(A), 1e-300))
        gate = 10 * EPS32 ** 0.75 if f32 else 1e-9
        return (o["fail"] or res < gate), f"res={res:.3e}"

    @staticmethod
    def parity(c, oj, ot):
        if "rank" in oj and oj["rank"] != ot["rank"]:
            return f"rank {ot['rank']} against {oj['rank']}"
        Rj, Rt = np.asarray(oj["R"]), np.asarray(ot["R"])
        d = np.abs(Rj - Rt).max() / max(np.abs(Rj).max(), 1e-300)
        if d <= 1e-6:
            return None
        if "rank" in oj:
            # orthogonalization mode returns R as a byproduct, the CholQR
            # factor of the preconditioned kept columns (drivers/cqrrt.py:
            # 172-177): past a dropped column it follows the sketch QR's
            # reflector there, and past 1/eps of the sketch R's condition
            # it is rounding; the contract is Q, rank and fail
            return f"shared: orthogonalization mode's byproduct R " \
                f"differs by {d:.3e} of max|R|"
        return f"R differs by {d:.3e} of max|R|"


def _ne(A, b, x, mu):
    """‖Aᵀ(Ax − b) + μx‖/‖Aᵀb‖ in f64 (tools/fuzz_sweep.py's ``opt``)."""
    A, b, x = (np.asarray(v, np.float64) for v in (A, b, x))
    return float(np.linalg.norm(A.T @ (A @ x - b) + mu * x)
                 / np.linalg.norm(A.T @ b))


def _ne32_gate(A, x):
    """f32: ‖Aᵀr‖/(‖A‖_F²‖x‖) ≤ √n·eps32 (PERF.md §2's SPLS gate), as a
    bound on ``_ne``'s numerator."""
    A, x = np.asarray(A, np.float64), np.asarray(x, np.float64)
    return math.sqrt(A.shape[1]) * EPS32 * np.linalg.norm(A) ** 2 \
        * np.linalg.norm(x)


class SPLS:
    """spls (tools/fuzz_sweep.py:227-248)."""

    @staticmethod
    def build(kind, rng, t, trial, scale):
        m, n = rng.choice([(300, 40), (500, 80), (800, 120)])
        mu = rng.choice([0.0, 1e-6, 1e-3])
        A = mat(m, n, "exponential", 10 ** rng.choice([2, 4, 6]),
                t.seed + trial)
        xt = np.random.default_rng(trial).standard_normal(n)
        solver = rng.choice(["pcg", "lsqr", "auto"])
        d_factor = rng.choice([2.0, 4.0, 8.0])
        return dict(kind=kind, A=A, b=A @ xt, mu=mu, solver=solver,
                    d_factor=d_factor, tag=f" m{m} n{n} {solver} mu{mu}")

    @staticmethod
    def _cfg(drivers, comps, c):
        return drivers.SPLSConfig(
            solver=c["solver"], d_factor=c["d_factor"],
            pcg=comps.PCGSaddleConfig(tol=1e-12, max_iters=300))

    @staticmethod
    def port(c, draws, device, dtype):
        cfg = SPLS._cfg(td, rt.comps, c)
        S = spls_sketch(draws, c["A"].shape, cfg.d_factor, cfg.vec_nnz,
                        cfg.precond)
        x, _, it, _ = td.spls(_dt(c["A"], device, dtype),
                              _dt(c["b"], device, dtype), c["mu"], cfg,
                              rt.RNGState(0), sketch=_dt(S, device, dtype))
        return dict(x=_np(x), iters=int(it))

    @staticmethod
    def jax(c, seed):
        import jax.numpy as jnp
        from randlapack_tpu import RNGState as JRNG
        from randlapack_tpu import comps as jc
        from randlapack_tpu import drivers as jd
        x, _, it, _ = jd.spls(jnp.asarray(c["A"]), jnp.asarray(c["b"]),
                              c["mu"], SPLS._cfg(jd, jc, c), JRNG(seed))
        return dict(x=np.asarray(x), iters=int(it))

    @staticmethod
    def sound(c, o, f32):
        if not _finite(o["x"]):
            return False, "x not finite"
        ne = _ne(c["A"], c["b"], o["x"], c["mu"])
        if f32:
            A = np.asarray(c["A"], np.float64)
            num = ne * np.linalg.norm(A.T @ np.asarray(c["b"], np.float64))
            return num <= _ne32_gate(A, o["x"]), f"ne={ne:.3e}"
        return ne < 1e-7, f"opt={ne:.3e}"

    @staticmethod
    def parity(c, oj, ot):
        d = np.linalg.norm(ot["x"] - oj["x"]) / np.linalg.norm(oj["x"])
        if d <= 1e-6:
            return None
        # LSQR's and PCG's iterates are fixed to rounding only at their
        # stall stop (ROADMAP.md §3, "Constraints"): a shared behaviour
        # where both met the optimality gate
        return f"shared: x differs by {d:.3e} (iterations {ot['iters']} " \
            f"against {oj['iters']})"


class ABRIK:
    """abrik (tools/fuzz_sweep.py:249-281)."""

    @staticmethod
    def build(kind, rng, t, trial, scale):
        m = rng.choice([100, 150, 220])
        n = rng.choice([60, 90])
        k = rng.choice([4, 8])
        bs = rng.choice([4, 8])
        q = rng.choice([4, 8, 20])
        mt = rng.choice(MTS)
        A = mat(m, n, mt, 10 ** rng.choice([2, 6]), t.seed + trial)
        qr = rng.choice(["geqrf", "cqrrt"])
        return dict(kind=kind, A=A, k=k, mt=mt, sv=np.linalg.svd(
            A, compute_uv=False), kw=dict(block_size=bs, max_iters=q,
                                          qr_explicit=qr),
            tag=f" m{m} n{n} k{k} b{bs} q{q} {qr}")

    @staticmethod
    def port(c, draws, device, dtype):
        kw = c["kw"]
        v0, sk = abrik_draws(draws, c["A"].shape, kw["block_size"],
                             kw["max_iters"], kw["qr_explicit"])
        U, S, Vt, info, _ = td.abrik(_dt(c["A"], device, dtype), c["k"],
                                     td.ABRIKConfig(**kw), rt.RNGState(0),
                                     v0=_dt(v0, device, dtype),
                                     qr_sketches=_dt(sk, device, dtype))
        return dict(U=_np(U), S=_np(S))

    @staticmethod
    def jax(c, seed):
        import jax.numpy as jnp
        from randlapack_tpu import RNGState as JRNG
        from randlapack_tpu import drivers as jd
        U, S, Vt, info, _ = jd.abrik(jnp.asarray(c["A"]), c["k"],
                                     jd.ABRIKConfig(**c["kw"]), JRNG(seed))
        return dict(U=np.asarray(U), S=np.asarray(S))

    @staticmethod
    def sound(c, o, f32):
        kw, sv, S = c["kw"], c["sv"], np.asarray(o["S"], np.float64)
        detail, ok = [], True
        if kw["max_iters"] * kw["block_size"] >= 8 * c["k"] and c["mt"] in (
                "polynomial", "exponential"):
            rel = float(np.max(np.abs(S[:2] - sv[:2]) / sv[:2]))
            ok &= rel <= (1e-4 if f32 else 1e-6)
            detail.append(f"sv rel={rel:.3e}")
        orth = _orth(o["U"])
        ok &= orth <= (10 * EPS32 ** 0.75 * math.sqrt(o["U"].shape[1])
                       if f32 else 1e-8)
        detail.append(f"orth={orth:.3e}")
        return bool(ok), " ".join(detail)

    @staticmethod
    def parity(c, oj, ot):
        d = np.abs(ot["S"] - oj["S"]).max() / oj["S"][0]
        return None if d <= 1e-8 else f"S differs by {d:.3e} of S[0]"


class Sparse:
    """sparse operators (tools/fuzz_sweep.py:282-322)."""

    @staticmethod
    def build(kind, rng, t, trial, scale):
        m = rng.choice([120, 200, 300])
        n = rng.choice([60, 100])
        dens = rng.choice([0.005, 0.02, 0.1, 0.5])
        sv = exp_singvals(n, 10.0 ** rng.choice([2, 5]))
        Ad, _ = tgen.gen_sparse_from_singvals(m, n, sv, dens,
                                              rt.RNGState(t.seed + trial))
        sub = rng.choice(["abrik", "cholqr"])
        return dict(kind=kind, A=Ad.numpy() * scale, sub=sub,
                    tag=f" {sub} m{m} n{n} dens{dens}")

    @staticmethod
    def port(c, draws, device, dtype):
        A = c["A"]
        rows, cols = np.nonzero(A)
        op = rt.linops.SparseLinOp.from_coo(
            rows, cols, _dt(A[rows, cols], "cpu", dtype), A.shape,
            device=device)
        if c["sub"] == "abrik":
            v0, _ = abrik_draws(draws, A.shape, 4, 6)
            cfg = td.ABRIKConfig(block_size=4, max_iters=6)
            S_sp = td.abrik(op, 4, cfg, rt.RNGState(0),
                            v0=_dt(v0, device, dtype))[1]
            S_dn = td.abrik(_dt(A, device, dtype), 4, cfg, rt.RNGState(0),
                            v0=_dt(v0, device, dtype))[1]
            return dict(S_sp=_np(S_sp), S_dn=_np(S_dn))
        R, fail, _ = td.cholqr_linops(op)
        return dict(R=_np(R), fail=bool(fail))

    @staticmethod
    def jax(c, seed):
        import jax.numpy as jnp
        from randlapack_tpu import RNGState as JRNG
        from randlapack_tpu import drivers as jd
        from randlapack_tpu.drivers.cholqr_linops import cholqr_linops
        from randlapack_tpu.linops import SparseLinOp
        A = jnp.asarray(c["A"])
        op = SparseLinOp.from_dense(A)
        if c["sub"] == "abrik":
            cfg = jd.ABRIKConfig(block_size=4, max_iters=6)
            return dict(S_sp=np.asarray(jd.abrik(op, 4, cfg, JRNG(seed))[1]),
                        S_dn=np.asarray(jd.abrik(A, 4, cfg, JRNG(seed))[1]))
        R, fail, _ = cholqr_linops(op)
        return dict(R=np.asarray(R), fail=bool(fail))

    @staticmethod
    def sound(c, o, f32):
        if c["sub"] == "abrik":
            gap = float(np.max(np.abs(o["S_sp"] - o["S_dn"])
                               / np.maximum(np.abs(o["S_dn"]), 1e-300)))
            return gap < (1e-4 if f32 else 1e-9), f"gap={gap:.3e}"
        A = np.asarray(c["A"], np.float64)
        R = np.asarray(o["R"], np.float64)
        G = A.T @ A
        with np.errstate(all="ignore"):
            gerr = float(np.linalg.norm(R.T @ R - G)
                         / max(np.linalg.norm(G), 1e-300))
        return (o["fail"] or gerr < (1e-4 if f32 else 1e-9)), \
            f"gram err={gerr:.3e}"

    @staticmethod
    def parity(c, oj, ot):
        if c["sub"] == "abrik":
            d = np.abs(ot["S_sp"] - oj["S_sp"]).max() / oj["S_sp"][0]
            return None if d <= 1e-8 else f"S differs by {d:.3e}"
        if oj["fail"] != ot["fail"]:
            return "fail differs"
        d = np.abs(ot["R"] - oj["R"]).max() / max(np.abs(oj["R"]).max(),
                                                  1e-300)
        return None if d <= 1e-8 else f"R differs by {d:.3e} of max|R|"


class LowRank:
    """rsvd and revd2 (tools/fuzz_sweep.py:323-388)."""

    @staticmethod
    def build(kind, rng, t, trial, scale):
        svdm = rng.choice(["auto", "gram_eigh", "jacobi"])
        sub = rng.choice(["rsvd", "revd2"])
        if sub == "rsvd":
            m = rng.choice([90, 150, 260])
            n = rng.choice([60, 120])
            k = rng.choice([8, 16])
            A = mat(m, n, rng.choice(["polynomial", "exponential"]),
                    10 ** rng.choice([3, 6, 9]), t.seed + trial) * scale
            sv = np.linalg.svd(A, compute_uv=False)
            return dict(kind=kind, sub=sub, A=A, k=k, svdm=svdm,
                        opt=float(np.linalg.norm(sv[k:])
                                  / np.linalg.norm(sv)),
                        tag=f" rsvd svd={svdm} m{m} n{n} k{k}")
        n = rng.choice([80, 140])
        k = rng.choice([4, 8])
        lam = exp_singvals(n, 10.0 ** rng.choice([2, 5]))
        K = tgen.psd_from_eigvals(n, lam, rt.RNGState(t.seed + trial))[0]
        K = K.numpy() * abs(scale)
        return dict(kind=kind, sub=sub, A=K, k=k, svdm=svdm,
                    tol=1e-10 * abs(scale),
                    lam=np.sort(np.linalg.eigvalsh(K))[::-1],
                    tag=f" revd2 svd={svdm} n{n} k{k}")

    @staticmethod
    def port(c, draws, device, dtype):
        A = _dt(c["A"], device, dtype)
        if c["sub"] == "rsvd":
            cfg = td.RSVDConfig(svd_method=c["svdm"])
            oms = qb_omegas(draws, A.shape, c["k"], cfg.qb.block_size,
                            cfg.qb.rf.rs.passes_over_data)
            U, S, Vt, rank, err, _ = td.rsvd(A, c["k"], cfg, rt.RNGState(0),
                                             omegas=_dt(oms, device, dtype))
            return dict(U=_np(U), S=_np(S), Vt=_np(Vt))
        draw = sequential_draw(draws)
        V, lam, k_used, err, fail, _ = td.revd2(
            A, c["k"], c["tol"], td.REVD2Config(svd_method=c["svdm"]),
            rt.RNGState(0), draw=lambda shape, k: _dt(draw(shape, k),
                                                      device, dtype))
        return dict(V=_np(V), lam=_np(lam), fail=bool(fail))

    @staticmethod
    def jax(c, seed):
        import jax.numpy as jnp
        from randlapack_tpu import RNGState as JRNG
        from randlapack_tpu import drivers as jd
        A = jnp.asarray(c["A"])
        if c["sub"] == "rsvd":
            U, S, Vt, _, _, _ = jd.rsvd(A, c["k"],
                                        jd.RSVDConfig(svd_method=c["svdm"]),
                                        JRNG(seed))
            return dict(U=np.asarray(U), S=np.asarray(S), Vt=np.asarray(Vt))
        V, lam, _, _, fail, _ = jd.revd2(A, c["k"], c["tol"],
                                         jd.REVD2Config(svd_method=c["svdm"]),
                                         JRNG(seed))
        return dict(V=np.asarray(V), lam=np.asarray(lam), fail=bool(fail))

    @staticmethod
    def sound(c, o, f32):
        A = np.asarray(c["A"], np.float64)
        if c["sub"] == "rsvd":
            U = np.asarray(o["U"], np.float64)
            orth = _orth(U)
            with np.errstate(all="ignore"):
                cap = float(np.linalg.norm(A - (U * o["S"]) @ np.asarray(
                    o["Vt"], np.float64)) / max(np.linalg.norm(A), 1e-300))
            og = 10 * EPS32 ** 0.75 * math.sqrt(U.shape[1]) if f32 else 1e-8
            slack = 1e-4 if f32 else 1e-9
            return (orth < og and cap <= 10 * c["opt"] + slack), \
                f"orth={orth:.3e} cap={cap:.3e} opt={c['opt']:.3e}"
        V = np.asarray(o["V"], np.float64)
        orth = _orth(V)
        lam_t = c["lam"]
        rel = float(np.max(np.abs(np.asarray(o["lam"][:2], np.float64)
                                  - lam_t[:2]) / lam_t[:2]))
        og = 10 * EPS32 ** 0.75 * math.sqrt(V.shape[1]) if f32 else 1e-8
        return (o["fail"] or (orth < og and rel < (1e-3 if f32 else 1e-6))), \
            f"orth={orth:.3e} rel={rel:.3e}"

    @staticmethod
    def parity(c, oj, ot):
        if c["sub"] == "rsvd":
            d = np.abs(ot["S"][:2] - oj["S"][:2]).max() / oj["S"][0]
            return None if d <= 1e-8 else f"S differs by {d:.3e} of S[0]"
        if oj["fail"] != ot["fail"]:
            return "fail differs"
        d = np.abs(ot["lam"][:2] - oj["lam"][:2]).max() / abs(oj["lam"][0])
        return None if d <= 1e-8 else f"lambda differs by {d:.3e}"


class KRILL:
    """krill (tools/fuzz_sweep.py:389-453): μ scales with the kernel."""

    @staticmethod
    def build(kind, rng, t, trial, scale):
        n = rng.choice([100, 160, 240])
        s_cols = rng.choice([1, 2])
        lam = exp_singvals(n, 10.0 ** rng.choice([3, 5]))
        K = tgen.psd_from_eigvals(n, lam, rt.RNGState(t.seed + trial))[0]
        sc = abs(scale)
        mu_base = 10.0 ** rng.choice([-2, -3])
        mus = np.asarray([mu_base * 3.0 ** j for j in range(s_cols)]) * sc
        H = np.random.default_rng(trial).standard_normal((n, s_cols)) * sc
        sub = rng.choice(["full", "restricted"])
        return dict(kind=kind, K=K.numpy() * sc, mus=mus, H=H, sub=sub,
                    tag=f" {sub} n{n} s{s_cols} mu{mu_base:.0e}")

    @staticmethod
    def _cfg(drivers, comps):
        return drivers.KrillConfig(k=64, rpchol_block=16, pcg=comps.PCGConfig(
            tol=1e-10, max_iters=400))

    @staticmethod
    def port(c, draws, device, dtype):
        n = c["K"].shape[0]
        mus = _dt(c["mus"], device, dtype)
        G = rt.linops.RegExplicitSymLinOp(_dt(c["K"], device, dtype), mus)
        noise = _dt(rpchol_noise(draws, n, 64 // 16), device, dtype)
        fn = (td.krill_full_rpchol if c["sub"] == "full"
              else td.krill_restricted_rpchol)
        out = fn(G, _dt(c["H"], device, dtype), mus, KRILL._cfg(td, rt.comps),
                 rt.RNGState(0), noise=noise)
        if c["sub"] == "full":
            return dict(X=_np(out[0]), iters=int(out[2]))
        return dict(X=_np(out[0]), inds=_np(out[1]))

    @staticmethod
    def jax(c, seed):
        import jax.numpy as jnp
        from randlapack_tpu import RNGState as JRNG
        from randlapack_tpu import comps as jc
        from randlapack_tpu import drivers as jd
        from randlapack_tpu.linops.symmetric import RegExplicitSymLinOp
        mus = jnp.asarray(c["mus"])
        G = RegExplicitSymLinOp(jnp.asarray(c["K"]), mus)
        fn = (jd.krill_full_rpchol if c["sub"] == "full"
              else jd.krill_restricted_rpchol)
        out = fn(G, jnp.asarray(c["H"]), mus, KRILL._cfg(jd, jc), JRNG(seed))
        if c["sub"] == "full":
            return dict(X=np.asarray(out[0]), iters=int(out[2]))
        return dict(X=np.asarray(out[0]), inds=np.asarray(out[1]))

    @staticmethod
    def sound(c, o, f32):
        K, H, X = c["K"], c["H"], np.asarray(o["X"], np.float64)
        n = K.shape[0]
        if not _finite(X):
            return False, "X not finite"
        if c["sub"] == "restricted":
            supp = np.setdiff1d(np.arange(n), o["inds"])
            off = float(np.abs(X[supp]).max()) if len(supp) else 0.0
            return off == 0.0, f"off-support max={off:.3e}"
        worst, detail = 0.0, []
        for j in range(X.shape[1]):
            Kj = K + c["mus"][j] * np.eye(n)
            r = np.linalg.norm(Kj @ X[:, j] - H[:, j])
            if f32:      # the backward error, in units of eps32
                val = r / ((np.linalg.norm(Kj, 2)) * np.linalg.norm(
                    X[:, j])) / EPS32
                worst = max(worst, val / 1.0)
                detail.append(f"col{j} backward={val:.3f} eps")
            else:
                val = r / np.linalg.norm(H[:, j])
                worst = max(worst, val / 1e-6)
                detail.append(f"col{j} res={val:.3e}")
        return worst < 1.0, " ".join(detail)

    @staticmethod
    def parity(c, oj, ot):
        if c["sub"] == "restricted" and not np.array_equal(oj["inds"],
                                                           ot["inds"]):
            return "pivots differ"
        d = np.abs(ot["X"] - oj["X"]).max() / np.abs(oj["X"]).max()
        return None if d <= 1e-6 else f"X differs by {d:.3e} of max|X|"


class Dist:
    """dist and dist_spls (tools/fuzz_sweep.py:454-527) at p 2 or 4."""

    @staticmethod
    def build(kind, rng, t, trial, scale):
        p = min(rng.choice([2, 4, 8]), 4)
        if kind == "dist_spls":
            m = rng.choice([40, 60]) * p
            n = rng.choice([24, 40])
            A = mat(m, n, "exponential", 10 ** rng.choice([2, 5]),
                    t.seed + trial)
            xt = np.random.default_rng(trial).standard_normal(n)
            mu = rng.choice([0.0, 1e-5])
            return dict(kind=kind, p=p, A=A, b=A @ xt, mu=mu, drv="spls",
                        tag=f" p{p} m{m} n{n} mu{mu}")
        m = rng.choice([16, 24, 32]) * p
        n = rng.choice([32, 48])
        A = mat(m, n, "exponential", 10 ** rng.choice([2, 5]),
                t.seed + trial) * scale
        drv = rng.choice(["bqrrp", "cqrrpt", "hqrrp", "rsvd", "cqrrt",
                          "revd2"])
        if drv in ("cqrrt", "cqrrpt") and m < n:     # tall-only contract
            m = 2 * n if (2 * n) % p == 0 else 2 * n * p
            A = mat(m, n, "exponential", 100, t.seed + trial)
        c = dict(kind=kind, p=p, A=A, drv=drv, tag=f" p{p} {drv} m{m} n{n}")
        if drv == "revd2":
            P = A.T @ A
            c["P"] = P / np.linalg.norm(P)
        return c

    @staticmethod
    def _draws(c, draws):
        A, drv = c["A"], c["drv"]
        m, n = A.shape
        if drv in ("bqrrp",):
            return dict(S=bqrrp_sketch(draws, A.shape, 16))
        if drv == "hqrrp":
            return dict(S=hqrrp_sketch(draws, A.shape, 16))
        if drv == "rsvd":
            key, _ = draws.spawn()
            return dict(omega=draws.normal(key, (n, 8)))
        if drv == "revd2":
            key, nxt = draws.spawn()
            key_v, _ = nxt.spawn()
            return dict(omega=draws.normal(key, (n, 8)),
                        v0=draws.normal(key_v, (n, 1)))
        d = int((4.0 if drv == "spls" else 1.25) * n)
        if drv != "cqrrpt":
            d = min(d, m)
        key, _ = draws.spawn()
        return dict(S=draws.normal(key, (d, m)) / math.sqrt(d))

    @staticmethod
    def port(c, draws, device, dtype):
        from randlapack_tpu_torch.parallel import run_ranks

        import _torch_parallel_ranks as ranks
        case = dict(c, seed=0, dtype=str(dtype).split(".")[1],
                    **Dist._draws(c, draws))
        out = run_ranks(ranks.fuzz_body, c["p"], case, backend="gloo",
                        device=device, timeout=600)
        res = dict(out[0])
        for key in ("Q", "U", "V"):                     # row-sharded
            if key in res:
                res[key] = np.concatenate([r[key] for r in out])
        if c["drv"] == "spls":
            res["x"] = out[0]["x"]
        return res

    @staticmethod
    def jax(c, seed):
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh
        from randlapack_tpu import RNGState as JRNG
        from randlapack_tpu import parallel as jp
        mesh = Mesh(np.array(jax.devices()[:c["p"]]).reshape(c["p"]),
                    ("rows",))
        A, st, drv = jnp.asarray(c["A"]), JRNG(seed), c["drv"]
        if drv == "spls":
            As = jax.device_put(A, jp.row_sharded(mesh))
            x, _, it, _ = jp.dist_spls(As, jnp.asarray(c["b"]), c["mu"], mesh,
                                       st, tol=1e-12, max_iters=150)
            return dict(x=np.asarray(x), iters=int(it))
        if drv == "rsvd":
            U, S, Vt, fail, _ = jp.dist_rsvd(A, 8, mesh, st)
            return dict(U=np.asarray(U), S=np.asarray(S), fail=bool(fail))
        if drv == "revd2":
            V, lam, _, _, fail, _ = jp.dist_revd2(jnp.asarray(c["P"]), 8,
                                                  mesh, st,
                                                  error_est_passes=4)
            return dict(V=np.asarray(V), lam=np.asarray(lam),
                        fail=bool(fail))
        if drv == "cqrrt":
            Q, R, fail, _ = jp.dist_cqrrt(A, mesh, st)
            return dict(Q=np.asarray(Q), R=np.asarray(R), fail=bool(fail))
        fn = {"bqrrp": jp.dist_bqrrp, "cqrrpt": jp.dist_cqrrpt,
              "hqrrp": jp.dist_hqrrp}[drv]
        kw = {} if drv == "cqrrpt" else {"block_size": 16}
        out = fn(A, mesh, st, **kw)
        return dict(zip(("Q", "R", "J", "rank", "fail"),
                        (np.asarray(x) for x in out[:5])))

    @staticmethod
    def sound(c, o, f32):
        drv, A = c["drv"], np.asarray(c["A"], np.float64)
        g9 = 10 * EPS32 ** 0.75 if f32 else 1e-9
        if drv == "spls":
            ne = _ne(A, c["b"], o["x"], c["mu"])
            if f32:
                num = ne * np.linalg.norm(A.T @ c["b"])
                return num <= _ne32_gate(A, o["x"]), f"ne={ne:.3e}"
            return ne < 1e-8, f"opt={ne:.3e}"
        if drv == "rsvd":
            orth = _orth(o["U"])
            og = 10 * EPS32 ** 0.75 * math.sqrt(8) if f32 else 1e-8
            return (o["fail"] or orth < og), f"orth={orth:.3e}"
        if drv == "revd2":
            orth = _orth(o["V"])
            og = 10 * EPS32 ** 0.75 * math.sqrt(8) if f32 else 1e-9
            return (o["fail"] or orth < og), f"orth={orth:.3e}"
        if drv == "cqrrt":
            with np.errstate(all="ignore"):
                res = float(np.linalg.norm(np.asarray(o["Q"], np.float64)
                                           @ np.asarray(o["R"], np.float64)
                                           - A) / np.linalg.norm(A))
            return (o["fail"] or res < g9), f"res={res:.3e}"
        ok, detail = check_qr(A, o["Q"], o["R"], o["J"], o["fail"], g9)
        return ok and (bool(o["fail"]) or _finite(o["Q"], o["R"])), detail

    @staticmethod
    def parity(c, oj, ot):
        drv = c["drv"]
        if "fail" in oj and bool(oj["fail"]) != bool(ot["fail"]):
            return "fail differs"
        if drv == "spls":
            d = np.linalg.norm(ot["x"] - oj["x"]) / np.linalg.norm(oj["x"])
            return None if d <= 1e-6 else f"shared: x differs by {d:.3e}"
        if drv == "rsvd":
            d = np.abs(ot["S"] - oj["S"]).max() / oj["S"][0]
            return None if d <= 1e-8 else f"S differs by {d:.3e}"
        if drv == "revd2":
            d = np.abs(ot["lam"][:2] - oj["lam"][:2]).max() / oj["lam"][0]
            return None if d <= 1e-8 else f"lambda differs by {d:.3e}"
        if drv == "cqrrt":
            d = np.abs(ot["R"] - oj["R"]).max() / np.abs(oj["R"]).max()
            return None if d <= 1e-6 else f"R differs by {d:.3e}"
        return compare_pivoted(oj["R"], oj["J"], ot["R"], ot["J"])


FAMILY = {"bqrrp": QR, "factored": QR, "hqrrp": QR, "cqrrpt": QR,
          "spls": SPLS, "dist": Dist, "dist_spls": Dist, "abrik": ABRIK,
          "cqrrt": CQRRT, "sparse": Sparse, "rsvd": LowRank, "krill": KRILL}


# -- the two modes ------------------------------------------------------------

def classify_cpu(fam, c, oj, ot, jerr, terr):
    """The class and detail of a CPU-mode disagreement, or None."""
    if jerr or terr:
        if jerr and terr and jerr.split(":")[0] == terr.split(":")[0]:
            return None                           # the same named refusal
        if terr:
            return "port-fault", f"port raised {terr} (JAX: {jerr or 'ran'})"
        return "departure", f"JAX raised {jerr}; the port ran"
    j_ok, j_detail = fam.sound(c, oj, False)
    t_ok, t_detail = fam.sound(c, ot, False)
    detail = f"port {t_detail} | jax {j_detail}"
    if j_ok and t_ok:
        jf, tf = bool(oj.get("fail", False)), bool(ot.get("fail", False))
        if jf != tf:
            if jf:
                return "departure", f"JAX flags fail, the port is sound; " \
                    f"{detail}"
            return "port-fault", f"the port flags fail; {detail}"
        if jf:
            return None
        msg = fam.parity(c, oj, ot)
        if msg is None:
            return None
        if msg == "tie":
            return "shared", f"pivots part at a tie of |R_ii| (rounding " \
                f"decides); {detail}"
        if msg.startswith("shared: "):
            return "shared", f"{msg[8:]}; {detail}"
        return "port-fault", f"{msg}; {detail}"
    if not j_ok and not t_ok:
        return "shared", f"both unsound alike; {detail}"
    if t_ok:
        return "departure", f"the port is sound, JAX is not; {detail}"
    return "port-fault", f"the port is unsound, JAX is sound; {detail}"


def run_cpu(seed, trials):
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from randlapack_tpu import RNGState as JRNG

    from _torch_pairs import JaxRNG
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return _loop(seed, trials, False, lambda fam, c, s: _cpu_trial(
        fam, c, s, JRNG, JaxRNG))


def _call(fn, *args):
    try:
        return fn(*args), None
    except Exception as e:  # noqa: BLE001 — each trial reports its own
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _cpu_trial(fam, c, s, JRNG, JaxRNG):
    oj, jerr = _call(fam.jax, c, s)
    ot, terr = _call(fam.port, c, JaxRNG(JRNG(s)), "cpu", torch.float64)
    return classify_cpu(fam, c, oj, ot, jerr, terr)


def run_cuda(seed, trials):
    if not torch.cuda.is_available():
        print("fuzz_torch: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from randlapack_tpu_torch.utils import kernel_checks
    return _loop(seed, trials, True, lambda fam, c, s: _cuda_trial(
        fam, c, s, kernel_checks))


def _cuda_trial(fam, c, s, kernel_checks):
    f32 = torch.float32
    with kernel_checks.Recorder() as rec:
        ocard, cerr = _call(fam.port, c, PortRNG(s), "cuda", f32)
        torch.cuda.synchronize()
    ocpu, perr = _call(fam.port, c, PortRNG(s), "cpu", f32)
    held = [f"{name} {r['max_abs_err']:.2e}"
            + ("" if r["ok"] else f" FAILED ({r['why']})")
            for name, r in rec.hold().items()]
    c["_launches"] = rec.launches
    c["_held"] = held
    bad = [h for h in held if "FAILED" in h]
    if bad:
        return "kernel-fault", "kernel against its plain version: " \
            + "; ".join(bad)
    if perr or cerr:
        if perr and cerr and perr.split(":")[0] == cerr.split(":")[0]:
            return None
        if cerr:
            return "kernel-fault", f"the card raised {cerr} (CPU: " \
                f"{perr or 'ran'})"
        return "shared-f32", f"the CPU raised {perr}; the card ran"
    p_ok, p_detail = fam.sound(c, ocpu, True)
    k_ok, k_detail = fam.sound(c, ocard, True)
    detail = f"card {k_detail} | cpu {p_detail}"
    p_sound = p_ok and not bool(ocpu.get("fail", False))
    k_sound = k_ok and not bool(ocard.get("fail", False))
    if p_sound and not k_sound:
        if not rec.launches:
            # no kernel ran: the card's library calls (cuBLAS, cuSOLVER)
            # against the CPU's, e.g. f32 ``gram_eigh`` (ROADMAP.md §3)
            return "card-library", f"the card run, which launched no " \
                f"kernel, is unsound where the CPU run is sound; {detail}"
        return "kernel-fault", f"the card run is unsound where the CPU " \
            f"run is sound; {detail}"
    if not p_sound and not k_sound:
        return "shared-f32", f"both f32 runs flag or miss the gate; {detail}"
    if not p_sound:
        return "card-sound", f"the card run is sound, the CPU's is not; " \
            f"{detail}"
    return None


def _loop(seed, trials, f32, one):
    rng = random.Random(seed)
    t = Trial(seed, f32)
    counts = defaultdict(Counter)
    faults = 0
    for trial in range(trials):
        kind = rng.choice(FAMILIES)
        scale = rand_scale(rng)
        fam = FAMILY[kind]
        tag = f"t{trial}:{kind}:s{scale:.0e}"
        counts[kind]["trials"] += 1
        try:
            c = fam.build(kind, rng, t, trial, scale)
            tag += c["tag"]
            verdict = one(fam, c, seed + trial)
        except Exception:  # noqa: BLE001 — reported, counted, run goes on
            counts[kind]["exception"] += 1
            faults += 1
            print(f"EXC {tag}", flush=True)
            traceback.print_exc()
            continue
        extra = ""
        if f32:
            extra = (f" launches {c['_launches'] or '{}'}"
                     + (f"; held {', '.join(c['_held'])}" if c["_held"]
                        else ""))
        if verdict is None:
            counts[kind]["ok"] += 1
            print(f"ok {tag}{extra}", flush=True)
            continue
        cls, detail = verdict
        counts[kind][cls] += 1
        faults += cls in ("port-fault", "kernel-fault")
        print(f"DISAGREE [{cls}] {tag}: {detail}{extra}", flush=True)
    print("per family: " + "; ".join(
        f"{k} " + " ".join(f"{c}={v}" for c, v in sorted(counts[k].items()))
        for k in FAMILIES if k in counts), flush=True)
    mode = "cuda f32" if f32 else "cpu f64"
    print(f"DONE seed={seed} trials={trials} mode={mode} faults={faults}",
          flush=True)
    return 1 if faults else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seed", type=int)
    ap.add_argument("trials", type=int)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    a = ap.parse_args(argv)
    if a.device == "cuda":
        return run_cuda(a.seed, a.trials)
    return run_cpu(a.seed, a.trials)


if __name__ == "__main__":
    sys.exit(main())
