"""Parity of the PyTorch port's dense ops (randlapack_tpu_torch) with the
JAX package on the CPU in f64: the same numpy inputs go through both.

Tolerances: bitwise where the JAX code promises bitwise behaviour (the
pow2 guards), exact for pivot orders, and 1e-12 relative for the CholQR
family (summation order differs between MKL and XLA's CPU dot; the
Cholesky/solve chain keeps that at a few ulps times the condition number
of these well-conditioned inputs)."""
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randlapack_tpu.drivers import BQRRPConfig as JCfg

import randlapack_tpu_torch as rt
from randlapack_tpu_torch import config as tconfig
from randlapack_tpu_torch.drivers import BQRRPConfig
from randlapack_tpu_torch.errors import RandLAPACKError

# the packages' __init__ files export functions that shadow some module
# names (ops.cholqr, drivers.bqrrp), so modules are fetched by path
jbq = importlib.import_module("randlapack_tpu.drivers.bqrrp")
jchol = importlib.import_module("randlapack_tpu.ops.cholqr")
jqr = importlib.import_module("randlapack_tpu.ops.qr")
jutil = importlib.import_module("randlapack_tpu.ops.util")
tbq = importlib.import_module("randlapack_tpu_torch.drivers.bqrrp")
tchol = importlib.import_module("randlapack_tpu_torch.ops.cholqr")
tqr = importlib.import_module("randlapack_tpu_torch.ops.qr")
tutil = importlib.import_module("randlapack_tpu_torch.ops.util")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return np.asarray(x)


def _bits(x):
    x = _np(x)
    return x.view(np.uint64 if x.dtype == np.float64 else np.uint32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# -- the package stands alone ----------------------------------------------

def test_package_imports_without_cuda_nvcc_or_jax():
    """Every module imports with no CUDA device, no nvcc and no JAX: the
    kernel build is imported only inside CUDA branches."""
    code = (
        "import sys, pkgutil, importlib, randlapack_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if m.name != 'randlapack_tpu_torch._build':\n"
        "        importlib.import_module(m.name)\n"
        "assert 'randlapack_tpu_torch._build' not in sys.modules\n"
        "assert not any(k in ('jax', 'randlapack_tpu')"
        " or k.startswith(('jax.', 'randlapack_tpu.')) for k in sys.modules),"
        " 'the port imported jax'\n"
        "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PATH="/usr/bin:/bin")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- config / rng ------------------------------------------------------------

def _public_functions(module):
    """name → the plain function behind each public module-level callable
    defined in ``module`` (jit wrappers unwrapped)."""
    import inspect
    out = {}
    for name, obj in vars(module).items():
        f = inspect.unwrap(obj) if callable(obj) else obj
        if (not name.startswith("_") and inspect.isfunction(f)
                and f.__module__ == module.__name__):
            out[name] = f
    return out


def test_signatures_lead_with_the_jax_parameters():
    """Every public module-level function of the port whose JAX
    counterpart (same module path, same name) exists takes JAX's
    parameters first, in JAX's positions, so positional callers see the
    same function; the port's own parameters (``sketch``, ``omegas``,
    ``noise``, ``device``) come after. ``ops/pallas_*`` (their kernels'
    tests cover them, and they carry JAX-only parameters) are out of
    scope."""
    import inspect
    import pkgutil

    import randlapack_tpu
    drift, pairs = [], 0
    for info in pkgutil.walk_packages(rt.__path__, "randlapack_tpu_torch."):
        rel = info.name.removeprefix("randlapack_tpu_torch.")
        if rel.startswith("ops.pallas_"):
            continue
        jname = "randlapack_tpu." + rel
        if importlib.util.find_spec(jname) is None:
            continue
        jfns = _public_functions(importlib.import_module(jname))
        tfns = _public_functions(importlib.import_module(info.name))
        for name in sorted(jfns.keys() & tfns.keys()):
            pairs += 1
            pj = list(inspect.signature(jfns[name]).parameters)
            pt = list(inspect.signature(tfns[name]).parameters)
            if pt[:len(pj)] != pj:
                drift.append(f"{rel}.{name}: JAX {pj}, port {pt}")
    assert randlapack_tpu.__name__ == "randlapack_tpu"
    assert pairs > 100, pairs
    assert not drift, "\n".join(drift)


def test_tf32_policy_enforced():
    tconfig.require_fp32_matmul()
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RandLAPACKError):
            tconfig.require_fp32_matmul()
    finally:
        torch.set_float32_matmul_precision(prev)


def test_rng_state_spawn_and_branch():
    st = rt.RNGState(7)
    g1, st1 = st.spawn("cpu")
    g1b, _ = rt.RNGState(7).spawn("cpu")
    assert st1.counter == 1 and st.counter == 0
    a = torch.randn(64, generator=g1, dtype=torch.float64)
    assert torch.equal(a, torch.randn(64, generator=g1b,
                                      dtype=torch.float64))
    g2, _ = st1.spawn("cpu")
    assert not torch.equal(a, torch.randn(64, generator=g2,
                                          dtype=torch.float64))
    gb, _ = st.branch(1).spawn("cpu")
    gb2, _ = st.branch(2).spawn("cpu")
    xb = torch.randn(64, generator=gb, dtype=torch.float64)
    assert not torch.equal(a, xb)
    assert not torch.equal(xb, torch.randn(64, generator=gb2,
                                           dtype=torch.float64))
    assert rt.as_state(3).key == 3 and rt.as_state(st) is st


def test_fast_decay_matrix():
    A, st = rt.gen.fast_decay_matrix(96, 64, rt.RNGState(0),
                                     dtype=torch.float64, device="cpu")
    A2, _ = rt.gen.fast_decay_matrix(96, 64, rt.RNGState(0),
                                     dtype=torch.float64, device="cpu")
    assert A.shape == (96, 64) and st.counter == 2
    assert torch.equal(A, A2) and torch.isfinite(A).all()
    s = torch.linalg.svdvals(A)
    # spectrum ~ e^{-6 i/k}: the last singular value sits orders below the
    # first (Gaussian factors blur the exact profile)
    assert float(s[-1] / s[0]) < 1e-2


# -- pow2 guards: bitwise ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pow2_bitwise(dtype):
    ks = np.arange(-1100, 1100, 7, dtype=np.int32)
    j = jchol._pow2(jnp.asarray(ks), jnp.dtype(dtype))
    t = tchol._pow2(torch.tensor(ks), getattr(torch, dtype))
    np.testing.assert_array_equal(_bits(j), _bits(t))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["healthy", "tiny", "huge", "nonfinite",
                                  "zero"])
def test_finite_scaled_bitwise(dtype, case):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((40, 12)).astype(dtype)
    if case == "tiny":
        A *= np.asarray(2.0 ** -70, dtype) * 1.37
    elif case == "huge":
        A *= np.asarray(1e15 if dtype == "float32" else 1e150, dtype)
    elif case == "nonfinite":
        A[3, 4], A[7, 1] = np.inf, np.nan
    elif case == "zero":
        A[:] = 0.0
    Aj, sj, nj = jchol._finite_scaled(jnp.asarray(A))
    At, st, nt = tchol._finite_scaled(torch.tensor(A))
    np.testing.assert_array_equal(_bits(Aj), _bits(At))
    assert _np(sj) == st.item() and bool(nj) == bool(nt)


@pytest.mark.parametrize("case", ["healthy", "deficient", "zero"])
def test_safe_triu_diag(case):
    rng = np.random.default_rng(3)
    R = np.triu(rng.standard_normal((8, 8)))
    if case == "deficient":
        R[2, 2], R[5, 5] = 0.0, 1e-300
    elif case == "zero":
        R[:] = 0.0
    np.testing.assert_array_equal(
        _np(jbq._safe_triu_diag(jnp.asarray(R), jnp.float64)),
        tbq._safe_triu_diag(torch.tensor(R)).numpy())


def test_naive_rank_est():
    d = np.array([5.0, 3.0, 1e-3, 2.0, 1e-9])
    assert int(jutil.naive_rank_est(jnp.asarray(d), 1e-2)) == int(
        tutil.naive_rank_est(torch.tensor(d), 1e-2)) == 2


# -- CholQR family: 1e-12 relative -----------------------------------------

def _tall(m, n, cond, seed):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((m, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return (U * np.logspace(0, -np.log10(cond), n)) @ V.T


# one CholQR pass moves Q by ~eps·κ² under a change of summation order
# (measured 2e-10 at κ = 1e4), the two-pass forms by ~eps·κ (4e-13), so
# each runs where 1e-12 holds with a margin
@pytest.mark.parametrize("name,cond", [
    ("cholqr", 1e2), ("cholqr2", 1e2), ("shifted_cholqr3", 1e2),
    ("cholqr2", 1e4), ("shifted_cholqr3", 1e4)])
def test_cholqr_family_parity(name, cond):
    A = _tall(120, 24, cond, 4)
    Qj, Rj, fj = getattr(jchol, name)(jnp.asarray(A))
    Qt, Rt, ft = getattr(tchol, name)(torch.tensor(A))
    assert bool(fj) == bool(ft) is False
    assert _rel(Qt, Qj) < 1e-12 and _rel(Rt, Rj) < 1e-12


def test_cholqr_breakdown_flag_parity():
    A = _tall(80, 16, 1e12, 5)      # Gram numerically indefinite
    _, _, fj = jchol.cholqr(jnp.asarray(A))
    Qt, _, ft = tchol.cholqr(torch.tensor(A))
    assert bool(fj) and bool(ft)


def test_preconditioned_cholqr_parity():
    A = _tall(150, 20, 1e4, 6)     # measured 2.3e-13 (2.4e-9 at κ = 1e8)
    rng = np.random.default_rng(6)
    R_pre = np.linalg.qr(rng.standard_normal((30, 150)) @ A, mode="r")
    Qj, Rj, fj = jchol.preconditioned_cholqr(jnp.asarray(A),
                                             jnp.asarray(R_pre))
    Qt, Rt, ft = tchol.preconditioned_cholqr(torch.tensor(A),
                                             torch.tensor(R_pre))
    assert bool(fj) == bool(ft) is False
    assert _rel(Qt, Qj) < 1e-12 and _rel(Rt, Rj) < 1e-12


def test_qr_econ_parity():
    A = np.random.default_rng(7).standard_normal((50, 12))
    Qj, Rj = jqr.qr_econ(jnp.asarray(A))
    Qt, Rt = tqr.qr_econ(torch.tensor(A))
    assert _rel(Qt, Qj) < 1e-12 and _rel(Rt, Rj) < 1e-12


# -- pivots: exactly equal -------------------------------------------------

# lu_pivot_columns's exact parity and _sanitize_sketch's bitwise parity are
# cases of tests/test_torch_edge_cases.py::test_inf_sanitization

@pytest.mark.parametrize("cand", [2, None])
def test_select_pivots_ties_exact(cand):
    """Exact norm ties in the candidate preselection: the port's stable
    descending sort must keep JAX top_k's lower-index-first order."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal((10, 6))
    Y = np.concatenate([base, base[:, ::-1], base[:, [1, 0, 3, 2, 5, 4]],
                        -base], axis=1)           # 4 copies of each norm
    Y[:, 5] *= 7.0                                # one clear winner
    b = 4
    retired = np.zeros(Y.shape[1])
    cj = jbq._select_pivots(jnp.asarray(Y), b, jnp.asarray(retired),
                            JCfg(block_size=b, pivot_candidates=cand),
                            jnp.float64, jax.lax.Precision.HIGHEST)
    ct = tbq._select_pivots(torch.tensor(Y), b,
                            BQRRPConfig(block_size=b,
                                        pivot_candidates=cand))
    np.testing.assert_array_equal(_np(cj), ct.numpy())


@pytest.mark.parametrize("chosen,retired_idx", [
    ([3, 1, 4, 0], []),                 # healthy
    ([3, 3, 4, 1], [4]),                # duplicate + retired pick
    ([2, 2, 2, 2], [0, 1, 2]),          # every pick invalid
])
def test_fix_pivots_exact(chosen, retired_idx):
    retired = np.zeros(9)
    retired[retired_idx] = 1.0
    fj = jbq._fix_pivots(jnp.asarray(chosen, jnp.int32),
                         jnp.asarray(retired))
    ft = tbq._fix_pivots(torch.tensor(chosen), torch.tensor(retired))
    np.testing.assert_array_equal(_np(fj), ft.numpy())
    assert len(set(ft.tolist())) == len(chosen)
    assert not set(ft.tolist()) & set(retired_idx)


# -- lu_factor: cuSOLVER's getrf on the card, lu_factor_ex on the CPU -------------

def test_lu_factor_on_the_cpu_is_lu_factor_ex_and_switches_nothing():
    """The CPU path is lu_factor_ex itself; the module never sets the
    process-wide backend (it reads it, for a caller's choice to stand)."""
    import inspect
    A = torch.tensor(np.random.default_rng(9).standard_normal((30, 12)))
    for got, want in zip(tqr.lu_factor(A), torch.linalg.lu_factor_ex(A)):
        assert torch.equal(got, want)
    src = inspect.getsource(tqr)
    assert "preferred_linalg_library(" not in src
    assert "_LinalgBackend.Default" in src


@pytest.mark.parametrize("shape", [(12, 5), (6, 6), (5, 12), (1, 4), (4, 1)])
def test_lu_factor_backward_is_the_library_gradient(shape):
    """ops.qr.lu_factor_backward, the card binding's backward, against
    autograd through lu_factor_ex on the CPU (tall, square and wide)."""
    rng = np.random.default_rng(sum(shape))
    A = torch.tensor(rng.standard_normal(shape), requires_grad=True)
    G = torch.tensor(rng.standard_normal(shape))
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    (LU * G).sum().backward()
    got = tqr.lu_factor_backward(LU.detach(), piv, G)
    assert _rel(got, A.grad) < 1e-12
