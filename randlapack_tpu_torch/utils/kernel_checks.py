"""Each hand-written kernel held against its plain version on given operands
(the card only), by the gates ``chip_smoke.py`` holds it to at the main
path's shapes:

- K1/K2 in "highest": within 1e-4 of the plain version's largest entry;
  their TF32, bf16 and bf16×3 forms within 1e-5;
- K3: its signs exactly and F within 1e-4 (f32) / 1e-10 (f64);
- K5: its pivots exactly; K6: its pivots exactly, W within 1e-4 of its
  largest entry and the taus within 1e-4 of the largest (up to the first
  step whose column cancelled below 1e5·eps of its norm or whose squared
  norm is subnormal: past it the reflectors are rounding in both);
- K4 and K7: within 1e-4 of the largest entry (K4: beyond the rounding
  of the squared distances it shares with its plain version, which is
  all of K where the points' norms are large beside the bandwidth).

On adversarial operands two more rules hold. Where a plain entry is not
finite, the kernel's is not either, and where it is finite the kernel's is
finite and within the gate (the scale is the largest finite plain entry).
And the pivots of K3, K5 and K6 may part from the plain version's only at
a tie that rounding decides: K3's sign where the Schur diagonal is within
its rounding (4·j·eps of the terms that sum to it), K5's and K6's pivot where the two candidates' residual
norms (in f64, after the common earlier pivots) agree to 1e-3 or both lie
at rounding level; past such a tie the rest is not compared.

``Recorder`` keeps the operands of each kernel's first launch during a
run, for ``hold``. Used by ``chip_smoke.py``'s ``[edge]`` phase,
``tools/fuzz_torch.py``'s card mode and ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import torch

FORMS = ("tf32", "bf16", "bf16x3")


def _ops():
    from ..ops import kernels, lu, qr, qrcp, wy
    return kernels, lu, qr, qrcp, wy


def _entrywise(k, p, tol):
    """``(ok, max_abs_err, why)`` for a kernel output against the plain
    one: the finite pattern and the gate on the finite entries."""
    pf, kf = torch.isfinite(p), torch.isfinite(k)
    if not torch.equal(pf, kf):
        return False, float("inf"), (
            f"{int((pf & ~kf).sum())} entries finite in the plain version "
            f"only, {int((kf & ~pf).sum())} in the kernel's only")
    if not bool(pf.any()):
        return True, 0.0, ""
    err = float((k[pf].double() - p[pf].double()).abs().max())
    scale = float(p[pf].double().abs().max())
    ok = err <= tol * scale
    return ok, err, "" if ok else f"max|d| {err:.3e} > {tol:g}·{scale:.3e}"


def _residual_norms(X, prefix, cols):
    """‖(I − QQᵀ)·X[:, c]‖ in f64 for each c in ``cols``, Q an orthonormal
    basis of X[:, prefix]."""
    X = X.double()
    Y = X[:, cols]
    if len(prefix):
        Q = torch.linalg.qr(X[:, prefix])[0]
        Y = Y - Q @ (Q.mT @ Y)
    return torch.linalg.vector_norm(Y, dim=0).tolist()


def _pivot_tie(X, prefix, a, b):
    """Whether columns ``a`` and ``b`` of X tie after ``prefix``."""
    ra, rb = _residual_norms(X, prefix, [a, b])
    level = 1e-5 * float(torch.linalg.vector_norm(X.double(), dim=0).max())
    return abs(ra - rb) <= 1e-3 * max(ra, rb) or max(ra, rb) <= level


def _first_difference(a, b):
    d = torch.nonzero(a != b)
    return None if not len(d) else int(d[0])


def _hold_pivots(X, kp, pp):
    """``(ok, why, agree)``: pivots equal, or parting at a tie of X's
    residual column norms (``agree`` False then: compare no further)."""
    i = _first_difference(kp.cpu(), pp.cpu())
    if i is None:
        return True, "", True
    prefix = pp[:i].cpu().tolist()
    a, b = int(kp[i]), int(pp[i])
    if _pivot_tie(X.cpu(), prefix, a, b):
        return True, f"tie at step {i}", False
    return False, f"pivots part at step {i}: {a} against {b}", False


def hold(name: str, *args, **kwargs) -> dict:
    """Run kernel ``name`` and its plain version on the same operands
    (fresh copies, as K2 works in place). Returns ``ok``,
    ``max_abs_err`` and ``why`` (what failed, or a tie noted)."""
    kernels, lu, qr, qrcp, wy = _ops()
    copy = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    if name in ("masked_vt_a", "a_minus_vz_masked") or \
            name.rsplit("_", 1)[-1] in FORMS:
        form = name.rsplit("_", 1)[-1] if name.rsplit("_", 1)[-1] in FORMS \
            else None
        base = name if form is None else name[:-len(form) - 1]
        tol = 1e-4 if form is None else 1e-5
        if base == "masked_vt_a":
            V, A, mask = copy[:3]
            k = (wy.masked_vt_a(V, A, mask, **kwargs) if form is None
                 else wy.masked_vt_a_form(V, A, mask, form, **kwargs))
            p = getattr(wy, f"masked_vt_a{'_' + form if form else ''}"
                            "_reference")(V, A, mask)
        else:
            A, V, Z, mask = copy[:4]
            p = getattr(wy, f"a_minus_vz_masked{'_' + form if form else ''}"
                            "_reference")(A, V, Z, mask)
            k = (wy.a_minus_vz_masked(A.clone(), V, Z, mask, **kwargs)
                 if form is None else wy.a_minus_vz_masked_form(
                     A.clone(), V, Z, mask, form, **kwargs))
        ok, err, why = _entrywise(k, p, tol)
        return dict(ok=ok, max_abs_err=err, why=why)
    if name == "getrfnp":
        M = copy[0]
        F, s = lu.getrfnp_cuda(M)
        Fp, sp = lu.getrfnp(M)
        j = _first_difference(s, sp)
        tol = 1e-4 if M.dtype == torch.float32 else 1e-10
        if j is not None:
            # the Schur diagonal d_j = M_jj − Σ_k<j L_jk·U_kj, to its
            # rounding (a few j·eps of the terms summed)
            d = float((Fp[j, j] + sp[j]).abs())
            terms = float((Fp[j, :j].abs() * Fp[:j, j].abs()).sum()
                          + M[j, j].abs())
            ok = d <= 4 * max(j, 1) * torch.finfo(M.dtype).eps * terms
            return dict(ok=ok, max_abs_err=float("nan"), why=(
                f"sign tie at step {j} (|d| {d:.2e})" if ok else
                f"signs part at step {j}, |d| {d:.3e} above rounding"))
        ok, err, why = _entrywise(F, Fp, tol)
        return dict(ok=ok, max_abs_err=err, why=why)
    if name == "qrcp_select_pivots":
        Y, nsteps, live = copy[0], copy[1], copy[2]
        kp = qrcp.qrcp_select_pivots_cuda(Y, nsteps, live)
        pp = qr.qrcp_select_pivots(Y, nsteps, live)
        ok, why, _ = _hold_pivots(Y * live[None, :], kp, pp)
        return dict(ok=ok, max_abs_err=0.0 if ok else float("inf"), why=why)
    if name == "qrcp_panel":
        P, row0 = copy[0], copy[1]
        pivot = copy[2] if len(copy) > 2 else kwargs.get("pivot", True)
        W, taus, sigma = qrcp.qrcp_panel_cuda(P, row0, pivot)
        Wp, _, tp, sp = qr.qrcp_panel(P, row0, pivot)
        # a step whose column cancelled to c of its norm has a reflector
        # fixed to about eps/c, so the 1e-4 gate holds while c ≥ 1e5·eps;
        # and one whose residual's squared norm is below the type's normal
        # range sums subnormal squares, with fewer significant bits. W's
        # columns and taus are held up to the first step of either kind
        # (past it the reflectors are rounding in both versions)
        alpha = Wp[row0 + torch.arange(len(sp), device=P.device),
                   torch.arange(len(sp), device=P.device)].double().abs()
        orig = torch.linalg.vector_norm(P[row0:].double(), dim=0)[sp]
        fi = torch.finfo(P.dtype)
        cut = torch.nonzero(torch.isfinite(alpha) & (
            (alpha < 1e5 * fi.eps * orig) | (alpha ** 2 < fi.tiny)))
        r = int(cut[0]) if len(cut) else len(sp)
        ok, why, agree = _hold_pivots(P[row0:], sigma[:r], sp[:r])
        if not agree:
            return dict(ok=ok, max_abs_err=float("nan") if ok
                        else float("inf"), why=why)
        ok, err, why = _entrywise(W[:, :r], Wp[:, :r], 1e-4)
        t_ok, t_err, t_why = _entrywise(taus[:r], tp[:r], 1e-4)
        why = "; ".join(w for w in (why, t_why) if w)
        if r < len(sp):
            why += f"{'; ' if why else ''}held to step {r}, past which " \
                "the columns cancel to rounding or their squares underflow"
        return dict(ok=ok and t_ok, max_abs_err=max(err, t_err), why=why)
    if name == "kernel_matmat":
        X, V, bw = copy[:3]
        k = kernels.kernel_matmat(X, V, bw)
        p = kernels.kernel_matmat_reference(X, V, bw, block=2048)
        # both evaluate d² = ‖x_i‖² + ‖x_j‖² − 2x_iᵀx_j, which rounds by
        # up to δ = 24·eps·(‖x_i‖² + ‖x_j‖²): where the points' norms are
        # large beside the bandwidth, K_ij = exp(−d²/2σ²) is rounding in
        # both. The gate adds what that moves: the largest K over d² − δ
        # times min(1, δ/2σ²), summed against |V|
        Xd, inv = X.double(), 1.0 / (2 * float(bw) ** 2)
        n2 = (Xd ** 2).sum(0)
        delta = 24 * torch.finfo(X.dtype).eps * (n2[:, None] + n2[None, :])
        D2 = torch.cdist(Xd.T, Xd.T,
                         compute_mode="donot_use_mm_for_euclid_dist") ** 2
        slack = (torch.exp(-torch.clamp(D2 - delta, min=0.0) * inv)
                 * torch.clamp(delta * inv, max=1.0)) @ V.double().abs()
        pf = torch.isfinite(p)
        if torch.equal(pf, torch.isfinite(k)) and bool(pf.all()):
            d = (k.double() - p.double()).abs() - slack
            scale = float(p.double().abs().max())
            err = float(d.max())
            ok = err <= 1e-4 * scale
            return dict(ok=ok, max_abs_err=err, why="" if ok else (
                f"max|d| beyond the distances' rounding {err:.3e} > "
                f"1e-4·{scale:.3e}"))
    elif name == "gaussian_sketch":
        A, d, seed = copy[:3]
        k = kernels.gaussian_sketch_cuda(A, d, seed)
        p = kernels.gaussian_sketch_reference(A, d, seed)
    else:
        raise KeyError(f"no kernel check named {name!r}")
    ok, err, why = _entrywise(k, p, 1e-4)
    return dict(ok=ok, max_abs_err=err, why=why)


def launch_counts() -> dict:
    """Every kernel's launch count (all four ``LAUNCHES`` tables)."""
    kernels, lu, qr, qrcp, wy = _ops()
    return {**wy.LAUNCHES, **lu.LAUNCHES, **qrcp.LAUNCHES,
            **kernels.LAUNCHES}


class Recorder:
    """Within ``with Recorder() as rec:``, the operands of each kernel's
    first launch (copies, taken before it runs) and, at exit, the
    launches made (``rec.launches``, the nonzero counts). ``rec.hold()``
    holds each recorded kernel against its plain version."""

    def __init__(self):
        self.calls, self.launches, self._patched = {}, {}, []

    def _wrap(self, module, attr, name_of):
        fn = getattr(module, attr)

        def wrapped(*args, **kwargs):
            name = name_of(args, kwargs)
            if name not in self.calls:
                self.calls[name] = (
                    [a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args],
                    {k: v for k, v in kwargs.items() if k == "pivot"})
            return fn(*args, **kwargs)
        setattr(module, attr, wrapped)
        self._patched.append((module, attr, fn))

    def __enter__(self):
        from .. import pdkernels
        kernels, lu, qr, qrcp, wy = _ops()
        self._before = launch_counts()
        for attr, pos in (("masked_vt_a", 3), ("a_minus_vz_masked", 4)):
            self._wrap(wy, attr, lambda a, kw, n=attr: n)
            # the form is the argument after the operands
            self._wrap(wy, f"{attr}_form", lambda a, kw, n=attr, i=pos: (
                f"{n}_{kw['form'] if 'form' in kw else a[i]}"))
        self._wrap(lu, "getrfnp_cuda", lambda a, kw: "getrfnp")
        self._wrap(qrcp, "qrcp_select_pivots_cuda",
                   lambda a, kw: "qrcp_select_pivots")
        self._wrap(qrcp, "qrcp_panel_cuda", lambda a, kw: "qrcp_panel")
        for mod in (kernels, pdkernels):
            self._wrap(mod, "kernel_matmat", lambda a, kw: "kernel_matmat")
        self._wrap(kernels, "gaussian_sketch_cuda",
                   lambda a, kw: "gaussian_sketch")
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self._patched):
            setattr(module, attr, fn)
        after = launch_counts()
        self.launches = {k: after[k] - self._before.get(k, 0)
                         for k in after if after[k] != self._before.get(k, 0)}
        return False

    def hold(self) -> dict:
        """name → ``hold``'s result on the recorded operands."""
        return {name: hold(name, *args, **kw)
                for name, (args, kw) in self.calls.items()}


# -- adversarial operands ----------------------------------------------------

# the mutators of tools/fuzz_sweep.py (column scales 2^±50, near-duplicate
# columns, a zero and a tiny column, the Kahan structure, global scales) and
# one non-finite entry; K3, K5 and K6 take no non-finite operand (a pivot
# decided on NaN is not defined by the plain version either)
MUTATORS = ("colscale", "neardup", "zerotiny", "kahan", "2^60", "2^-60",
            "1e25", "1e-25", "inf", "nan")
PIVOTING = ("getrfnp", "qrcp_select_pivots", "qrcp_panel")
KERNELS = ("masked_vt_a", "a_minus_vz_masked",
           *(f"{k}_{f}" for f in FORMS
             for k in ("masked_vt_a", "a_minus_vz_masked")),
           "getrfnp", "qrcp_select_pivots", "qrcp_panel", "kernel_matmat",
           "gaussian_sketch")
SCALES = {"2^60": 2.0 ** 60, "2^-60": 2.0 ** -60, "1e25": 1e25,
          "1e-25": 1e-25}


def mutate(X: torch.Tensor, how: str, gen: torch.Generator) -> torch.Tensor:
    """X (f32) under mutator ``how``: per-column scales 2^k, k uniform in
    [−50, 50]; the last third of the columns copies of the first third
    with 1e-5 relative noise (about 100·eps32: the rank collapses just
    above rounding, as tools/fuzz_sweep.py's 1e-9 does in f64); a zero
    column and a column scaled by 1e-30 (its squares underflow); X·K(θ)
    with the Kahan matrix; a global scale; one Inf or NaN entry."""
    from ..gen import kahan_matrix
    m, n = X.shape
    dev = X.device
    if how == "colscale":
        k = torch.randint(-50, 51, (n,), generator=gen, device=dev)
        return X * torch.pow(2.0, k.to(X.dtype))[None, :]
    if how == "neardup":
        kd = max(1, n // 3)
        noise = torch.randn((m, kd), generator=gen, device=dev,
                            dtype=X.dtype)
        X = X.clone()
        X[:, n - kd:] = X[:, :kd] + 1e-5 * noise * X[:, :kd].abs().max()
        return X
    if how == "zerotiny":
        X = X.clone()
        X[:, n // 2] = 0.0
        X[:, max(0, n // 2 - 1)] *= 1e-30
        return X
    if how == "kahan":
        theta = 0.9 + 0.8 * float(torch.rand((), generator=gen,
                                             device=dev))
        return X @ kahan_matrix(n, X.dtype, theta, device=dev)
    if how in SCALES:
        return X * SCALES[how]
    X = X.clone()
    X[m // 3, n // 3] = float(how)
    return X


def operands(name: str, how: str, small: bool, device, seed: int = 0):
    """The operands ``hold(name, *operands)`` takes, f32 on ``device``,
    with the mutator on the kernel's data operand (A for K1, K2 and K7, the
    matrix whose Q gives M for K3, Y for K5, the panel for K6; for K2 also
    Z = Vᵀ·A, which carries A's columns; for K4 a global scale goes on the
    points, an extreme bandwidth, and the rest on V). ``small`` sizes them for a test (256 rows)
    rather than the chip run's 1024."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    f32 = torch.float32
    m = 256 if small else 1024

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=f32)

    def spread(*shape):
        return randn(*shape) * torch.exp(-3 * torch.rand(
            shape[1], generator=gen, device=device))[None, :]

    base = name.rsplit("_", 1)[0] if name.rsplit("_", 1)[-1] in FORMS \
        else name
    if base == "masked_vt_a":
        b = m // 8
        mask = (torch.rand(m, generator=gen, device=device) < 0.6).to(f32)
        return (randn(m, b) / m ** 0.5, mutate(randn(m, m), how, gen), mask)
    if base == "a_minus_vz_masked":
        k = m // 8
        V = randn(m, k) / m ** 0.5
        A = mutate(randn(m, m), how, gen)
        mask = (torch.rand(m, generator=gen, device=device) < 0.6).to(f32)
        return (A, V, (V.T @ A).contiguous(), mask)
    if name == "getrfnp":
        # K3's operand is always the top block of an orthonormal Q (the
        # Q1 of orhr_col, ops/householder.py), so the mutator acts on the
        # matrix whose Q it is: a global scale leaves Q as it is, column
        # scales, near-duplicate, zero and Kahan columns reach it
        k = m // 8
        Q = torch.linalg.qr(mutate(randn(2 * k, k), how, gen).double())[0]
        return (Q[:k].to(f32).contiguous(),)
    if name == "qrcp_select_pivots":
        n = m
        live = torch.ones(n, dtype=f32, device=device)
        live[torch.randperm(n, generator=gen, device=device)[:n // 8]] = 0
        return (mutate(spread(74, n), how, gen).contiguous(), 32, live)
    if name == "qrcp_panel":
        return (mutate(spread(m, 64), how, gen).contiguous(), m // 5)
    if name == "kernel_matmat":
        n = 4 * m
        X, V = randn(8, n), randn(n, 4)
        if how in SCALES:     # the points scaled: an extreme bandwidth
            return (X * SCALES[how], V, 3.8)
        return (X, mutate(V, how, gen).contiguous(), 3.8)
    if name == "gaussian_sketch":
        return (mutate(randn(4 * m, m // 4), how, gen).contiguous(), 80, 11)
    raise KeyError(f"no kernel named {name!r}")


def cases():
    """Every (kernel, mutator) pair of the edge sweep."""
    return [(k, how) for k in KERNELS for how in MUTATORS
            if not (k in PIVOTING and how in ("inf", "nan"))]
