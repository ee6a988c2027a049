"""Rank bodies of the distributed layer's CPU tests
(``tests/test_torch_parallel*.py``), run by ``parallel.run_ranks`` in
spawned processes. They import only torch, numpy and the port: a spawned
rank has neither the tests' conftest nor JAX.

Each body takes the whole inputs as numpy arrays, puts this rank's rows
on its mesh and returns numpy results: row-sharded outputs as the rank's
rows (the test stacks them in rank order), replicated ones as they are
(the test checks that every rank holds the same bits).
"""
import numpy as np
import torch

from randlapack_tpu_torch import RNGState
from randlapack_tpu_torch.drivers import (ABRIKConfig, BQRRPConfig,
                                          HQRRPConfig, PanelQR, abrik,
                                          bqrrp, bqrrp_apply_qt,
                                          bqrrp_factored, bqrrp_q, hqrrp,
                                          hqrrp_lapack_format)
from randlapack_tpu_torch.ops.cholqr import _finite_scaled, cholqr2
from randlapack_tpu_torch.parallel import (DistSquaredExpKernelLinOp,
                                           dist_abrik, dist_bqrrp,
                                           dist_bqrrp_factored, dist_cholqr,
                                           dist_cqrrpt, dist_cqrrt,
                                           dist_gram, dist_hqrrp,
                                           dist_krill,
                                           dist_rangefinder_step, dist_revd2,
                                           dist_rsvd, dist_shifted_cholqr3,
                                           dist_sketch_left, dist_spls,
                                           row_sharded, set_mesh)
from randlapack_tpu_torch.parallel.tsqr import _band_guard_local


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rows(mesh, X):
    return row_sharded(mesh).put(_t(X))


def _cols(mesh, S):
    """This rank's column block of S (the columns matching its rows)."""
    r0, r1 = mesh.rows(S.shape[1] // mesh.size)
    return _t(S[:, r0:r1])


def ops_body(mesh, A, A_ill, S, Om, guards):
    """tsqr.py and distributed.py on the inputs of tests/test_parallel.py,
    and both band guards (with dist_cholqr) on each of ``guards``."""
    As = _rows(mesh, A)
    out = {"gram": dist_gram(As, mesh)}
    for passes in (1, 2):
        out[f"cholqr{passes}"] = dist_cholqr(As, mesh, passes=passes)
    out["scholqr3"] = dist_shifted_cholqr3(_rows(mesh, A_ill), mesh)
    out["sketch_left"] = dist_sketch_left(_cols(mesh, S), As, mesh)
    out["rangefinder"] = dist_rangefinder_step(As, _t(Om), mesh)
    if mesh.size == 1:
        out["cholqr2_single"] = cholqr2(_t(A))
    for tag, X in guards.items():
        Xs = _rows(mesh, X)
        _, s, nf = _band_guard_local(Xs, mesh)
        _, sg, nfg = _finite_scaled(Xs, mesh, X.shape[0])
        out[f"guard_{tag}"] = (s, nf, sg, nfg)
        out[f"cholqr_{tag}"] = dist_cholqr(Xs, mesh)
    return out


def failing_body(mesh):
    if mesh.rank == 1:
        raise ArithmeticError("rank 1 stops here")
    return mesh.rank


def hanging_body(mesh):
    """Rank 0 waits in a psum that rank 1 never joins."""
    if mesh.rank == 0:
        mesh.psum(torch.ones(4))
    else:
        import time
        time.sleep(60)
    return mesh.rank


def drivers_body(mesh, inp):
    """Every distributed driver but BQRRP on the inputs the test drew,
    the JAX draws injected."""
    out = {}
    c = inp["cqrrpt"]
    out["cqrrpt"] = dist_cqrrpt(_rows(mesh, c["A"]), mesh, RNGState(21),
                                sketch=_cols(mesh, c["S"]))[:5]
    c = inp["cqrrt"]
    out["cqrrt"] = dist_cqrrt(_rows(mesh, c["A"]), mesh, RNGState(32),
                              sketch=_cols(mesh, c["S"]))[:3]
    c = inp["rsvd"]
    out["rsvd"] = dist_rsvd(_rows(mesh, c["A"]), 16, mesh, RNGState(23),
                            omega=_t(c["Om"]))[:4]
    c = inp["revd2"]
    out["revd2"] = dist_revd2(_rows(mesh, c["A"]), c["k"], mesh,
                              RNGState(42), omega=_t(c["Om"]),
                              v0=_t(c["v0"]))[:5]
    for bw, c in inp["revd2_f32"].items():
        out[f"revd2_f32_{bw}"] = dist_revd2(
            _rows(mesh, c["A"]), c["k"], mesh, RNGState(42),
            omega=_t(c["Om"]), v0=_t(c["v0"]))[4]
    for tag, c in inp["spls"].items():
        x, hist, it, st = dist_spls(
            _rows(mesh, c["A"]), _rows(mesh, c["b"]), c["mu"], mesh,
            RNGState(c["seed"]), tol=1e-12, max_iters=100,
            sketch=_cols(mesh, c["S"]))
        out[f"spls_{tag}"] = (x, it, st.counter)
    c = inp["kernel"]
    G = DistSquaredExpKernelLinOp(_t(c["X"]), 2.0, 1e-2, mesh)
    out["kernel"] = G.matmat(_t(c["V"]))
    c = inp["krill"]
    X, hist, it, _ = dist_krill(_t(c["X"]), c["bw"], 1e-2, _t(c["H"]),
                                mesh, RNGState(9), k=64, rpchol_block=32,
                                tol=1e-8, max_iters=100,
                                noise=_t(c["noise"]))
    out["krill"] = (X, it)
    # undrawn sketches: each rank generates its own columns of one operator
    out["cqrrpt_drawn"] = dist_cqrrpt(_rows(mesh, inp["cqrrpt"]["A"]), mesh,
                                      RNGState(5))[:3]
    return out


def bqrrp_body(mesh, cases):
    """dist_bqrrp_factored (and bqrrp_q, bqrrp_apply_qt on its factors)
    for each case, the JAX sketch's column block injected; at one rank
    also the unsharded driver on the same inputs."""
    out = {}
    for tag, c in cases.items():
        As = _rows(mesh, c["A"])
        kw = c["kw"]
        fac, st = dist_bqrrp_factored(As, mesh, RNGState(c["seed"]),
                                      sketch=_cols(mesh, c["S"]), **kw)
        Q = bqrrp_q(fac, mesh=mesh)
        Qt = bqrrp_q(fac, method="tree", mesh=mesh)
        QtA = bqrrp_apply_qt(fac, As.index_select(1, fac.J), mesh=mesh)
        out[tag] = dict(V=fac.V, T=fac.T, R=fac.R, J=fac.J, rank=fac.rank,
                        fail=fac.fail, Q=Q, Qt=Qt, QtA=QtA,
                        counter=st.counter)
        if mesh.size == 1:
            f1, _ = bqrrp_factored(_t(c["A"]), BQRRPConfig(**kw),
                                   RNGState(c["seed"]), sketch=_t(c["S"]))
            out[tag]["single"] = dict(V=f1.V, T=f1.T, R=f1.R, J=f1.J)
    # an undrawn sketch: the unsharded driver's draw, sliced
    c = cases["straddle"]
    fac, _ = dist_bqrrp_factored(_rows(mesh, c["A"]), mesh, RNGState(7),
                                 **c["kw"])
    out["drawn"] = dict(R=fac.R, J=fac.J)
    # the row-sharded mode with the options dist_bqrrp_factored leaves at
    # their defaults: deferred updates, candidate preselection, a
    # trailing-precision form
    for tag, tp in (("defer2", "highest"), ("defer2_bf16x3", "bf16_3x_emul")):
        cfg = BQRRPConfig(block_size=32, update_defer=2, pivot_candidates=2,
                          trailing_precision=tp, shard_axis="rows")
        with set_mesh(mesh):
            fac, _ = bqrrp_factored(_rows(mesh, c["A"]), cfg, RNGState(7),
                                    sketch=_cols(mesh, c["S"]))
        out[tag] = dict(R=fac.R, J=fac.J, V=fac.V)
    return out


def refusals_body(mesh):
    """What a rank must refuse: rows that do not split evenly, shard_axis
    with no mesh set, a mesh axis the config does not name (each driver
    with a row-sharded mode)."""
    def raises(fn):
        try:
            fn()
        except (ValueError, NotImplementedError, RuntimeError) as e:
            return type(e).__name__ + ": " + str(e)
        return None

    A = torch.randn(8 + mesh.rank, 4, dtype=torch.float64)
    calls = {
        "": lambda a: bqrrp_factored(a, BQRRPConfig(
            block_size=2, shard_axis="rows"), RNGState(0)),
        "_bqrrp": lambda a: bqrrp(a, BQRRPConfig(
            block_size=2, shard_axis="rows"), RNGState(0)),
        "_hqrrp": lambda a: hqrrp(a, HQRRPConfig(
            block_size=2, shard_axis="rows"), RNGState(0)),
        "_hqrrp_lapack_format": lambda a: hqrrp_lapack_format(
            a, HQRRPConfig(block_size=2, shard_axis="rows"), RNGState(0)),
        "_abrik": lambda a: abrik(a, 2, ABRIKConfig(
            block_size=2, max_iters=2, shard_axis="rows"), RNGState(0)),
    }
    out = {
        "uneven": raises(lambda: dist_gram(A, mesh)),
        "uneven_put": raises(lambda: row_sharded(mesh).put(
            torch.zeros(4 * mesh.size + 1, 3))),
    }
    for tag, call in calls.items():
        out["no_mesh" + tag] = raises(lambda: call(A[:8]))
        out["other_axis" + tag] = raises(
            lambda: _with_other_axis(mesh, A[:8], call))
    return out


def _with_other_axis(mesh, A, call):
    import dataclasses
    other = dataclasses.replace(mesh, axis="cols")
    with set_mesh(other):
        return call(A)


def rescue_body(mesh, A, S, kw):
    """The sharded BQRRP on an input whose panels take the rescue ladder."""
    fac, _ = dist_bqrrp_factored(_rows(mesh, A), mesh, RNGState(3),
                                 sketch=_cols(mesh, S), **kw)
    return dict(R=fac.R, J=fac.J, fail=fac.fail)


def _launches():
    from randlapack_tpu_torch.ops import lu, qrcp, wy
    return {**wy.LAUNCHES, **lu.LAUNCHES, **qrcp.LAUNCHES}


def _reset_launches():
    from randlapack_tpu_torch.ops import lu, qrcp, wy
    for counts in (wy.LAUNCHES, lu.LAUNCHES, qrcp.LAUNCHES):
        for name in counts:
            counts[name] = 0


def cuda_bqrrp_body(mesh, m, n, b):
    """dist_bqrrp_factored of an m×n f32 fast-decay matrix on the card:
    this rank's launches, the residual and orthogonality (norms psummed,
    in f64) and the replicated R and J."""
    from randlapack_tpu_torch.gen import fast_decay_matrix
    torch.backends.cuda.matmul.allow_tf32 = False
    A, st = fast_decay_matrix(m, n, RNGState(0), device=mesh.device)
    As = row_sharded(mesh).put(A)
    _reset_launches()
    fac, _ = dist_bqrrp_factored(As, mesh, st, block_size=b)
    torch.cuda.synchronize()
    counts = _launches()
    Q = bqrrp_q(fac, mesh=mesh).double()
    E = Q @ fac.R.double() - As.index_select(1, fac.J).double()
    sums = mesh.psum(torch.stack([(E * E).sum(),
                                  (As.double() ** 2).sum()]))
    G = mesh.psum(Q.T @ Q)
    orth = torch.linalg.norm(G - torch.eye(n, dtype=G.dtype,
                                           device=G.device))
    return dict(counts=counts, res=float(torch.sqrt(sums[0] / sums[1])),
                orth=float(orth), fail=bool(fac.fail), R=fac.R, J=fac.J)


def cuda_cholqr_body(mesh, m, n):
    """dist_cholqr (passes 2) of an m×n Gaussian matrix on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=mesh.device).manual_seed(5)
    A = torch.randn((m, n), generator=g, device=mesh.device)
    As = row_sharded(mesh).put(A)
    Q, R, fail = dist_cholqr(As, mesh)
    E = (Q.double() @ R.double() - As.double())
    sums = mesh.psum(torch.stack([(E * E).sum(),
                                  (As.double() ** 2).sum()]))
    G = mesh.psum(Q.double().T @ Q.double())
    return dict(res=float(torch.sqrt(sums[0] / sums[1])),
                orth=float(torch.linalg.norm(G - torch.eye(
                    n, dtype=G.dtype, device=G.device))),
                fail=bool(fail), backend=torch.distributed.get_backend())


def _abrik_sketches(mesh, sk):
    """ABRIK's injected sketches on this rank: the m-side ones (i = 0 and
    every odd i) as its column block, the n-side ones whole."""
    if sk is None:
        return None
    return [None if S is None else _cols(mesh, S) if i == 0 or i % 2
            else _t(S) for i, S in enumerate(sk)]


def qr_body(mesh, cases):
    """The row-sharded explicit BQRRP, HQRRP (with hqrrp_lapack_format)
    and ABRIK on each case, JAX's draws injected; each driver once more
    with the draws left to the port; at one rank also the unsharded
    driver on the whole inputs."""
    out = {}
    one = mesh.size == 1
    for tag, c in cases["bqrrp"].items():
        As, kw = _rows(mesh, c["A"]), c["kw"]
        st, S = RNGState(c["seed"]), _cols(mesh, c["S"])
        if set(kw) <= {"block_size", "stages"}:
            res = dist_bqrrp(As, mesh, st, sketch=S, **kw)
        else:
            with set_mesh(mesh):
                res = bqrrp(As, BQRRPConfig(shard_axis="rows", **kw), st,
                            sketch=S)
        keys = ("Q", "R", "J", "rank", "fail")
        out[tag] = dict(zip(keys, res), counter=res[5].counter)
        if one:
            res1 = bqrrp(_t(c["A"]), BQRRPConfig(**kw), RNGState(c["seed"]),
                         sketch=_t(c["S"]))
            out[tag]["single"] = dict(zip(keys, res1))
    for tag, c in cases["hqrrp"].items():
        As, st, G = _rows(mesh, c["A"]), RNGState(c["seed"]), c["G"]
        panel = PanelQR(c["panel"])
        cfg = HQRRPConfig(block_size=c["b"], panel_qr=panel)
        if panel == PanelQR.qrcp:
            res = dist_hqrrp(As, mesh, st, block_size=c["b"],
                             sketch=_cols(mesh, G))
        else:
            with set_mesh(mesh):
                res = hqrrp(As, HQRRPConfig(block_size=c["b"],
                                            panel_qr=panel,
                                            shard_axis="rows"), st,
                            sketch=_cols(mesh, G))
        with set_mesh(mesh):
            lap = hqrrp_lapack_format(
                As, HQRRPConfig(block_size=c["b"], panel_qr=panel,
                                shard_axis="rows"), st,
                sketch=_cols(mesh, G))
        keys = ("Q", "R", "J", "rank", "fail")
        out[tag] = dict(zip(keys, res), counter=res[5].counter,
                        packed=lap[0], taus=lap[1])
        if one:
            res1 = hqrrp(_t(c["A"]), cfg, RNGState(c["seed"]),
                         sketch=_t(G))
            lap1 = hqrrp_lapack_format(_t(c["A"]), cfg, RNGState(c["seed"]),
                                       sketch=_t(G))
            out[tag]["single"] = dict(zip(keys, res1), packed=lap1[0],
                                      taus=lap1[1])
    for tag, c in cases["abrik"].items():
        As, st, kw = _rows(mesh, c["A"]), RNGState(c["seed"]), c["kw"]
        v0, sk = _t(c["v0"]), _abrik_sketches(mesh, c["sk"])
        if kw.get("qr_explicit") == "cqrrt" and not c["tol"]:
            res = dist_abrik(As, c["k"], mesh, st, block_size=kw[
                "block_size"], max_iters=kw["max_iters"], v0=v0,
                qr_sketches=sk)
        else:
            with set_mesh(mesh):
                res = abrik(As, c["k"], ABRIKConfig(shard_axis="rows", **kw),
                            st, tol=c["tol"], v0=v0, qr_sketches=sk)
        U, S, Vt, info, st2 = res
        out[tag] = dict(U=U, S=S, Vt=Vt, iters=info["num_krylov_iters"],
                        capture=info["capture"], counter=st2.counter)
        if one:
            U1, S1, Vt1, info1, _ = abrik(
                _t(c["A"]), c["k"], ABRIKConfig(**kw), RNGState(c["seed"]),
                tol=c["tol"], v0=v0, qr_sketches=c["sk"] and [
                    None if x is None else _t(x) for x in c["sk"]])
            out[tag]["single"] = dict(U=U1, S=S1, Vt=Vt1,
                                      capture=info1["capture"])
    # the draws left to the port: the sketch / G / m-side sketches drawn
    # whole and sliced on every rank
    c = cases["bqrrp"]["straddle"]
    res = dist_bqrrp(_rows(mesh, c["A"]), mesh, RNGState(5), block_size=32)
    out["drawn_bqrrp"] = dict(R=res[1], J=res[2])
    c = cases["hqrrp"]["straddle_cholqr"]
    with set_mesh(mesh):
        res = hqrrp(_rows(mesh, c["A"]), HQRRPConfig(
            block_size=32, panel_qr=PanelQR.cholqr, shard_axis="rows"),
            RNGState(5))
    out["drawn_hqrrp"] = dict(R=res[1], J=res[2])
    c = cases["abrik"]["cqrrt"]
    res = dist_abrik(_rows(mesh, c["A"]), c["k"], mesh, RNGState(5),
                     block_size=16, max_iters=4)
    out["drawn_abrik"] = dict(S=res[1], Vt=res[2])
    return out


def cuda_qr_body(mesh, entry, A, sketch):
    """One row-sharded QR entry on the card (A and the injected sketch or
    G whole, as numpy; its dtype is A's): this rank's launches, Q's rows,
    R, J and fail. "bqrrp_high" is the explicit BQRRP at b 64 in the
    "high" trailing mode, "hqrrp" / "hqrrp_cholqr" HQRRP at b 32 with
    Householder / CholQR panels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    As, S = _rows(mesh, A), _cols(mesh, sketch)
    _reset_launches()
    if entry == "bqrrp_high":
        cfg = BQRRPConfig(block_size=64, trailing_precision="high",
                          shard_axis="rows")
        with set_mesh(mesh):
            Q, R, J, _, fail, _ = bqrrp(As, cfg, RNGState(3), sketch=S)
    elif entry == "hqrrp":
        Q, R, J, _, fail, _ = dist_hqrrp(As, mesh, RNGState(3),
                                         block_size=32, sketch=S)
    else:
        cfg = HQRRPConfig(block_size=32, panel_qr=PanelQR.cholqr,
                          shard_axis="rows")
        with set_mesh(mesh):
            Q, R, J, _, fail, _ = hqrrp(As, cfg, RNGState(3), sketch=S)
    torch.cuda.synchronize()
    return dict(counts=_launches(), Q=Q, R=R, J=J, fail=fail)


def cuda_abrik_body(mesh, A, v0, sk):
    """dist_abrik (k 12, b 16, q 4) on the card with the draws injected:
    this rank's launches, U's rows, S and Vt."""
    _reset_launches()
    U, S, Vt, info, _ = dist_abrik(_rows(mesh, A), 12, mesh, RNGState(8),
                                   block_size=16, max_iters=4, v0=_t(v0),
                                   qr_sketches=_abrik_sketches(mesh, sk))
    torch.cuda.synchronize()
    return dict(counts=_launches(), U=U, S=S, Vt=Vt,
                iters=info["num_krylov_iters"])


def sweep_body(mesh, trials):
    """tests/test_torch_property_sweeps.py's distributed grid: each trial on
    a mesh of its own ``p`` ranks (a subgroup of this spawn's, made by
    every rank), JAX's draws injected. Returns one result a trial (None
    on the ranks past its ``p``)."""
    from randlapack_tpu_torch.parallel.mesh import make_mesh
    out = []
    for c in trials:
        sub = make_mesh(c["p"], device=mesh.device.type)
        if sub is None:
            out.append(None)
            continue
        As, st = _rows(sub, c["A"]), RNGState(c["seed"])
        if c["drv"] == "abrik":
            U, S, Vt, info, _ = dist_abrik(
                As, 8, sub, st, block_size=8, max_iters=4, v0=_t(c["v0"]),
                qr_sketches=_abrik_sketches(sub, c["sk"]))
            out.append(dict(U=U, S=S))
            continue
        S = _cols(sub, c["S"])
        if c["drv"] == "bqrrp":
            res = dist_bqrrp(As, sub, st, block_size=16, sketch=S)
        elif c["drv"] == "factored":
            fac, _ = dist_bqrrp_factored(As, sub, st, block_size=16,
                                         sketch=S)
            res = (bqrrp_q(fac, mesh=sub), fac.R, fac.J, fac.rank, fac.fail)
        else:
            res = dist_cqrrpt(As, sub, st, sketch=S)
        out.append(dict(zip(("Q", "R", "J", "rank", "fail"), res[:5])))
    return out


def fuzz_body(mesh, c):
    """One distributed trial of ``tools/fuzz_torch.py``: ``c["drv"]`` on
    this rank's rows of ``c["A"]`` (with ``c["b"]`` for SPLS), the draws
    in ``c`` injected as the rank's share, in ``c["dtype"]``."""
    dt = getattr(torch, c["dtype"])

    def t(x):
        return _t(x).to(dt)

    def rows(X):
        return row_sharded(mesh).put(t(X))

    def cols(S):
        return _cols(mesh, S).to(dt)

    st, drv, A = RNGState(c["seed"]), c["drv"], c["A"]
    if drv == "spls":
        x, _, it, _ = dist_spls(rows(A), rows(c["b"]), c["mu"], mesh, st,
                                tol=1e-12, max_iters=150,
                                sketch=cols(c["S"]))
        return dict(x=x, iters=it)
    if drv == "rsvd":
        U, S, Vt, fail, _ = dist_rsvd(rows(A), 8, mesh, st,
                                      omega=t(c["omega"]))
        return dict(U=U, S=S, fail=fail)
    if drv == "revd2":
        V, lam, err, nu, fail, _ = dist_revd2(
            rows(c["P"]), 8, mesh, st, error_est_passes=4,
            omega=t(c["omega"]), v0=t(c["v0"]))
        return dict(V=V, lam=lam, fail=fail)
    if drv == "cqrrt":
        Q, R, fail, _ = dist_cqrrt(rows(A), mesh, st, sketch=cols(c["S"]))
        return dict(Q=Q, R=R, fail=fail)
    if drv == "bqrrp":
        res = dist_bqrrp(rows(A), mesh, st, block_size=16,
                         sketch=cols(c["S"]))
    elif drv == "hqrrp":
        res = dist_hqrrp(rows(A), mesh, st, block_size=16,
                         sketch=cols(c["S"]))
    else:
        res = dist_cqrrpt(rows(A), mesh, st, sketch=cols(c["S"]))
    return dict(zip(("Q", "R", "J", "rank", "fail"), res[:5]))
