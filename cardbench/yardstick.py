"""The benchmark's frozen arithmetic: the card's published peaks, the least
time of a piece of work on them, and the work that the factorizations'
block schedules need.

Copied, not imported: ``bound`` and ``form_bound`` are
``chip_smoke.py::bound`` (without its special-function term, which no
cell's work has) and ``chip_smoke.py::form_bound``;
``select_pivots_work`` and ``panel_work`` are ``chip_smoke.py``'s K5/K6
counts on shapes instead of tensors. A later change to the program cannot
move these numbers.

A roofline's work is what the algorithm needs for the inputs, whatever
implements it: each input byte read once and each output byte written
once, the rows of a reflector block that are zero by construction and
the retired (masked) columns not counted.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the card's
# full 700 W
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float, tensor: bool = False) -> float:
    """The least seconds the card could take for ``flops`` fp32 operations
    and ``nbytes`` bytes: the larger of the operations over their peak and
    the bytes over the memory rate. With ``tensor`` (a plain matrix
    product) the operations take the lesser of that and their time as
    three TF32 products on the tensor cores, which compute it to fp32
    accuracy."""
    t_ops = flops / PEAK_FP32
    if tensor:
        t_ops = min(t_ops, flops / (PEAK_TF32 / 3))
    return max(t_ops, nbytes / PEAK_BYTES)


def form_bound(flops: float, nbytes: float, form: str) -> float:
    """The least seconds of a product in a trailing form: its operations
    at the tensor cores' dense rate for the form's type (TF32 495, bf16
    989 TFLOP/s; three products for "bf16x3"), against its bytes."""
    t_ops = {"tf32": flops / PEAK_TF32, "bf16": flops / PEAK_BF16,
             "bf16x3": 3 * flops / PEAK_BF16}[form]
    return max(t_ops, nbytes / PEAK_BYTES)


def item_bound(item: dict) -> float:
    """``bound`` or ``form_bound`` of one work item of a schedule."""
    form = item.get("form", "highest")
    if form == "highest":
        return bound(item["flops"], item["bytes"], tensor=item["tensor"])
    return form_bound(item["flops"], item["bytes"], form)


def form_of(trailing_precision: str) -> str:
    """The form of a driver's trailing products on the card in f32, as
    ``ops.wy.trailing_form`` maps it ("bf16_3x_emul" and any other string
    three bf16 products)."""
    return {"highest": "highest", "high": "tf32",
            "default": "bf16"}.get(trailing_precision, "bf16x3")


def select_pivots_work(d: int, n: int, nsteps: int, live: int):
    """K5 on a d×n sketch with ``live`` columns not retired, ``nsteps``
    steps: the live columns' norms, then per step l the reflector
    (2(d−l)) and, on each column still available, v·W and the rank-1
    update (4(d−l)); the sketch read once, the pivots written. Returns
    (flops, bytes) in f32."""
    flops = 2 * d * live + sum(2 * (d - l) + max(live - l - 1, 0) * 4 * (d - l)
                               for l in range(nsteps))
    return float(flops), float((d * n + n) * 4 + nsteps * 8)


def panel_work(m: int, b: int, row0: int):
    """K6 on an m×b panel at row offset ``row0``: the column norms below
    row0, then per step l the column norm (2(M−l)) and, on each column
    right of l, v·W and the rank-1 update (4(M−l)), M = m − row0; the
    panel read once and written once, with taus and sigma. Returns
    (flops, bytes) in f32."""
    M = m - row0
    flops = 2 * M * b + sum(2 * (M - l) + 4 * (b - l - 1) * (M - l)
                            for l in range(b))
    return float(flops), float(2 * m * b * 4 + b * (4 + 8))


def masked_vt_a_work(rows: int, b: int, live: int, form: str) -> dict:
    """K1, W = Vᵀ·(A ⊙ mask): V's ``rows`` nonzero rows × b, A's same
    rows on its ``live`` columns; W (b × live) written."""
    return dict(kind="trailing", form=form, tensor=True,
                flops=2.0 * rows * b * live,
                bytes=4.0 * (rows * b + rows * live + b * live))


def a_minus_vz_masked_work(rows: int, k: int, live: int, form: str) -> dict:
    """K2, A ← A − (V·Z) ⊙ mask: A's ``rows`` × ``live`` read and
    written, V's rows × k and Z's k × live read."""
    return dict(kind="trailing", form=form, tensor=True,
                flops=2.0 * rows * k * live,
                bytes=4.0 * (2 * rows * live + rows * k + k * live))


def hqrrp_schedule(m: int, n: int, block: int, oversample: int, defer: int,
                   form: str) -> list[dict]:
    """HQRRP on an m×n matrix: per block i at row c = i·b, K5's b steps
    on the (b + oversample) × n sketch with n − c columns live and K6 on
    the m×b panel at row offset c; where the trailing products take a
    K1/K2 form (``form`` other than "highest"), one K1 a block over the
    columns live after it and one K2 (k = g·b) a group of ``defer``
    blocks; "highest" runs them on cuBLAS and
    lists none."""
    K = min(m, n)
    nb = K // block
    d = block + oversample
    items = []
    for i in range(nb):
        c = i * block
        f, by = select_pivots_work(d, n, block, n - c)
        items.append(dict(kind="qrcp", flops=f, bytes=by, tensor=False))
        f, by = panel_work(m, block, c)
        items.append(dict(kind="qrcp", flops=f, bytes=by, tensor=False))
    if form != "highest":
        g = max(1, min(defer, nb))
        for i0 in range(0, nb, g):
            gg = min(g, nb - i0)
            for j in range(gg):
                c = (i0 + j) * block
                items.append(masked_vt_a_work(m - c, block,
                                              n - c - block, form))
            items.append(a_minus_vz_masked_work(
                m - i0 * block, gg * block, n - (i0 + gg) * block, form))
    return items
