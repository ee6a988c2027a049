"""Trace a benchmark cell's calls as its ``--trace 1`` run does and check
the program's spans against the trace.

    python tools/span_trace.py --workload CELL --seed N [--calls K]
        [--shape M N] [--settings JSON] [--out FILE.json.gz]

Runs the cell's entry (``cardbench/``) on the card (on the CPU where
there is none): two warm calls, then ``K`` calls (default the cell's
``trace_calls``) under the CUDA-only profiler, each ending in a
synchronize. ``--shape`` and ``--settings`` cut the cell to another size.
Prints one JSON line: every per-layer metric ``BENCHMARK.json`` gives
the cell, read from the record, and ``checks``:

- ``edges`` / ``event_records``: the spans' edges and the record's
  ``cudaEventRecord`` calls (equal where the spans align);
- ``root_ms``, ``busy_ms``, ``stretch_ms``: the root spans' device ms,
  the card's busy ms and the traced stretch's ms, each a call;
- ``children_share``: the root's children's device ms over the root's,
  and ``blocks_share`` HQRRP's block slots' over their blocks';
- ``self_ms``: device ms a call outside any child, by span name;
- ``launches_by_span``: the host's launch and copy calls a call, by the
  innermost span open at each;
- ``rows_share``: HQRRP's products with a block's reflectors (``vt_a``
  Vᵀ·A, ``a_update`` A −= V·U, ``g_v`` G·V, ``g_update`` G −= H·Vᵀ,
  ``wy_t`` VᵀV), each the rows it read over A's rows, summed over the
  calls (the counters ``hqrrp.rows.<product>``); ``masked_copies`` the
  masks a call laid on an operand the size of A (``hqrrp.masked_copies``);
- ``revd2``, where the calls are REVD2's: device ms a call by phase
  (``syps``, its ``stabilize`` spans, ``syrf_orth``, ``nystrom_factor``,
  ``error_est`` and every ``apply_a``), ``apply_a_share`` (the products'
  device ms over the root's), and the counters a call: ``applies``
  (``revd2.applies``), ``apply_columns`` (``revd2.apply_columns``, the
  products' entries over n·k), ``host_reads`` (``revd2.host_reads``)
  and ``k4_wide_columns`` (``k4.wide_columns``: the columns K4's wide
  body took a call, and that share of all its f32 tensor-core launches'
  columns).

``--out`` writes the record with ``spans``, ``setup_spans`` and
``counters`` (the fixture the span readers are tested on).
"""
import argparse
import gzip
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def traced(cell: str, seed: int, calls=None, shape=None, settings=None,
           device=None) -> dict:
    """The record (``cardbench.trace.record``) of ``calls`` traced calls
    of ``cell``, with the program's ``spans`` and ``setup_spans``."""
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cardbench import harness, inputs, trace
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.utils import timing

    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    cuda = device == "cuda"
    wl = harness.workload(cell)
    cfg = harness.config(wl["config"])
    if shape is not None:
        cfg = {**cfg, "shape": list(shape)}
    settings = {**wl["settings"], **(settings or {})}
    calls = calls or wl["trace_calls"]
    ent = harness.entry(wl["entry"])
    prep = ent.prepare(settings)
    A = inputs.make(cfg, seed, device)
    state = RNGState(inputs.derive(seed, 3))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(2):
        out, state = ent.call(A, state, prep)
        sync()
    del out
    prof = profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])
    prof.start()
    for _ in range(calls):
        out, state = ent.call(A, state, prep)
        sync()
        del out
    prof.stop()
    dev, host = trace.events(prof)
    rec = trace.record(dev, host, calls, trace.kernel_files(harness.CSRC),
                       ent.schedule(cfg["shape"], settings), {})
    rec["spans"] = timing.spans()
    rec["setup_spans"] = timing.setup_spans()
    rec["counters"] = timing.counters()
    return rec


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def launches_by_span(rec: dict, sp: list):
    """The host's launch and copy calls a call, by the innermost span open
    when each started (``"-"`` outside every span), where the spans
    align with the trace."""
    from cardbench import spans
    at = spans.align(rec, sp)
    if at is None:
        return None
    name = {s["id"]: s["name"] for s in sp}
    marks = sorted([(at[i, True][0], 0, i) for i, _ in at]
                   + [(at[i, False][1], 2, i) for i, _ in at]
                   + [(h[1], 1, h[0]) for h in rec["host"]
                      if h[0] in LAUNCH_CALLS])
    stack, out = [], {}
    for _, kind, what in marks:
        if kind == 0:
            stack.append(what)
        elif kind == 2:
            stack.remove(what)
        else:
            key = name[stack[-1]] if stack else "-"
            out[key] = out.get(key, 0) + 1 / rec["calls"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def checks(rec: dict) -> dict:
    """The spans against the trace (module docstring)."""
    from cardbench import spans, trace
    sp = spans.of(rec) or []
    n = rec["calls"]
    by_id = {s["id"]: s for s in sp}
    roots = [s for s in sp if s["parent"] is None]
    kids = [s for s in sp if s["parent"] in {r["id"] for r in roots}]
    blocks = [s for s in sp if s["name"] == "block"]
    slots = [s for s in sp if s["parent"] in {b["id"] for b in blocks}]

    def dev(items):
        return sum(s["device_ms"] or 0.0 for s in items)

    cnt = rec.get("counters")
    rows = "hqrrp.rows."
    self_ms: dict = {}
    for s in sp:
        if s["self_device_ms"] is not None:
            self_ms[s["name"]] = (self_ms.get(s["name"], 0.0)
                                  + s["self_device_ms"] / n)
    return dict(
        launches_by_span=launches_by_span(rec, sp),
        edges=2 * len(sp),
        event_records=sum(1 for h in rec["host"]
                          if h[0].startswith("cudaEventRecord")),
        aligned=spans.root_intervals(rec) is not None,
        roots=[r["name"] for r in roots],
        root_ms=dev(roots) / n,
        busy_ms=trace.busy_seconds(rec) * 1e3 / n,
        stretch_ms=rec["window_s"] * 1e3 / n,
        root_host_ms=sum(r["host_ms"] for r in roots) / n,
        children_share=dev(kids) / max(dev(roots), 1e-12),
        blocks_share=(dev(slots) / dev(blocks) if blocks else None),
        self_ms=dict(sorted(self_ms.items(), key=lambda kv: -kv[1])),
        spans_a_call=len(sp) / n,
        launches_a_call=len(rec["device"]) / n,
        rows_share=None if cnt is None else {
            k[len(rows):]: v[0] / v[1] for k, v in sorted(cnt.items())
            if k.startswith(rows) and v[1]},
        masked_copies=None if cnt is None else cnt.get(
            "hqrrp.masked_copies", [0, 0])[0] / n,
        revd2=revd2_checks(sp, cnt, n),
        unknown_parent=sum(1 for s in sp if s["parent"] is not None
                           and s["parent"] not in by_id))


REVD2_PHASES = ("syps", "stabilize", "syrf_orth", "nystrom_factor",
                 "error_est", "apply_a")


def revd2_checks(sp: list, cnt, calls: int):
    """REVD2's phases and counters a call (module docstring), or None
    where no traced call is REVD2's."""
    roots = [s for s in sp if s["parent"] is None and s["name"] == "revd2"]
    if not roots:
        return None
    ms = {p: sum(s["device_ms"] or 0.0 for s in sp if s["name"] == p)
          / calls for p in REVD2_PHASES}
    root_ms = sum(s["device_ms"] or 0.0 for s in roots) / calls
    cnt = cnt or {}

    def per_call(name):
        return cnt[name][0] / calls if name in cnt else None
    cols = cnt.get("revd2.apply_columns")
    wide = cnt.get("k4.wide_columns")
    return dict(device_ms=ms, root_ms=root_ms,
                apply_a_share=ms["apply_a"] / max(root_ms, 1e-12),
                applies=per_call("revd2.applies"),
                apply_columns=cols[0] / cols[1] if cols and cols[1] else None,
                host_reads=per_call("revd2.host_reads"),
                k4_wide_columns=None if wide is None else dict(
                    columns=wide[0] / calls, of=wide[1] / calls,
                    share=wide[0] / wide[1] if wide[1] else None))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int)
    ap.add_argument("--shape", type=int, nargs=2)
    ap.add_argument("--settings", type=json.loads)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rec = traced(args.workload, args.seed, args.calls, args.shape,
                 args.settings)
    from cardbench import harness
    metrics = {m["name"]: harness.reader(m["name"])(rec)
               for m in harness.metrics_of(args.workload, "per_layer")}
    if args.out:
        with gzip.open(args.out, "wt") as f:
            json.dump(rec, f)
    print(json.dumps(dict(workload=args.workload, seed=args.seed,
                          metrics=metrics, checks=checks(rec))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
