"""Time K4 (``ops.kernels.kernel_matmat``, f32) of the package in a given
checkout on the card, at KRILL's shapes: d 8, n 65536, s 1 (the full-size
solve's operator product) and d 8, n 8192, s 4 (four right-hand sides),
and at REVD2's: d 8, n 65536, s 1024 (the benchmark cell's products at
s = k). Comparing two checkouts means running this once for each in
turns, in one call on one card (parent, change, change, parent).

    python tools/k4_turns.py [CHECKOUT] [--shapes D,N,S ...]

CHECKOUT defaults to this one; its kernels build into its own build/.
``--shapes`` replaces the three shapes (as for the threshold of the wide
body). Prints one JSON line: the card, its power limit and, for each
shape, the mean ms a launch over 100 launches (after 10; from n²s = 2⁴⁰ on,
over 5 after 2) by CUDA events (which count the card's idle time where the host
issues launches slower than the card runs them, as at n 8192) and the
kernels' own device time a launch from torch.profiler over as many
more."""
import argparse
import json
import os
import subprocess
import sys


SHAPES = ((8, 65536, 1), (8, 8192, 4), (8, 65536, 1024))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkout", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--shapes", nargs="+", type=lambda a: tuple(
        int(v) for v in a.split(",")))
    args = ap.parse_args()
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("k4_turns: no CUDA device available", file=sys.stderr)
        return 1
    from randlapack_tpu_torch.ops import kernels
    assert kernels.__file__.startswith(root), kernels.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    out = {"checkout": root, "card": smi}
    for d, n, s in args.shapes or SHAPES:
        X = torch.randn((d, n), generator=g, device="cuda")
        V = torch.randn((n, s), generator=g, device="cuda")
        warm, runs = (2, 5) if n * n * s >= 2 ** 40 else (10, 100)
        for _ in range(warm):
            kernels.kernel_matmat(X, V, 3.8)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            kernels.kernel_matmat(X, V, 3.8)
        end.record()
        torch.cuda.synchronize()
        out[f"d{d}_n{n}_s{s}_ms"] = start.elapsed_time(end) / runs
        act = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(runs):
                kernels.kernel_matmat(X, V, 3.8)
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        out[f"d{d}_n{n}_s{s}_device_ms"] = dev_us / 1e3 / runs
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
