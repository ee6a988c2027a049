"""Start the ranks of a mesh: ``run_ranks`` spawns one process per rank,
joins them in a ``torch.distributed`` process group and calls a function
on each rank's mesh. This is how PyTorch gets the several devices that
XLA's ``--xla_force_host_platform_device_count`` gives JAX; nothing here
changes what a distributed function computes.

The backend is the caller's choice, never picked silently: "gloo" for
ranks on the CPU and for several ranks on one card (gloo's
``all_reduce`` and ``broadcast`` take CUDA tensors), "nccl" for one rank
a card (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import os
import pickle
import queue as _queue
import shutil
import tempfile
import time
import traceback

import torch

from ..errors import require


def to_numpy(x):
    """Tensors (nested in tuples, lists and dicts) as numpy arrays; other
    values as they are."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):    # a NamedTuple
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x


def _rank_main(rank, world_size, backend, device, init, payload, out):
    import torch.distributed as dist
    from .mesh import make_mesh
    torch.set_num_threads(1)
    os.environ.setdefault("LOCAL_RANK", str(rank))
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(backend, init_method=init,
                                world_size=world_size, rank=rank)
        try:
            result = to_numpy(fn(make_mesh(device=device), *args))
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world_size: int, *args, backend: str, device="cuda",
              timeout: float = 600.0) -> list:
    """Call ``fn(mesh, *args)`` on each of ``world_size`` new processes
    (the ``spawn`` start method; a ``file://`` store in a new temporary
    directory, so no TCP port is taken) joined in one process group with
    ``backend``; each rank's mesh is ``make_mesh(device=device)``. Returns
    the ranks' results in rank order, tensors made numpy arrays.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function). A
    rank that raises, or a run past ``timeout`` seconds (a collective one
    rank never reached hangs the others), raises ``RuntimeError`` here,
    and every process is stopped. Each rank runs one CPU thread."""
    require(backend in ("gloo", "nccl"),
            f"backend {backend!r}: 'gloo' or 'nccl'")
    require(world_size >= 1, f"world_size {world_size}")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rl_ranks_")
    init = "file://" + os.path.join(tmp, "store")
    out = ctx.Queue()
    # the function and its arguments go through a file: a spawned
    # process's own arguments pass through a pipe that the child empties
    # only after its imports, so large ones would start the ranks one
    # after another
    payload = os.path.join(tmp, "payload")
    with open(payload, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, device, init,
                               payload, out))
             for r in range(world_size)]
    results, errors = {}, {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except _queue.Empty:
                if not any(p.is_alive() for p in procs) and out.empty():
                    break
                continue
            (results if ok else errors)[rank] = value
            if not ok:
                # the other ranks may wait in a collective this one left
                deadline = min(deadline, time.monotonic() + 10.0)
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("run_ranks: " + "; ".join(
            f"rank {r} raised:\n{tb}" for r, tb in sorted(errors.items())))
    missing = [r for r in range(world_size) if r not in results]
    if missing:
        raise RuntimeError(f"run_ranks: ranks {missing} gave no result "
                           f"within {timeout} s (a hung collective, or a "
                           "rank that died); every process was stopped")
    return [results[r] for r in range(world_size)]


__all__ = ["run_ranks", "to_numpy"]
