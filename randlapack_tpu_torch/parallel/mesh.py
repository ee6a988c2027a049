"""Meshes, row shards and the collectives of the distributed layer
(counterpart of ``randlapack_tpu/parallel/mesh.py``).

A JAX sharded array is one global array over a device mesh. Here each
rank of a ``torch.distributed`` process group is one process holding its
own block of rows: rows [r·m/p, (r+1)·m/p) of the tall operand on rank r
of p. Every distributed function takes and returns such local shards
(row-sharded results, like the JAX out-spec ``P(axis, None)``) or values
that are the same, bit for bit, on every rank (replicated results, like
``P()``). Each ``jax.lax.psum`` / ``pmax`` is an ``all_reduce`` (``SUM`` /
``MAX``), and the collectives are only ``all_reduce`` and ``broadcast``,
which the gloo backend takes on CUDA tensors as well as on CPU ones.

A mesh of one rank needs no process group: its collectives are the
identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from ..errors import require

# host seconds and calls spent in the collectives below while ``timed`` is
# set (``collective_timer``): each call synchronizes the device before and
# after, so the count is the collectives' own time, at that cost
STATS = {"calls": 0, "seconds": 0.0, "timed": False}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh: the process group (None for one rank with no group),
    the name of its axis, this process's rank and the mesh's size, and the
    device this rank computes on."""
    group: object
    axis: str
    rank: int
    size: int
    device: torch.device

    def _collective(self, what, t, fn):
        """Run ``fn`` (an in-place collective on ``t``), refusing a tensor
        the group's backend cannot take."""
        require(t.is_contiguous(), f"{what}: the tensor must be contiguous")
        if t.device.type == "cuda":
            backend = dist.get_backend(self.group)
            require(backend in ("gloo", "nccl"),
                    f"{what}: the {backend!r} backend takes no CUDA tensor")
        elif dist.get_backend(self.group) == "nccl":
            raise RuntimeError(f"{what}: the 'nccl' backend takes no "
                               f"{t.device.type} tensor")
        if not STATS["timed"]:
            fn()
            return t
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        fn()
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        STATS["calls"] += 1
        STATS["seconds"] += time.perf_counter() - t0
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of ``t`` (``jax.lax.psum``), the same on every
        rank. ``t`` is reduced in place: pass a tensor the caller owns.
        The identity on a mesh of one rank."""
        if self.size == 1:
            return t
        return self._collective("psum", t, lambda: dist.all_reduce(
            t, op=dist.ReduceOp.SUM, group=self.group))

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the ranks (``jax.lax.pmax``), in place as
        ``psum``."""
        if self.size == 1:
            return t
        return self._collective("pmax", t, lambda: dist.all_reduce(
            t, op=dist.ReduceOp.MAX, group=self.group))

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank (in place): for a replicated
        library call whose result could differ between ranks. (A mesh's
        ranks are the group's first ones, so its rank 0 is global rank
        0.)"""
        if self.size == 1:
            return t
        return self._collective("broadcast", t, lambda: dist.broadcast(
            t, src=0, group=self.group))

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """A device flag raised on any rank, the same on every rank."""
        if self.size == 1:
            return flag
        return self.pmax(flag.reshape(1).to(torch.float32))[0] > 0

    def rows(self, m_local: int) -> tuple[int, int]:
        """This rank's global rows ``[r0, r0 + m_local)`` for a shard of
        ``m_local`` rows."""
        return self.rank * m_local, (self.rank + 1) * m_local

    def local_rows(self, m_local: int, g0: int, g1: int) -> tuple[int, int]:
        """The local index range ``[lo, hi)`` of the global rows
        ``[g0, g1)`` in a shard of ``m_local`` rows (may be empty)."""
        r0 = self.rank * m_local
        lo = min(max(g0 - r0, 0), m_local)
        return lo, min(max(g1 - r0, lo), m_local)

    def join_rows(self, part: torch.Tensor, m_local: int, g0: int,
                  g1: int) -> torch.Tensor:
        """The global rows ``[g0, g1)`` on every rank, given this rank's
        ``part`` of them (its local rows ``local_rows(m_local, g0, g1)``):
        one ``psum`` of the part placed in zeros (the other ranks add
        exact zeros, so the rows are their owners' bits)."""
        if self.size == 1:
            return part
        at = min(max(g0, self.rank * m_local), (self.rank + 1) * m_local) \
            - g0
        out = part.new_zeros((g1 - g0,) + tuple(part.shape[1:]))
        out[at:at + part.shape[0]] = part
        return self.psum(out)

    def rows_of(self, t: torch.Tensor, g0: int, g1: int) -> torch.Tensor:
        """The global rows ``[g0, g1)`` of the row-sharded ``t`` on every
        rank."""
        lo, hi = self.local_rows(t.shape[0], g0, g1)
        return self.join_rows(t[lo:hi], t.shape[0], g0, g1)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole row-sharded matrix (or vector) on every rank."""
        return self.rows_of(t, 0, t.shape[0] * self.size)


@contextlib.contextmanager
def collective_timer():
    """Count the host seconds and calls of every collective inside the
    block into ``STATS`` (reset on entry); each is bracketed by device
    synchronizations while this is on."""
    STATS.update(calls=0, seconds=0.0, timed=True)
    try:
        yield STATS
    finally:
        STATS["timed"] = False


def _device(device, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    require(torch.cuda.is_available(),
            "make_mesh(device='cuda'): this rank has no CUDA device; pass "
            "device='cpu' to compute on the CPU")
    if dev.index is not None:
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, axis: str = "rows",
              device="cuda") -> Mesh | None:
    """1-D mesh over the first ``n_devices`` ranks (default all) of the
    initialized default process group; with no group, a mesh of this one
    process (``n_devices`` None or 1). Every rank of the group calls it
    (a subgroup is made collectively); a rank past ``n_devices`` gets
    None.

    The device is ``cuda:<local rank mod device_count>`` (the local rank
    from ``LOCAL_RANK``, else the rank), or what ``device`` names; a rank
    with no card raises for "cuda" rather than run on the CPU."""
    if not dist.is_initialized():
        require(n_devices in (None, 1), f"make_mesh({n_devices}): no "
                "process group is initialized (see parallel.run_ranks)")
        return Mesh(None, axis, 0, 1, _device(device, 0))
    world, rank = dist.get_world_size(), dist.get_rank()
    p = world if n_devices is None else int(n_devices)
    require(1 <= p <= world, f"make_mesh({n_devices}) on a world of {world}")
    group = None if p == world else dist.new_group(ranks=list(range(p)))
    if rank >= p:
        return None
    local = int(os.environ.get("LOCAL_RANK", rank))
    return Mesh(group, axis, rank, p, _device(device, local))


class _Spec:
    def __init__(self, mesh: Mesh):
        self.mesh = mesh


class RowSharded(_Spec):
    """``P(axis, None)``: ``put(A)`` gives this rank's block of A's rows
    on the mesh's device (m must be a multiple of the mesh size)."""

    def put(self, A) -> torch.Tensor:
        A = torch.as_tensor(A)
        m, p = A.shape[0], self.mesh.size
        require(m % p == 0, f"{m} rows do not split over {p} ranks")
        r0, r1 = self.mesh.rows(m // p)
        return A[r0:r1].to(self.mesh.device).contiguous()


class Replicated(_Spec):
    """``P()``: ``put(A)`` gives A on the mesh's device."""

    def put(self, A) -> torch.Tensor:
        return torch.as_tensor(A).to(self.mesh.device).contiguous()


def row_sharded(mesh: Mesh, axis: str = "rows") -> RowSharded:
    check_axis(mesh, axis)
    return RowSharded(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


_MESHES: list[Mesh] = []


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """The counterpart of ``jax.sharding.set_mesh``: inside the block a
    config's ``shard_axis`` names this mesh's axis."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh(axis: str) -> Mesh:
    """The innermost mesh set by ``set_mesh`` whose axis is ``axis``;
    raises if there is none."""
    for mesh in reversed(_MESHES):
        if mesh.axis == axis:
            return mesh
    raise ValueError(f"shard_axis={axis!r}: no mesh with that axis is set "
                     "(wrap the call in parallel.set_mesh(mesh))")


def global_rows(m_local: int, mesh: Mesh, what: str) -> int:
    """The global row count m = p·m_local of a row-sharded operand, after
    checking (one ``pmax``) that every rank holds as many rows, as
    ``shard_map`` needs m to be a multiple of p. Every rank raises alike."""
    require(m_local > 0, f"{what}: empty row shard")
    if mesh.size > 1:
        t = mesh.pmax(torch.tensor([m_local, -m_local], dtype=torch.float64,
                                   device=mesh.device))
        hi, lo = int(t[0]), -int(t[1])
        require(hi == lo, f"{what}: the ranks hold {lo} to {hi} rows; the "
                "row count must be a multiple of the mesh size, split "
                "evenly")
    return m_local * mesh.size


def shard_rows(A: torch.Tensor, mesh: Mesh | None, what: str):
    """``(m, mesh)`` for the operand A of a driver's row-sharded mode: the
    global row count (``global_rows``, after checking that A lies on the
    rank's device) and the mesh, or None for a mesh of one rank (its call
    is the unsharded one). With no mesh, A's own row count and None."""
    if mesh is None:
        return A.shape[0], None
    require(A.device == mesh.device, f"A is on {A.device}, the mesh's "
            f"rank computes on {mesh.device}")
    m = global_rows(A.shape[0], mesh, what)
    return m, (mesh if mesh.size > 1 else None)


def check_axis(mesh: Mesh, axis: str) -> None:
    require(axis == mesh.axis, f"axis {axis!r} is not the mesh's "
            f"{mesh.axis!r}")
