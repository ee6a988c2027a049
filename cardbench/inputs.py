"""The cells' inputs, made from the seed on the device.

``fast_decay`` is the port's and the JAX package's benchmark matrix
(``gen.fast_decay_matrix``'s formula, written out here so the benchmark
makes its own input): A = (G₁·diag(e^{−decay·i/k}))·G₂ᵀ/√(mk), k =
min(m, n), G₁ and G₂ iid Gaussian, one fp32 product with TF32 off.

``make`` draws that matrix from the configuration's fixed
``matrix_seed`` and puts its columns in an order drawn from the run's
seed: every seed gives the same work (a pivoted QR's data-dependent
rescues follow the matrix, not the column order) in another order, and
the same seed the same input.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed, a deterministic hash of ``seed`` and ``tags`` (any
    whole numbers, negative or past 64 bits included)."""
    words = [int(w) % 2**64 for w in (seed, *tags)]
    seq = np.random.SeedSequence(words)
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, tag))
    return gen


def fast_decay(m: int, n: int, decay: float, seed: int, device,
               dtype=torch.float32) -> torch.Tensor:
    """The m×n benchmark matrix of ``seed`` (module docstring), made in
    three large calls on ``device``."""
    k = min(m, n)
    s = torch.exp(-decay * torch.arange(k, dtype=dtype, device=device) / k)
    G1 = torch.randn((m, k), generator=generator(seed, 1, device),
                     dtype=dtype, device=device)
    G1 *= s[None, :]
    G2 = torch.randn((n, k), generator=generator(seed, 2, device),
                     dtype=dtype, device=device)
    A = G1 @ G2.T
    del G1, G2
    A /= math.sqrt(float(m) * k)
    return A


MAKERS = {"fast_decay": fast_decay}


def make(config: dict, seed: int, device) -> torch.Tensor:
    """The input of ``config`` (a configuration file's contents) for
    ``seed``: the generator's matrix of ``matrix_seed``, its columns in
    the seed's order (module docstring)."""
    gen = config["generator"]
    m, n = config["shape"]
    dtype = {"float32": torch.float32, "float64": torch.float64}[
        config["dtype"]]
    kwargs = {k: v for k, v in gen.items() if k not in ("kind", "matrix_seed")}
    base = MAKERS[gen["kind"]](m, n, seed=gen["matrix_seed"], device=device,
                               dtype=dtype, **kwargs)
    perm = torch.randperm(n, generator=generator(seed, 5, device),
                          device=device)
    A = base.index_select(1, perm)
    del base
    return A
