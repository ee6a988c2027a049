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

A configuration whose generator is not in ``MAKERS`` brings its own
maker, ``makers/<kind>.py``: ``make(config, seed, device)`` returns the
cell's input, whatever object its entry takes (a matrix, a tuple of a
point set and its labels, a sparse matrix), and its docstring says how
the run's seed reorders that input.
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path

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
MAKER_DIR = Path(__file__).resolve().parent / "makers"


def module_at(path: Path):
    """The module of the Python file ``path``, loaded by its path (a name
    such as ``driver.qrcp_ms`` is no module name)."""
    spec = importlib.util.spec_from_file_location(
        f"cardbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def maker(kind: str):
    """The ``make`` function of ``MAKER_DIR/<kind>.py``."""
    return module_at(MAKER_DIR / f"{kind}.py").make


def make(config: dict, seed: int, device):
    """The input of ``config`` (a configuration file's contents) for
    ``seed``: for a generator of ``MAKERS``, its matrix of
    ``matrix_seed`` with its columns in the seed's order; otherwise what
    the generator's own maker returns (module docstring)."""
    gen = config["generator"]
    if gen["kind"] not in MAKERS:
        return maker(gen["kind"])(config, seed, device)
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
