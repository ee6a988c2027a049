"""Counter-based PRNG state — the RandBLAS ``RNGState`` capability
(counterpart of ``randlapack_tpu/rng.py``).

The state is a ``(key, counter)`` pair of Python integers. Every draw
takes a ``torch.Generator`` seeded deterministically from the pair and
returns a state with ``counter + 1``, so a computation is replayable from
the pair; ``branch`` derives an independent key. The streams differ from
the JAX package's (threefry): tests that compare the two inject the
random draws instead (see ``drivers.bqrrp.bqrrp_factored(sketch=...)``).
"""
from __future__ import annotations

import numpy as np
import torch


def _derive(*words: int) -> int:
    """A 63-bit seed that is a deterministic hash of ``words``."""
    seq = np.random.SeedSequence([int(w) % 2**64 for w in words])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


class RNGState:
    """State-in/state-out counter-based RNG state."""

    __slots__ = ("key", "counter")

    def __init__(self, seed: int = 0, *, _key: int | None = None,
                 _counter: int = 0):
        self.key = int(seed) if _key is None else _key
        self.counter = _counter

    def advance(self) -> "RNGState":
        """The state after one draw: the counter advanced, no generator
        built."""
        return RNGState(_key=self.key, _counter=self.counter + 1)

    def spawn(self, device="cuda"):
        """Return ``(generator, next_state)``: ``generator`` lives on
        ``device`` (the card unless the caller asks for the CPU) and is
        seeded from (key, counter); ``next_state`` has the counter
        advanced."""
        gen = torch.Generator(device=device)
        gen.manual_seed(_derive(self.key, self.counter))
        return gen, self.advance()

    def branch(self, i: int = 1) -> "RNGState":
        """Independent stream — the analogue of ``state.key.incr(i)``.
        Hashes (key, counter, branch tag), so sibling states branch apart
        and branch keys never coincide with a spawn seed (those hash two
        words, these three)."""
        return RNGState(_key=_derive(self.key, self.counter, 2**32 + i))

    def __repr__(self):
        return f"RNGState(key={self.key}, counter={self.counter})"


def as_state(state_or_seed) -> RNGState:
    """Accept an RNGState or an int seed."""
    if isinstance(state_or_seed, RNGState):
        return state_or_seed
    return RNGState(int(state_or_seed))
