"""Deterministic random streams (counterpart of speech_resynth_tpu/core/rng.py).

A training loop holds one ``RngStream`` per run. ``fold_in(step)`` gives the
step its own ``torch.Generator``, seeded by a pure function of (seed, step),
so a resumed run draws the same noise at the same step without storing any
generator state, as the JAX loop does with ``rngs.fold_in(step)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike


def derive_seed(*entropy: int, spawn_key: tuple = ()) -> int:
    """A 63-bit seed, a pure function of the non-negative integers given."""
    seq = np.random.SeedSequence(tuple(int(e) for e in entropy), spawn_key=spawn_key)
    lo, hi = seq.generate_state(2)
    return (int(hi) << 32 | int(lo)) & (2**63 - 1)


class RngStream:
    """Generators on ``device`` derived from ``seed``: ``next()`` walks a
    sequence, ``fold_in(data)`` and ``seed_for(data)`` depend on (seed, data)
    alone."""

    def __init__(self, seed: int, device: DeviceLike = "cpu"):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._count = 0

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def next(self) -> torch.Generator:
        self._count += 1
        return self._generator(derive_seed(self.seed, spawn_key=(self._count,)))

    def seed_for(self, data: int) -> int:
        """The seed of ``fold_in(data)``; also what seeds a step's dropout sites."""
        return derive_seed(self.seed, data)

    def fold_in(self, data: int) -> torch.Generator:
        """A generator seeded by (seed, data), e.g. the step number."""
        return self._generator(self.seed_for(data))
