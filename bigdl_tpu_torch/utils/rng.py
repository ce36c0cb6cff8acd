"""Process-wide random generator with explicit seeding (counterpart of
``bigdl_tpu/utils/rng.py``; the reference's utils/RandomGenerator.scala).

The reference feeds one process-wide seed into ``jax.random`` keys and
folds a counter into the key for each consumer (``next_key``).  The port
does the same with ``torch.Generator``s: :func:`next_generator` returns a
fresh generator seeded from ``(seed, count)``, so a sequence of inits is
reproducible under :func:`set_seed`.  The generator is process-wide
(shared across threads, guarded by a lock): a data-loader thread sees the
seed set on the main thread.

Threefry and Philox differ, so the same seed draws other numbers than
the reference's; parity tests copy weights, never seeds.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["set_seed", "get_seed", "next_generator", "RandomGenerator"]


class RandomGenerator:
    """A seed and a counter; each :meth:`next_generator` call counts one."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.seed = seed
        self._count = 0

    def set_seed(self, seed: int) -> "RandomGenerator":
        with self._lock:
            self.seed = seed
            self._count = 0
        return self

    def next_generator(self, device="cpu") -> torch.Generator:
        """A new generator on ``device`` seeded from ``(seed, count)``
        (``SeedSequence`` mixes the two, as ``fold_in`` does a key and a
        counter)."""
        with self._lock:
            self._count += 1
            entropy = [int(self.seed) % (2 ** 63), self._count]
        word = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
        return torch.Generator(device=device).manual_seed(int(word[0]))


_GEN = RandomGenerator()


def set_seed(seed: int) -> RandomGenerator:
    return _GEN.set_seed(seed)


def get_seed() -> int:
    return _GEN.seed


def next_generator(device="cpu") -> torch.Generator:
    return _GEN.next_generator(device)
