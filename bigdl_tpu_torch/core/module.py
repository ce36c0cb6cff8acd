"""The forward context: randomness for stochastic layers (counterpart of
``forward_context``/``next_rng_key`` in ``bigdl_tpu/core/module.py``).

The reference carries a JAX key through ``forward`` calls without
changing their signatures and raises "No RNG in scope" when a
training-mode stochastic layer finds none.  The port carries a
``torch.Generator`` the same way: train-mode dropout draws its mask from
:func:`next_generator`, never from torch's global RNG, so a run's
randomness is a function of the generator its caller seeded.  The
generator must live on the device of the tensors it draws for.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch

__all__ = ["forward_context", "next_generator", "dropout"]


class _ForwardContext(threading.local):
    def __init__(self):
        self.generator: Optional[torch.Generator] = None


_ctx = _ForwardContext()


@contextmanager
def forward_context(generator: Optional[torch.Generator] = None):
    """Provide ``generator`` to the stochastic layers of the enclosed
    ``forward`` calls (nested contexts restore the outer one)."""
    prev = _ctx.generator
    _ctx.generator = generator
    try:
        yield
    finally:
        _ctx.generator = prev


def next_generator() -> torch.Generator:
    """The generator in scope; raises without one, as the reference's
    ``next_rng_key`` does."""
    if _ctx.generator is None:
        raise RuntimeError(
            "No RNG in scope: wrap the forward call in "
            "`with forward_context(generator=torch.Generator(...)):` "
            "(training mode stochastic layers need randomness).")
    return _ctx.generator


def dropout(x, p: float):
    """Inverted dropout with a keep mask ~ Bernoulli(1 - p) drawn from
    the generator in scope: ``where(keep, x / (1 - p), 0)``, the
    reference's arithmetic."""
    keep = torch.rand(x.shape, generator=next_generator(),
                      device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
