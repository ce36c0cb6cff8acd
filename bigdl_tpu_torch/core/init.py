"""Weight initialization methods (the port's copy of ``calc_fans``,
``RandomUniform``, ``RandomNormal`` and ``MsraFiller`` of
``bigdl_tpu/core/init.py``).

Each method is a callable ``(shape, *, generator, fan_in=None,
fan_out=None) -> torch.Tensor``: float32 on the CPU, drawn from the
caller's ``torch.Generator`` (callers move it to their device).  They
follow the reference's distributions, not its bits: JAX's threefry and
torch's generators give different numbers from one seed, so parity tests
copy weights across instead of drawing twice.  Fans follow the reference:
for a 2-D weight (out, in) fan_in = shape[1]; for a larger one fan_in =
shape[1] times the product of the rest.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["calc_fans", "InitMethod", "RandomUniform", "RandomNormal",
           "MsraFiller"]


def calc_fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[1], shape[0]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


class InitMethod:
    def __call__(self, shape, *, generator: torch.Generator,
                 fan_in: Optional[int] = None,
                 fan_out: Optional[int] = None) -> torch.Tensor:
        raise NotImplementedError


class RandomUniform(InitMethod):
    """U(lower, upper); with no bounds, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def __init__(self, lower: Optional[float] = None,
                 upper: Optional[float] = None):
        if (lower is None) != (upper is None):
            raise ValueError(
                "RandomUniform needs both bounds or neither "
                f"(got lower={lower}, upper={upper})")
        self.lower, self.upper = lower, upper

    def __call__(self, shape, *, generator, fan_in=None, fan_out=None):
        if self.lower is None:
            fi = calc_fans(tuple(shape))[0] if fan_in is None else fan_in
            bound = 1.0 / math.sqrt(max(fi, 1))
            lo, hi = -bound, bound
        else:
            lo, hi = self.lower, self.upper
        return torch.rand(tuple(shape), generator=generator) * (hi - lo) + lo


class RandomNormal(InitMethod):
    """N(mean, stdv)."""

    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def __call__(self, shape, *, generator, fan_in=None, fan_out=None):
        return self.mean + self.stdv * torch.randn(tuple(shape),
                                                   generator=generator)


class MsraFiller(InitMethod):
    """Kaiming/He normal: N(0, sqrt(2 / n)) with n the mean of the fans,
    or fan_out alone when ``variance_norm_average`` is False (the
    reference's MsraFiller)."""

    def __init__(self, variance_norm_average: bool = True):
        self.average = variance_norm_average

    def __call__(self, shape, *, generator, fan_in=None, fan_out=None):
        fi, fo = calc_fans(tuple(shape))
        fi = fan_in if fan_in is not None else fi
        fo = fan_out if fan_out is not None else fo
        n = (fi + fo) / 2.0 if self.average else fo
        std = math.sqrt(2.0 / max(n, 1))
        return std * torch.randn(tuple(shape), generator=generator)
