"""Weight initialization methods (the port's copy of
``bigdl_tpu/core/init.py``: ``calc_fans``, ``Zeros``, ``Ones``,
``ConstInitMethod``, ``RandomUniform``, ``RandomNormal``, ``Xavier``,
``MsraFiller`` and ``BilinearFiller``).

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

__all__ = ["calc_fans", "InitMethod", "Zeros", "Ones", "ConstInitMethod",
           "RandomUniform", "RandomNormal", "Xavier", "MsraFiller",
           "BilinearFiller", "Bilinear"]


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


class _Zeros(InitMethod):
    def __call__(self, shape, *, generator=None, fan_in=None, fan_out=None):
        return torch.zeros(tuple(shape))


class _Ones(InitMethod):
    def __call__(self, shape, *, generator=None, fan_in=None, fan_out=None):
        return torch.ones(tuple(shape))


class ConstInitMethod(InitMethod):
    """Every entry ``value``."""

    def __init__(self, value: float):
        self.value = value

    def __call__(self, shape, *, generator=None, fan_in=None, fan_out=None):
        return torch.full(tuple(shape), float(self.value))


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


class _Xavier(InitMethod):
    """Glorot uniform: U(-sqrt(6 / (fan_in + fan_out)), +...)."""

    def __call__(self, shape, *, generator, fan_in=None, fan_out=None):
        fi, fo = calc_fans(tuple(shape))
        fi = fan_in if fan_in is not None else fi
        fo = fan_out if fan_out is not None else fo
        bound = math.sqrt(6.0 / (fi + fo))
        return (torch.rand(tuple(shape), generator=generator) * 2.0
                - 1.0) * bound


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


class BilinearFiller(InitMethod):
    """The bilinear upsampling kernel of a transposed convolution, for a
    (out, in, kh, kw) weight: the outer product of the two 1-D tents,
    broadcast over out and in (draws nothing)."""

    def __call__(self, shape, *, generator=None, fan_in=None, fan_out=None):
        if len(shape) != 4:
            raise ValueError("BilinearFiller expects (out, in, kh, kw), "
                             f"got {tuple(shape)}")
        kh, kw = shape[2], shape[3]
        f_h, f_w = math.ceil(kh / 2.0), math.ceil(kw / 2.0)
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        wy = 1.0 - torch.abs(torch.arange(kh) / f_h - c_h)
        wx = 1.0 - torch.abs(torch.arange(kw) / f_w - c_w)
        kernel = torch.outer(wy, wx).float()
        return kernel.expand(tuple(shape)).clone()


Zeros = _Zeros()
Ones = _Ones()
Xavier = _Xavier()
Bilinear = BilinearFiller()
