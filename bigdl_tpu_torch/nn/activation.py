"""Pointwise activation layers (counterpart of
``bigdl_tpu/nn/activation.py``, all 35 classes).

Each is the reference's formula in torch ops, in the dtype of its input.
``SoftMax``, ``SoftMin`` and ``LogSoftMax`` normalise the last axis by
default (NHWC), as the reference's do.  ``PReLU`` and ``SReLU`` hold
parameters with the reference's constant initial values and take
``device=`` (default ``cuda``).  ``RReLU`` draws its training slopes from
the generator in scope (``forward_context``), as the reference draws from
its key; without one, or in eval mode, it uses the mean slope.
``GradientReversal`` is an autograd Function: identity forward, −λ·grad
backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module, has_generator, \
    next_generator

__all__ = [
    "ReLU", "ReLU6", "Tanh", "Sigmoid", "HardSigmoid", "HardTanh",
    "LeakyReLU", "PReLU", "RReLU", "SReLU", "ELU", "SoftPlus", "SoftSign",
    "SoftShrink", "HardShrink", "TanhShrink", "SoftMax", "SoftMin",
    "LogSoftMax", "LogSigmoid", "Threshold", "BinaryThreshold", "Clamp",
    "Power", "Square", "Sqrt", "Log", "Exp", "Abs", "Negative",
    "GradientReversal", "AddConstant", "MulConstant", "GELU", "Swish",
]


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


class ReLU(Module):
    """max(0, x)."""

    def __init__(self, ip: bool = False):
        super().__init__()

    def forward(self, x):
        return torch.relu(x)


class ReLU6(Module):
    """min(max(0, x), 6)."""

    def forward(self, x):
        return torch.clamp(x, 0, 6)


class Tanh(Module):
    def forward(self, x):
        return torch.tanh(x)


class Sigmoid(Module):
    def forward(self, x):
        return torch.sigmoid(x)


class HardSigmoid(Module):
    """clip(0.2 x + 0.5, 0, 1)."""

    def forward(self, x):
        return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


class HardTanh(Module):
    """clip(x, min_value, max_value)."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 ip: bool = False):
        super().__init__()
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def forward(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class LeakyReLU(Module):
    """x if x > 0 else negval·x."""

    def __init__(self, negval: float = 0.01, ip: bool = False):
        super().__init__()
        self.negval = float(negval)

    def forward(self, x):
        return torch.where(x > 0, x, self.negval * x)


class PReLU(Module):
    """Learnable leaky slope, one shared or one per channel (the last
    axis in NHWC); initial slope 0.25."""

    def __init__(self, n_output_plane: int = 0, *, device=None):
        super().__init__()
        self.n_output_plane = n_output_plane
        self.weight = nn.Parameter(torch.full(
            (max(n_output_plane, 1),), 0.25, device=resolve_device(device)))

    def forward(self, x):
        w = self.weight if self.n_output_plane > 0 else self.weight[0]
        return torch.where(x > 0, x, w * x)


class RReLU(Module):
    """Randomized leaky ReLU: slope ~ U(lower, upper) in training (from
    the generator in scope), the mean slope otherwise."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 ip: bool = False):
        super().__init__()
        self.lower, self.upper = float(lower), float(upper)

    def forward(self, x):
        if self.training and has_generator():
            u = torch.rand(x.shape, generator=next_generator(),
                           device=x.device, dtype=x.dtype)
            a = self.lower + (self.upper - self.lower) * u
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)


class SReLU(Module):
    """S-shaped ReLU with learnable t_left, a_left, t_right, a_right of
    ``shape`` (initially 0, 1, 1, 1)."""

    def __init__(self, shape, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        shape = tuple(shape)
        self.t_left = nn.Parameter(torch.zeros(shape, device=dev))
        self.a_left = nn.Parameter(torch.ones(shape, device=dev))
        self.t_right = nn.Parameter(torch.ones(shape, device=dev))
        self.a_right = nn.Parameter(torch.ones(shape, device=dev))

    def forward(self, x):
        y = torch.where(x >= self.t_right,
                        self.t_right + self.a_right * (x - self.t_right), x)
        return torch.where(y <= self.t_left,
                           self.t_left + self.a_left * (y - self.t_left), y)


class ELU(Module):
    """alpha·(exp(x) − 1) for x ≤ 0, else x."""

    def __init__(self, alpha: float = 1.0, ip: bool = False):
        super().__init__()
        self.alpha = float(alpha)

    def forward(self, x):
        return torch.where(x > 0, x, self.alpha * torch.expm1(x))


class SoftPlus(Module):
    """log(1 + exp(beta·x)) / beta."""

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = float(beta)

    def forward(self, x):
        return F.softplus(self.beta * x) / self.beta


class SoftSign(Module):
    def forward(self, x):
        return x / (1.0 + torch.abs(x))


class SoftShrink(Module):
    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = float(lambd)

    def forward(self, x):
        return torch.sign(x) * torch.clamp(torch.abs(x) - self.lambd,
                                           min=0.0)


class HardShrink(Module):
    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = float(lambd)

    def forward(self, x):
        return torch.where(torch.abs(x) > self.lambd, x, _zero(x))


class TanhShrink(Module):
    def forward(self, x):
        return x - torch.tanh(x)


class SoftMax(Module):
    """Softmax over ``axis`` (the last by default)."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return torch.softmax(x, dim=self.axis)


class SoftMin(Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return torch.softmax(-x, dim=self.axis)


class LogSoftMax(Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return torch.log_softmax(x, dim=self.axis)


class LogSigmoid(Module):
    def forward(self, x):
        return F.logsigmoid(x)


class Threshold(Module):
    """x if x > th else v."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False):
        super().__init__()
        self.th, self.v = float(th), float(v)

    def forward(self, x):
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


class BinaryThreshold(Module):
    """1 if x > th else 0."""

    def __init__(self, th: float = 1e-6):
        super().__init__()
        self.th = float(th)

    def forward(self, x):
        return (x > self.th).to(x.dtype)


class Clamp(HardTanh):
    """HardTanh with integer bounds."""

    def __init__(self, min_value: int, max_value: int):
        super().__init__(float(min_value), float(max_value))


class Power(Module):
    """(shift + scale·x) ^ power."""

    def __init__(self, power: float, scale: float = 1.0,
                 shift: float = 0.0):
        super().__init__()
        self.power, self.scale = float(power), float(scale)
        self.shift = float(shift)

    def forward(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class Square(Module):
    def forward(self, x):
        return x * x


class Sqrt(Module):
    def forward(self, x):
        return torch.sqrt(x)


class Log(Module):
    def forward(self, x):
        return torch.log(x)


class Exp(Module):
    def forward(self, x):
        return torch.exp(x)


class Abs(Module):
    def forward(self, x):
        return torch.abs(x)


class Negative(Module):
    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, x):
        return -x


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lambd):
        ctx.lambd = lambd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lambd * g, None


class GradientReversal(Module):
    """Identity forward, −lambda·grad backward (domain-adversarial
    training)."""

    def __init__(self, lambd: float = 1.0):
        super().__init__()
        self.lambd = float(lambd)

    def forward(self, x):
        return _GradReverse.apply(x, self.lambd)


class AddConstant(Module):
    def __init__(self, constant_scalar: float, ip: bool = False):
        super().__init__()
        self.constant_scalar = float(constant_scalar)

    def forward(self, x):
        return x + self.constant_scalar


class MulConstant(Module):
    def __init__(self, scalar: float, ip: bool = False):
        super().__init__()
        self.scalar = float(scalar)

    def forward(self, x):
        return x * self.scalar


class GELU(Module):
    """Gaussian error linear unit, tanh-approximated by default."""

    def __init__(self, approximate: bool = True):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate="tanh" if self.approximate else "none")


class Swish(Module):
    def forward(self, x):
        return x * torch.sigmoid(x)
