"""Stochastic regularization layers (counterpart of
``bigdl_tpu/nn/regularization.py``, whole).

Every random draw comes from the generator of the forward context
(:func:`bigdl_tpu_torch.core.module.next_generator`), never from torch's
global RNG, so a run's masks are a function of the generator its caller
seeded, remat's recompute draws them again, and a CUDA graph replays
them from its registered generator.  Without a generator in scope a
training-mode layer raises, as the reference's does without a key.  In
eval mode the dropout and noise layers return their input; the
reference's ``GaussianSampler`` draws in either mode, and so does this
one.  The masks cannot match the reference's bits (JAX's threefry and
torch's philox differ); their arithmetic does: a kept entry is ``x / (1
- p)``, a dropped one 0.

The penalty layers are identities that store their penalty in the
buffer ``loss`` (a persistent buffer, as the reference's bare array is,
on ``device``), differentiable in the forward that computed it.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module, dropout, next_generator

__all__ = [
    "Dropout", "SpatialDropout1D", "SpatialDropout2D", "SpatialDropout3D",
    "GaussianDropout", "GaussianNoise", "GaussianSampler",
    "ActivityRegularization", "L1Penalty", "NegativeEntropyPenalty",
]


def _keep(shape, p: float, device) -> torch.Tensor:
    """A keep mask ~ Bernoulli(1 - p) from the generator in scope."""
    return torch.rand(shape, generator=next_generator(),
                      device=device) < 1.0 - p


def _normal(shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=next_generator(), device=device)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


class Dropout(Module):
    """Zero each entry with probability ``init_p`` in training, the kept
    ones scaled by 1 / (1 - p) when ``scale`` (reference
    nn/Dropout.scala).  ``inplace`` is accepted and changes nothing."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True):
        super().__init__()
        self.p = float(init_p)
        self.scale = scale

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        if self.scale:
            return dropout(x, self.p)
        return torch.where(_keep(x.shape, self.p, x.device), x, _zero(x))


class _SpatialDropoutND(Module):
    """Drop whole feature maps, channel last: one draw per (batch,
    channel), broadcast over the spatial dims; no rescaling."""

    def __init__(self, init_p: float = 0.5):
        super().__init__()
        self.p = float(init_p)

    def _drop(self, x, mask_shape):
        if not self.training or self.p <= 0.0:
            return x
        return torch.where(_keep(mask_shape, self.p, x.device), x, _zero(x))

    def forward(self, x):
        return self._drop(x, (x.shape[0],) + (1,) * (x.dim() - 2)
                          + (x.shape[-1],))


class SpatialDropout1D(_SpatialDropoutND):
    """(reference nn/SpatialDropout1D.scala)"""


class SpatialDropout2D(_SpatialDropoutND):
    """(reference nn/SpatialDropout2D.scala); channel first with
    ``data_format="NCHW"``."""

    def __init__(self, init_p: float = 0.5, data_format: str = "NHWC"):
        super().__init__(init_p)
        self.data_format = data_format

    def forward(self, x):
        if self.data_format == "NCHW":
            return self._drop(x, (x.shape[0], x.shape[1])
                              + (1,) * (x.dim() - 2))
        return super().forward(x)


class SpatialDropout3D(SpatialDropout2D):
    """(reference nn/SpatialDropout3D.scala)"""


class GaussianDropout(Module):
    """Multiply by N(1, rate / (1 - rate)) in training (reference
    nn/GaussianDropout.scala)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        if not self.training:
            return x
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + stddev * _normal(x.shape, x.device))


class GaussianNoise(Module):
    """Add N(0, stddev) in training (reference nn/GaussianNoise.scala)."""

    def __init__(self, stddev: float):
        super().__init__()
        self.stddev = float(stddev)

    def forward(self, x):
        if not self.training:
            return x
        return x + self.stddev * _normal(x.shape, x.device)


class GaussianSampler(Module):
    """mean + exp(log_var / 2) * eps, eps ~ N(0, 1), from the table
    (mean, log_var): the VAE's reparameterised sample (reference
    nn/GaussianSampler.scala)."""

    def forward(self, inputs):
        mean, log_var = inputs
        return mean + torch.exp(0.5 * log_var) * _normal(mean.shape,
                                                         mean.device)


class _Penalty(Module):
    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("loss", torch.zeros(
            (), device=resolve_device(device)))


class ActivityRegularization(_Penalty):
    """Identity recording l1 * sum|x| + l2 * sum x^2 in ``loss``
    (reference nn/ActivityRegularization.scala)."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0, *, device=None):
        super().__init__(device)
        self.l1, self.l2 = float(l1), float(l2)

    def forward(self, x):
        self.loss = self.l1 * torch.sum(torch.abs(x)) \
            + self.l2 * torch.sum(x * x)
        return x


class L1Penalty(_Penalty):
    """Identity recording l1weight * sum|x| (divided by x's size with
    ``size_average``) in ``loss`` (reference nn/L1Penalty.scala)."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output: bool = True, *, device=None):
        super().__init__(device)
        self.l1weight = float(l1weight)
        self.size_average = size_average

    def forward(self, x):
        penalty = self.l1weight * torch.sum(torch.abs(x))
        if self.size_average:
            penalty = penalty / x.numel()
        self.loss = penalty
        return x


class NegativeEntropyPenalty(_Penalty):
    """Identity recording beta * sum x log(x + 1e-8), minus beta times
    the entropy of the distribution x, in ``loss`` (reference
    nn/NegativeEntropyPenalty.scala)."""

    def __init__(self, beta: float = 0.01, *, device=None):
        super().__init__(device)
        self.beta = float(beta)

    def forward(self, x):
        self.loss = self.beta * torch.sum(x * torch.log(x + 1e-8))
        return x
