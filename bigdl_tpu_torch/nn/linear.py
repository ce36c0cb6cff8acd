"""Dense layers (counterpart of ``bigdl_tpu/nn/linear.py``: ``Linear``,
``CMul``, ``CAdd`` and ``LookupTable``; the rest of that file waits,
ROADMAP.md queue 1, item 9b).

Weight layout stays Torch-style (out, in).  Initial values are drawn on
the CPU from the caller's ``torch.Generator`` (so one seed gives the
same weights whatever the device) and then moved to ``device``; they
follow the reference's distributions, not its bits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module

__all__ = ["Linear", "CMul", "CAdd", "LookupTable"]


def _uniform(shape, bound: float, generator: torch.Generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class Linear(Module):
    """y = x W^T + b.  W ~ U(-1/sqrt(in), 1/sqrt(in)) (the reference's
    default ``RandomUniform``) unless an ``init_method`` of
    :mod:`bigdl_tpu_torch.core.init` is given; b ~ U(-1/sqrt(in),
    1/sqrt(in)).  ``w_regularizer``/``b_regularizer``
    (``optim/regularizer.py``) are applied to the gradients by the
    ``Optimizer``'s step."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, *, generator: torch.Generator,
                 device=None, init_method=None):
        super().__init__()
        dev = resolve_device(device)
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        bound = 1.0 / math.sqrt(max(input_size, 1))
        if init_method is None:
            weight = _uniform((output_size, input_size), bound, generator)
        else:
            weight = init_method((output_size, input_size),
                                 generator=generator, fan_in=input_size,
                                 fan_out=output_size)
        self.weight = nn.Parameter(weight.to(dev))
        if with_bias:
            self.bias = nn.Parameter(
                _uniform((output_size,), bound, generator).to(dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class CMul(Module):
    """A learnable componentwise gain broadcast over the batch (reference
    nn/CMul.scala); weight ~ U(-1/sqrt(n), 1/sqrt(n)), n its size."""

    def __init__(self, size, *, generator: torch.Generator, device=None):
        super().__init__()
        size = tuple(size)
        self.weight = nn.Parameter(_uniform(
            size, 1.0 / math.sqrt(math.prod(size)), generator).to(
                resolve_device(device)))

    def forward(self, x):
        return x * self.weight


class CAdd(Module):
    """A learnable componentwise bias (reference nn/CAdd.scala); bias ~
    U(-1/sqrt(n), 1/sqrt(n)).  ``b_regularizer`` is accepted and unused,
    as in the reference."""

    def __init__(self, size, b_regularizer=None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        size = tuple(size)
        self.bias = nn.Parameter(_uniform(
            size, 1.0 / math.sqrt(math.prod(size)), generator).to(
                resolve_device(device)))

    def forward(self, x):
        return x + self.bias


class LookupTable(Module):
    """Embedding lookup; indices are 1-based (the reference/Torch
    convention) and clipped into range.  Weight ~ N(0, 1)."""

    def __init__(self, n_index: int, n_output: int, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.n_index, self.n_output = n_index, n_output
        self.weight = nn.Parameter(
            torch.randn((n_index, n_output), generator=generator).to(dev))

    def forward(self, indices):
        idx = (torch.as_tensor(indices, device=self.weight.device).long()
               - 1).clamp(0, self.n_index - 1)
        return self.weight[idx]
