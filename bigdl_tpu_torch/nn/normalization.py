"""Normalisation layers (counterpart of ``LayerNormalization``,
``BatchNormalization`` and ``SpatialBatchNormalization`` in
``bigdl_tpu/nn/normalization.py``).

BatchNorm keeps the reference's arithmetic: shifted one-pass batch
statistics in f32 with K = running_mean (detached), so E[x-K] and
E[(x-K)^2] are two independent sums; the running buffers move by the
reference's momentum rule with the unbiased variance, and are ASSIGNED in
train mode (the port's ``Optimizer`` carries them back to the float32
buffers under a compute dtype); the normalize subtracts first, in f32,
and casts back to x's dtype.  ``batch_stats``, ``fold_stats``,
``normalize`` and ``stat_count`` are separate methods because the fused
conv+BN path (``models/resnet.py``) shares them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module

__all__ = ["LayerNormalization", "BatchNormalization",
           "SpatialBatchNormalization"]


class LayerNormalization(Module):
    """LayerNorm over the last axis: (x - mean) * rsqrt(var + eps) * w + b,
    with the population variance and eps 1e-6."""

    def __init__(self, hidden_size: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=dev))
        self.bias = nn.Parameter(torch.zeros(hidden_size, device=dev))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias,
                            self.eps)


class BatchNormalization(Module):
    """BatchNorm over the feature (last) axis of [batch, feat] (reference
    nn/BatchNormalization.scala; eps and momentum defaults match).  The
    weight is drawn from U(0, 1) unless ``init_weight`` is given; the bias
    starts at zero."""

    reduce_dims = (0,)

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.n_output = n_output
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.affine = affine
        if affine:
            if init_weight is None:
                if generator is None:
                    raise ValueError("BatchNormalization draws its weight "
                                     "from U(0, 1): pass generator= (or "
                                     "init_weight=)")
                init_weight = torch.rand((n_output,), generator=generator)
            if init_bias is None:
                init_bias = torch.zeros(n_output)
            self.weight = nn.Parameter(torch.as_tensor(
                init_weight, dtype=torch.float32).to(dev))
            self.bias = nn.Parameter(torch.as_tensor(
                init_bias, dtype=torch.float32).to(dev))
        self.register_buffer("running_mean", torch.zeros(n_output,
                                                         device=dev))
        self.register_buffer("running_var", torch.ones(n_output, device=dev))

    def batch_stats(self, x):
        """(E[x-K], E[(x-K)^2]) in f32 over ``reduce_dims``, K the running
        mean as a constant."""
        k = self.running_mean.detach().float()
        xs = x.float() - k
        return xs.mean(self.reduce_dims), (xs * xs).mean(self.reduce_dims)

    def fold_stats(self, d_mean, d_sq, n: int):
        """(mean, var) from the shifted statistics; assigns the running
        buffers (momentum and the unbiased correction, the reference's
        update: ``(1 - m) * running`` keeps the buffer's dtype, the sum
        with ``m * mean`` is f32)."""
        k = self.running_mean.detach().float()
        var = torch.clamp(d_sq - d_mean * d_mean, min=0.0)
        mean = k + d_mean
        m = self.momentum
        with torch.no_grad():
            self.running_mean = (1 - m) * self.running_mean + m * mean
            unbiased = var * n / max(n - 1, 1)
            self.running_var = (1 - m) * self.running_var + m * unbiased
        return mean, var

    def normalize(self, x, mean, var):
        """(x - mean) * rsqrt(var + eps) * weight + bias in f32, cast to
        x's dtype."""
        inv = torch.rsqrt(var.float() + self.eps)
        scale = inv * self.weight.float() if self.affine else inv
        y = (x.float() - mean.float()) * scale
        if self.affine:
            y = y + self.bias.float()
        return y.to(x.dtype)

    def stat_count(self, x) -> int:
        n = 1
        for d in self.reduce_dims:
            n *= x.shape[d]
        return n

    def forward(self, x):
        if self.training:
            d_mean, d_sq = self.batch_stats(x)
            mean, var = self.fold_stats(d_mean, d_sq, self.stat_count(x))
        else:
            mean, var = self.running_mean, self.running_var
        return self.normalize(x, mean, var)


class SpatialBatchNormalization(BatchNormalization):
    """BatchNorm over NHWC images, per channel (reference
    nn/SpatialBatchNormalization.scala); NCHW through ``data_format``."""

    reduce_dims = (0, 1, 2)

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None,
                 data_format: str = "NHWC", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(n_output, eps, momentum, affine, init_weight,
                         init_bias, generator=generator, device=device)
        self.data_format = data_format

    def forward(self, x):
        if self.data_format == "NCHW":
            return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return super().forward(x)
