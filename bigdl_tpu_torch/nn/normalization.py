"""Normalisation layers (counterpart of ``bigdl_tpu/nn/normalization.py``,
whole).

BatchNorm keeps the reference's arithmetic: shifted one-pass batch
statistics in f32 with K = running_mean (detached), so E[x-K] and
E[(x-K)^2] are two independent sums; the running buffers move by the
reference's momentum rule with the unbiased variance, and are ASSIGNED in
train mode (the port's ``Optimizer`` carries them back to the float32
buffers under a compute dtype); the normalize subtracts first, in f32,
and casts back to x's dtype.  ``batch_stats``, ``fold_stats``,
``normalize`` and ``stat_count`` are separate methods because the fused
conv+BN path (``models/resnet.py``) shares them.

The rest keeps the reference's forms, channel last: the cross-map LRN is
a windowed sum of x^2 over channels padded (half, size - 1 - half), then
``x * (k + alpha / size * acc) ** -beta`` (``F.local_response_norm``
pads and divides its own way); the within-channel LRN the same over a
size x size spatial window with k = 1; the subtractive, divisive and
contrastive normalizations take their kernel-weighted local sums over
every channel by a SAME convolution and correct the border by the kernel
mass inside the image, the normalised kernel a persistent buffer
``kernel`` as the reference's bare array.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.nn.conv import same_pads
from bigdl_tpu_torch.nn.linear import CAdd, CMul

__all__ = [
    "BatchNormalization", "SpatialBatchNormalization", "LayerNormalization",
    "Normalize", "NormalizeScale", "SpatialCrossMapLRN",
    "SpatialWithinChannelLRN", "Scale", "SpatialSubtractiveNormalization",
    "SpatialDivisiveNormalization", "SpatialContrastiveNormalization",
    "GroupNorm",
]


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
        x's dtype.  In evaluation mode the reciprocal square root is
        taken in float64 (1 / sqrt, each correctly rounded) and rounded
        once to float32, so the card and the host give the same bits from
        the same running statistics: the card's float32 ``torch.rsqrt``
        and ``torch.sqrt`` are approximate, one ulp off on some channels,
        which an int8 layer after the norm turns into int8 steps.  In
        training the batch statistics already differ by their summation
        order, and ``rsqrt`` keeps the step's launches (three fewer a
        norm)."""
        var = var.float() + self.eps
        inv = torch.rsqrt(var) if self.training else \
            torch.reciprocal(torch.sqrt(var.double())).float()
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


class Normalize(Module):
    """x / (||x||_p + eps) over the last axis; p = inf takes max |x|
    (reference nn/Normalize.scala)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10):
        super().__init__()
        self.p, self.eps = float(p), float(eps)

    def forward(self, x):
        if self.p == float("inf"):
            norm = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        else:
            norm = torch.sum(torch.abs(x) ** self.p, dim=-1,
                             keepdim=True) ** (1.0 / self.p)
        return x / (norm + self.eps)


class NormalizeScale(Module):
    """Lp-normalise over the last axis, then a learnable scale of shape
    ``size`` starting at ``scale`` (reference nn/NormalizeScale.scala,
    SSD's conv4_3); a scale of the channel count multiplies per
    channel."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10,
                 scale: float = 1.0, size=None, w_regularizer=None, *,
                 device=None):
        super().__init__()
        self.p, self.eps = float(p), float(eps)
        size = tuple(size) if size is not None else (1,)
        self.weight = nn.Parameter(torch.full(size, float(scale),
                                              device=resolve_device(device)))

    def forward(self, x):
        norm = torch.sum(torch.abs(x) ** self.p, dim=-1,
                         keepdim=True) ** (1.0 / self.p)
        y = x / (norm + self.eps)
        if self.weight.numel() == x.shape[-1]:
            return y * self.weight.reshape((1,) * (x.dim() - 1) + (-1,))
        return y * self.weight


def _window_sum_last(sq, size: int):
    """Sum of ``size`` neighbours along the last axis, padded (half,
    size - 1 - half) with zeros."""
    half = (size - 1) // 2
    padded = F.pad(sq, (half, size - 1 - half))
    c = sq.shape[-1]
    acc = padded[..., 0:c]
    for j in range(1, size):
        acc = acc + padded[..., j:j + c]
    return acc


class SpatialCrossMapLRN(Module):
    """AlexNet's local response normalisation across channels (reference
    nn/SpatialCrossMapLRN.scala), NHWC (NCHW through ``data_format``)."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, k: float = 1.0,
                 data_format: str = "NHWC"):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        if self.data_format == "NCHW":
            x = x.permute(0, 2, 3, 1)
        acc = _window_sum_last(x * x, self.size)
        y = x * torch.pow(self.k + self.alpha / self.size * acc, -self.beta)
        if self.data_format == "NCHW":
            y = y.permute(0, 3, 1, 2)
        return y


class SpatialWithinChannelLRN(Module):
    """Local response normalisation within each channel over a size x
    size window (reference nn/SpatialWithinChannelLRN.scala), NHWC."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75):
        super().__init__()
        self.size, self.alpha, self.beta = size, alpha, beta

    def forward(self, x):
        size = self.size
        half = (size - 1) // 2
        sq = (x * x).permute(0, 3, 1, 2)
        padded = F.pad(sq, (half, size - 1 - half, half, size - 1 - half))
        acc = F.avg_pool2d(padded, size, 1, divisor_override=1) \
            .permute(0, 2, 3, 1)
        return x * torch.pow(1.0 + self.alpha / (size * size) * acc,
                             -self.beta)


class Scale(Module):
    """A learnable broadcast gain then bias: ``CMul`` followed by
    ``CAdd`` (reference nn/Scale.scala)."""

    def __init__(self, size, *, generator: torch.Generator, device=None):
        super().__init__()
        self.cmul = CMul(size, generator=generator, device=device)
        self.cadd = CAdd(size, generator=generator, device=device)

    def forward(self, x):
        return self.cadd(self.cmul(x))


def _local_kernel_sum(x, kernel):
    """The kernel-weighted local sum over (H, W) and every channel of
    NHWC ``x``, SAME padding: (B, H, W, 1)."""
    kh, kw = kernel.shape
    summed = torch.sum(x, dim=-1, keepdim=True).permute(0, 3, 1, 2)
    top, bottom = same_pads(summed.shape[2], kh, 1)
    left, right = same_pads(summed.shape[3], kw, 1)
    summed = F.pad(summed, (left, right, top, bottom))
    y = F.conv2d(summed, kernel.to(x.dtype).reshape(1, 1, kh, kw))
    return y.permute(0, 2, 3, 1)


def _normalised_kernel(kernel, n_input_plane: int, device):
    """The 2-D kernel (a 1-D one as its outer product; 9 x 9 ones by
    default) divided by its sum times the input planes."""
    kernel = torch.ones((9, 9)) if kernel is None else \
        torch.as_tensor(kernel, dtype=torch.float32)
    if kernel.dim() == 1:
        kernel = kernel[:, None] * kernel[None, :]
    return (kernel / (kernel.sum() * n_input_plane)).to(device)


class SpatialSubtractiveNormalization(Module):
    """Subtract the kernel-weighted local mean over every channel
    (reference nn/SpatialSubtractiveNormalization.scala); at the border
    the mean is divided by the kernel mass inside the image."""

    def __init__(self, n_input_plane: int = 1, kernel=None, *, device=None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.register_buffer("kernel", _normalised_kernel(
            kernel, n_input_plane, resolve_device(device)))

    def forward(self, x):
        mean = _local_kernel_sum(x, self.kernel)
        coef = _local_kernel_sum(torch.ones_like(x), self.kernel)
        return x - mean / torch.clamp(coef, min=1e-12)


class SpatialDivisiveNormalization(Module):
    """Divide by the local standard deviation, thresholded (reference
    nn/SpatialDivisiveNormalization.scala): below ``threshold`` (by
    default the mean local deviation over the whole input) it is
    replaced by ``thresval``."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: Optional[float] = None,
                 thresval: Optional[float] = None, *, device=None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.register_buffer("kernel", _normalised_kernel(
            kernel, n_input_plane, resolve_device(device)))
        self.threshold = threshold
        self.thresval = thresval

    def forward(self, x):
        sq = _local_kernel_sum(x * x, self.kernel)
        coef = _local_kernel_sum(torch.ones_like(x), self.kernel)
        localstd = torch.sqrt(torch.clamp(
            sq / torch.clamp(coef, min=1e-12), min=0.0))
        if self.threshold is None:
            thr = val = torch.mean(localstd)
        else:
            thr = self.threshold
            val = self.thresval if self.thresval is not None else thr
        denom = torch.where(localstd < thr, val, localstd)
        return x / torch.clamp(denom, min=1e-12)


class SpatialContrastiveNormalization(Module):
    """Subtractive then divisive local normalisation (reference
    nn/SpatialContrastiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: Optional[float] = None,
                 thresval: Optional[float] = None, *, device=None):
        super().__init__()
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel,
                                                   device=device)
        self.div = SpatialDivisiveNormalization(
            n_input_plane, kernel, threshold, thresval, device=device)

    def forward(self, x):
        return self.div(self.sub(x))


class GroupNorm(Module):
    """Group normalisation over the channel (last) axis (reference
    nn/normalization.py's GroupNorm, behind MaskRCNN's useGn): the
    groups halve until they divide the channels; mean and population
    variance over the spatial dims and the group's channels."""

    def __init__(self, n_output: int, n_groups: int = 32,
                 eps: float = 1e-5, affine: bool = True, *, device=None):
        super().__init__()
        while n_output % n_groups != 0:
            n_groups //= 2
        self.n_groups = max(n_groups, 1)
        self.eps = float(eps)
        self.affine = affine
        if affine:
            dev = resolve_device(device)
            self.weight = nn.Parameter(torch.ones(n_output, device=dev))
            self.bias = nn.Parameter(torch.zeros(n_output, device=dev))

    def forward(self, x):
        shape = x.shape
        c, g = shape[-1], self.n_groups
        xg = x.reshape(tuple(shape[:-1]) + (g, c // g))
        dims = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
        mean = torch.mean(xg, dim=dims, keepdim=True)
        var = torch.var(xg, dim=dims, keepdim=True, unbiased=False)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(shape)
        if self.affine:
            y = y * self.weight + self.bias
        return y
