"""Pooling and resize layers (counterpart of ``bigdl_tpu/nn/pooling.py``,
every class).

NHWC by default, NCHW through ``data_format``; the temporal pool takes
[batch, time, features], the volumetric ones NDHWC.  The padding is the
reference's explicit (lo, hi) per spatial dim, implementing its floor or
ceil output size; padded positions hold -inf for a max and 0 for an
average, as ``reduce_window`` pads them.  The gradient of a max pool goes
to the first maximum of each window, as both frameworks route it.
``ResizeBilinear`` without ``align_corners`` is ``jax.image.resize``'s
bilinear (half-pixel centres, antialiased when it shrinks): a weight
matrix per spatial dim from the triangle kernel (:func:`_resize_weights`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core.module import Module

__all__ = [
    "SpatialMaxPooling", "SpatialAveragePooling", "TemporalMaxPooling",
    "VolumetricMaxPooling", "VolumetricAveragePooling",
    "UpSampling1D", "UpSampling2D", "UpSampling3D", "ResizeBilinear",
    "GlobalAveragePooling2D", "GlobalAveragePooling3D",
    "GlobalMaxPooling3D",
]


def _pool_pads(in_size, k, s, pad, ceil_mode):
    """Explicit (lo, hi) padding of one spatial dim implementing the
    reference's floor/ceil output-size formula (pad -1 = SAME)."""
    if pad == -1:
        out = -(-in_size // s)
        total = max((out - 1) * s + k - in_size, 0)
        return (total // 2, total - total // 2)
    if ceil_mode:
        out = int(math.ceil((in_size + 2 * pad - k) / s)) + 1
        # Torch: the last window starts inside the (padded) input
        if (out - 1) * s >= in_size + pad:
            out -= 1
    else:
        out = int(math.floor((in_size + 2 * pad - k) / s)) + 1
    hi = max((out - 1) * s + k - in_size - pad, pad)
    return (pad, hi)


class SpatialMaxPooling(Module):
    """2-D max pool (reference nn/SpatialMaxPooling.scala).  The gradient
    goes to the first maximum of each window, as both frameworks route
    it."""

    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 data_format: str = "NHWC"):
        super().__init__()
        self.kernel = (kh, kw)
        self.stride = (dh or kh, dw or kw)
        self.pad = (pad_h, pad_w)
        self.ceil_mode = False
        self.data_format = data_format

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def forward(self, x):
        nchw = x if self.data_format == "NCHW" else x.permute(0, 3, 1, 2)
        (kh, kw), (sh, sw), (ph, pw) = self.kernel, self.stride, self.pad
        top, bottom = _pool_pads(nchw.shape[2], kh, sh, ph, self.ceil_mode)
        left, right = _pool_pads(nchw.shape[3], kw, sw, pw, self.ceil_mode)
        padded = F.pad(nchw, (left, right, top, bottom), value=-math.inf)
        y = F.max_pool2d(padded, (kh, kw), (sh, sw))
        return y if self.data_format == "NCHW" else y.permute(0, 2, 3, 1)


class SpatialAveragePooling(Module):
    """2-D average pool (reference nn/SpatialAveragePooling.scala): the
    window sums over zero padding, divided by the window's size
    (``count_include_pad``) or by the count of input entries in it, or
    not at all (``divide=False``)."""

    def __init__(self, kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 global_pooling: bool = False,
                 ceil_mode: bool = False,
                 count_include_pad: bool = True,
                 divide: bool = True,
                 data_format: str = "NHWC"):
        super().__init__()
        self.kernel = (kh, kw)
        self.stride = (dh, dw)
        self.pad = (pad_h, pad_w)
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide
        self.data_format = data_format

    def ceil(self):
        self.ceil_mode = True
        return self

    def forward(self, x):
        nchw = x if self.data_format == "NCHW" else x.permute(0, 3, 1, 2)
        if self.global_pooling:
            (kh, kw), (sh, sw), (ph, pw) = nchw.shape[2:], (1, 1), (0, 0)
        else:
            (kh, kw), (sh, sw), (ph, pw) = self.kernel, self.stride, self.pad
        top, bottom = _pool_pads(nchw.shape[2], kh, sh, ph, self.ceil_mode)
        left, right = _pool_pads(nchw.shape[3], kw, sw, pw, self.ceil_mode)
        pads = (left, right, top, bottom)

        def window_sums(t):
            return F.avg_pool2d(F.pad(t, pads), (kh, kw), (sh, sw),
                                divisor_override=1)

        y = window_sums(nchw)
        if self.divide:
            if self.count_include_pad:
                y = y / (kh * kw)
            else:
                y = y / window_sums(torch.ones_like(nchw[:1, :1]))
        return y if self.data_format == "NCHW" else y.permute(0, 2, 3, 1)


class GlobalAveragePooling2D(SpatialAveragePooling):
    """The mean over H and W, the spatial dims squeezed."""

    def __init__(self, data_format: str = "NHWC"):
        super().__init__(1, 1, global_pooling=True, data_format=data_format)

    def forward(self, x):
        y = super().forward(x)
        if self.data_format == "NHWC":
            return y[:, 0, 0, :]
        return y[:, :, 0, 0]


class GlobalAveragePooling3D(Module):
    """The mean over the three spatial dims of NDHWC (keras
    GlobalAveragePooling3D): [batch, channels]."""

    def forward(self, x):
        return x.mean(dim=(1, 2, 3))


class GlobalMaxPooling3D(Module):
    """The max over the three spatial dims of NDHWC (keras
    GlobalMaxPooling3D)."""

    def forward(self, x):
        return x.amax(dim=(1, 2, 3))


class TemporalMaxPooling(Module):
    """1-D max pool over [batch, time, features], no padding (reference
    nn/TemporalMaxPooling.scala); the stride defaults to the width."""

    def __init__(self, k_w: int, d_w: Optional[int] = None):
        super().__init__()
        self.k_w = k_w
        self.d_w = d_w or k_w

    def forward(self, x):
        return F.max_pool1d(x.transpose(1, 2), self.k_w,
                            self.d_w).transpose(1, 2)


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


class VolumetricMaxPooling(Module):
    """3-D max pool over NDHWC (reference nn/VolumetricMaxPooling.scala),
    symmetric -inf padding."""

    def __init__(self, k_t: int, k_w: int, k_h: int,
                 d_t: Optional[int] = None, d_w: Optional[int] = None,
                 d_h: Optional[int] = None,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0):
        super().__init__()
        self.kernel = (k_t, k_h, k_w)
        self.stride = (d_t or k_t, d_h or k_h, d_w or k_w)
        self.pad = (pad_t, pad_h, pad_w)

    def forward(self, x):
        pt, ph, pw = self.pad
        padded = F.pad(_ncdhw(x), (pw, pw, ph, ph, pt, pt), value=-math.inf)
        return _ndhwc(F.max_pool3d(padded, self.kernel, self.stride))


class VolumetricAveragePooling(Module):
    """3-D average pool over NDHWC (reference
    nn/VolumetricAveragePooling.scala): sums over zero padding, divided
    by the window's size (``count_include_pad``) or by the count of input
    entries in it; ``ceil_mode`` as the 2-D pool's."""

    def __init__(self, k_t: int, k_w: int, k_h: int,
                 d_t: Optional[int] = None, d_w: Optional[int] = None,
                 d_h: Optional[int] = None,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 count_include_pad: bool = True, ceil_mode: bool = False):
        super().__init__()
        self.kernel = (k_t, k_h, k_w)
        self.stride = (d_t or k_t, d_h or k_h, d_w or k_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.count_include_pad = count_include_pad
        self.ceil_mode = ceil_mode

    def forward(self, x):
        pads = []
        for size, k, st, p in reversed(list(zip(
                x.shape[1:4], self.kernel, self.stride, self.pad))):
            pads.extend(_pool_pads(size, k, st, p, self.ceil_mode))

        def window_sums(t):
            return F.avg_pool3d(F.pad(_ncdhw(t), pads), self.kernel,
                                self.stride, divisor_override=1)

        y = window_sums(x)
        if self.count_include_pad:
            y = y / math.prod(self.kernel)
        else:
            y = y / window_sums(torch.ones_like(x[:1, ..., :1]))
        return _ndhwc(y)


class UpSampling1D(Module):
    """Repeat each timestep ``length`` times (reference
    nn/UpSampling1D.scala)."""

    def __init__(self, length: int):
        super().__init__()
        self.length = length

    def forward(self, x):
        return x.repeat_interleave(self.length, dim=1)


class UpSampling2D(Module):
    """Nearest-neighbour upsampling by (h, w) (reference
    nn/UpSampling2D.scala)."""

    def __init__(self, size: Tuple[int, int], data_format: str = "NHWC"):
        super().__init__()
        self.size = tuple(size)
        self.data_format = data_format

    def forward(self, x):
        h, w = self.size
        dim = 1 if self.data_format == "NHWC" else 2
        return x.repeat_interleave(h, dim=dim).repeat_interleave(
            w, dim=dim + 1)


class UpSampling3D(Module):
    """Nearest-neighbour upsampling of NDHWC by (t, h, w) (reference
    nn/UpSampling3D.scala)."""

    def __init__(self, size: Tuple[int, int, int]):
        super().__init__()
        self.size = tuple(size)

    def forward(self, x):
        t, h, w = self.size
        return x.repeat_interleave(t, dim=1).repeat_interleave(
            h, dim=2).repeat_interleave(w, dim=3)


def _linspace_to(stop: int, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0, stop, num)`` in float32, bit for bit: stop x
    (i / (num - 1)) and the end point exactly."""
    if num == 1:
        return torch.zeros(1, device=device)
    step = torch.arange(num - 1, dtype=torch.float32) / (num - 1)
    return torch.cat([stop * step, torch.tensor([float(stop)])]).to(device)


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """The [in, out] weights of ``jax.image.resize``'s bilinear along one
    dim (scale out / in, no translation): the triangle kernel at the
    half-pixel sample points, widened by in / out when shrinking
    (antialiasing), each column normalised, columns sampled outside the
    input zeroed."""
    inv_scale = 1.0 / torch.tensor(out_size / in_size, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[
        :, None]).abs() / kernel_scale
    w = torch.clamp(1 - x.abs(), min=0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(
        torch.float32).eps), w / torch.where(total != 0, total, 1.0),
        torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


class ResizeBilinear(Module):
    """Bilinear resize to (output_height, output_width) (reference
    nn/ResizeBilinear.scala): with ``align_corners`` the corners' samples
    map onto each other (explicit gathers, as the reference's), else
    ``jax.image.resize``'s bilinear."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False, data_format: str = "NHWC"):
        super().__init__()
        self.out_size = (output_height, output_width)
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        nchw = self.data_format == "NCHW"
        if nchw:
            x = x.permute(0, 2, 3, 1)
        oh, ow = self.out_size
        h, w = x.shape[1], x.shape[2]
        if self.align_corners:
            ys = _linspace_to(h - 1, oh, x.device)
            xs = _linspace_to(w - 1, ow, x.device)
            y0, x0 = ys.floor().long(), xs.floor().long()
            y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
            wy = (ys - y0)[None, :, None, None].to(x.dtype)
            wx = (xs - x0)[None, None, :, None].to(x.dtype)

            def g(yi, xi):
                return x[:, yi][:, :, xi]

            y = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y1, x0) * wy * (1 - wx)
                 + g(y0, x1) * (1 - wy) * wx + g(y1, x1) * wy * wx)
        else:
            wh = _resize_weights(h, oh, x.device).to(x.dtype)
            ww = _resize_weights(w, ow, x.device).to(x.dtype)
            y = torch.einsum("nhwc,hH,wW->nHWc", x, wh, ww)
        return y.permute(0, 3, 1, 2) if nchw else y
