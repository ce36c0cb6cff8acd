"""2-D and 3-D convolution (counterpart of ``SpatialConvolution``,
``SpatialShareConvolution``, ``SpatialDilatedConvolution``,
``SpatialFullConvolution`` and ``VolumetricConvolution`` in
``bigdl_tpu/nn/conv.py``).

The layout is the reference's: NHWC activations by default (NCHW
accepted through ``data_format``) and an HWIO weight ``(kh, kw, in /
groups, out)``, so reference weights load by name without a transpose.
The product goes to ``F.conv2d`` on permuted views (an NHWC tensor viewed
as NCHW is channels-last in memory, which cuDNN takes as it is).
Positional arguments follow the reference's order (nInputPlane,
nOutputPlane, kernelW, kernelH, strideW, strideH, padW, padH, nGroup),
the rest are keywords; a pad of -1 means SAME padding.
``w_regularizer``/``b_regularizer`` (``optim/regularizer.py``) are
applied to the gradients by the ``Optimizer``'s step.  ``init_weight``
/ ``init_bias`` give the initial weight (HWIO) and bias as they are;
``propagate_back`` is accepted and, as in the reference, changes nothing
(the input gradient is computed either way).  The volumetric
convolution takes NDHWC (NCDHW through ``data_format``) and a DHWIO
weight; a temporal pad of -1 means SAME in all three dims, as there.
The dilated convolution keeps the HWIO weight and takes SAME padding over
the dilated kernel's extent, as XLA does.  The transposed (full)
convolution keeps the reference's HWIO weight ``(kh, kw, in / groups,
out)``, whose lhs-dilated product over the spatially flipped kernel is
``F.conv_transpose2d`` over the same weight unflipped, regrouped to
``(in, out / groups, kh, kw)`` (:func:`_full_weight`); its pads and
``adj`` crop or zero-pad the full output, so any ``adj`` works.  The
3-D transposed convolution keeps the reference's (kt, kh, kw, in, out)
weight the same way.  The separable convolution is a depthwise product
(``groups`` = in) then a pointwise one; the temporal one takes [batch,
time, in] and a (kw, in, out) weight; ``LocallyConnected2D`` multiplies
``F.unfold``'s patches (ordered (c, kh, kw), as
``conv_general_dilated_patches`` orders them) by a weight per output
position; ``SpatialConvolutionMap`` masks a dense HWIO weight by its
connection table (the ``mask`` buffer).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module

__all__ = [
    "SpatialConvolution", "SpatialDilatedConvolution",
    "SpatialFullConvolution", "SpatialSeparableConvolution",
    "SpatialShareConvolution", "TemporalConvolution",
    "VolumetricConvolution", "VolumetricFullConvolution",
    "LocallyConnected2D", "LocallyConnected1D", "SpatialConvolutionMap",
]


def same_pads(size: int, k: int, s: int):
    """(lo, hi) SAME padding of one spatial dim, as XLA computes it."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _uniform(shape, bound: float, generator: torch.Generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def _needed(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("a random initial value needs generator= "
                         "(or init_weight= / init_bias=)")
    return generator


def _given(value, shape, what: str) -> torch.Tensor:
    t = torch.as_tensor(value, dtype=torch.float32).detach().clone().cpu()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, not "
                         f"{tuple(shape)}")
    return t


def _conv2d(nchw, weight, bias, stride, pad, dilation=(1, 1), groups=1):
    """``F.conv2d`` of an NCHW input by an HWIO ``weight``; a pad of -1
    is SAME over the dilated kernel's extent, as XLA takes it (split
    unevenly, it pads the input first)."""
    pad_h, pad_w = pad
    if pad_h == -1 or pad_w == -1:
        (kh, kw), (dh, dw) = weight.shape[:2], dilation
        top, bottom = same_pads(nchw.shape[2], (kh - 1) * dh + 1, stride[0])
        left, right = same_pads(nchw.shape[3], (kw - 1) * dw + 1, stride[1])
    else:
        top, bottom, left, right = pad_h, pad_h, pad_w, pad_w
    if top == bottom and left == right:
        padding = (top, left)
    else:
        nchw = F.pad(nchw, (left, right, top, bottom))
        padding = (0, 0)
    return F.conv2d(nchw, weight.permute(3, 2, 0, 1), bias, stride=stride,
                    padding=padding, dilation=dilation, groups=groups)


def _check_format(data_format: str):
    if data_format not in ("NHWC", "NCHW"):
        raise ValueError(f"data_format must be NHWC or NCHW, got "
                         f"{data_format!r}")


class SpatialConvolution(Module):
    """2-D convolution (reference nn/SpatialConvolution.scala)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, *, with_bias: bool = True,
                 data_format: str = "NHWC", init_method=None,
                 w_regularizer=None, b_regularizer=None,
                 init_weight=None, init_bias=None,
                 propagate_back: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"do not split into {n_group} groups")
        _check_format(data_format)
        dev = resolve_device(device)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        self.n_group = n_group
        self.with_bias = with_bias
        self.data_format = data_format
        fan_in = n_input_plane // n_group * kernel_h * kernel_w
        fan_out = n_output_plane // n_group * kernel_h * kernel_w
        shape = (kernel_h, kernel_w, n_input_plane // n_group,
                 n_output_plane)
        if init_weight is not None:
            weight = _given(init_weight, shape, "init_weight")
        else:
            im = init_method or init_methods.RandomUniform()
            weight = im(shape, generator=_needed(generator), fan_in=fan_in,
                        fan_out=fan_out)
        self.weight = nn.Parameter(weight.to(dev))
        if with_bias:
            if init_bias is not None:
                bias = _given(init_bias, (n_output_plane,), "init_bias")
            else:
                bias = _uniform((n_output_plane,), 1.0 / math.sqrt(fan_in),
                                _needed(generator))
            self.bias = nn.Parameter(bias.to(dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        unbatched = x.dim() == 3
        if unbatched:
            x = x[None]
        nchw = x if self.data_format == "NCHW" else x.permute(0, 3, 1, 2)
        y = _conv2d(nchw, self.weight, self.bias, self.stride, self.pad,
                    groups=self.n_group)
        if self.data_format == "NHWC":
            y = y.permute(0, 2, 3, 1)
        return y[0] if unbatched else y


class SpatialShareConvolution(SpatialConvolution):
    """The reference's memory-sharing variant
    (nn/SpatialShareConvolution.scala): the same arithmetic."""


class SpatialDilatedConvolution(Module):
    """Atrous convolution (reference nn/SpatialDilatedConvolution.scala):
    weight (kh, kw, in, out) and bias ~ U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), fan_in = in * kh * kw.  The regularizer arguments
    are accepted and unused, as in the reference."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 dilation_w: int = 1, dilation_h: int = 1,
                 w_regularizer=None, b_regularizer=None,
                 data_format: str = "NHWC", with_bias: bool = True, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        _check_format(data_format)
        dev = resolve_device(device)
        self.kernel = (kh, kw)
        self.stride = (dh, dw)
        self.pad = (pad_h, pad_w)
        self.dilation = (dilation_h, dilation_w)
        self.data_format = data_format
        self.with_bias = with_bias
        bound = 1.0 / math.sqrt(n_input_plane * kh * kw)
        self.weight = nn.Parameter(_uniform(
            (kh, kw, n_input_plane, n_output_plane), bound,
            generator).to(dev))
        if with_bias:
            self.bias = nn.Parameter(
                _uniform((n_output_plane,), bound, generator).to(dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        nchw = x if self.data_format == "NCHW" else x.permute(0, 3, 1, 2)
        y = _conv2d(nchw, self.weight, self.bias, self.stride, self.pad,
                    self.dilation)
        return y if self.data_format == "NCHW" else y.permute(0, 2, 3, 1)


def _full_weight(weight, n_group: int):
    """The reference's HWIO weight (kh, kw, in / groups, out) of a
    transposed convolution as ``F.conv_transpose2d`` takes it: (in, out /
    groups, kh, kw), input channel g * in/groups + c of group g, and not
    flipped (the lhs-dilated product over the flipped kernel is the
    transposed product over the kernel as it stands)."""
    kh, kw, cin, cout = weight.shape
    return weight.reshape(kh, kw, cin, n_group, cout // n_group) \
        .permute(3, 2, 4, 0, 1).reshape(n_group * cin, cout // n_group,
                                          kh, kw)


class SpatialFullConvolution(Module):
    """Transposed convolution (reference nn/SpatialFullConvolution.scala):
    output size (in - 1) * stride - 2 * pad + kernel + adj; weight (kh,
    kw, in / groups, out) and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    fan_in = in * kh * kw.  The regularizer arguments are accepted and
    unused, as in the reference."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 adj_w: int = 0, adj_h: int = 0,
                 n_group: int = 1, no_bias: bool = False,
                 w_regularizer=None, b_regularizer=None,
                 data_format: str = "NHWC", *,
                 generator: torch.Generator, device=None):
        super().__init__()
        _check_format(data_format)
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"do not split into {n_group} groups")
        dev = resolve_device(device)
        self.kernel = (kh, kw)
        self.stride = (dh, dw)
        self.pad = (pad_h, pad_w)
        self.adj = (adj_h, adj_w)
        self.n_group = n_group
        self.with_bias = not no_bias
        self.data_format = data_format
        bound = 1.0 / math.sqrt(n_input_plane * kh * kw)
        self.weight = nn.Parameter(_uniform(
            (kh, kw, n_input_plane // n_group, n_output_plane), bound,
            generator).to(dev))
        if self.with_bias:
            self.bias = nn.Parameter(
                _uniform((n_output_plane,), bound, generator).to(dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        nchw = x if self.data_format == "NCHW" else x.permute(0, 3, 1, 2)
        y = F.conv_transpose2d(nchw, _full_weight(self.weight, self.n_group),
                               stride=self.stride, groups=self.n_group)
        # the full output is (in - 1) * stride + kernel: crop pad at each
        # end, then zero-pad adj at the far end (F.pad crops where < 0)
        (ph, pw), (ah, aw) = self.pad, self.adj
        if (ph, pw, ah, aw) != (0, 0, 0, 0):
            y = F.pad(y, (-pw, aw - pw, -ph, ah - ph))
        if self.with_bias:
            y = y + self.bias[:, None, None]
        return y if self.data_format == "NCHW" else y.permute(0, 2, 3, 1)


class VolumetricConvolution(Module):
    """3-D convolution over NDHWC (reference
    nn/VolumetricConvolution.scala); weight (kt, kh, kw, in, out) and bias
    ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)).  The regularizer arguments are
    accepted and unused, as in the reference."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 k_t: int, k_w: int, k_h: int,
                 d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, data_format: str = "NDHWC", *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if data_format not in ("NDHWC", "NCDHW"):
            raise ValueError(f"data_format must be NDHWC or NCDHW, got "
                             f"{data_format!r}")
        dev = resolve_device(device)
        self.kernel = (k_t, k_h, k_w)
        self.stride = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.with_bias = with_bias
        self.data_format = data_format
        bound = 1.0 / math.sqrt(n_input_plane * k_t * k_h * k_w)
        self.weight = nn.Parameter(_uniform(
            (k_t, k_h, k_w, n_input_plane, n_output_plane), bound,
            generator).to(dev))
        if with_bias:
            self.bias = nn.Parameter(
                _uniform((n_output_plane,), bound, generator).to(dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        ncdhw = x if self.data_format == "NCDHW" else x.permute(0, 4, 1, 2, 3)
        if self.pad[0] == -1:
            pads = [same_pads(size, k, s) for size, k, s in
                    zip(ncdhw.shape[2:], self.kernel, self.stride)]
        else:
            pads = [(p, p) for p in self.pad]
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            ncdhw = F.pad(ncdhw, [v for lo_hi in reversed(pads)
                                  for v in lo_hi])
            padding = (0, 0, 0)
        y = F.conv3d(ncdhw, self.weight.permute(4, 3, 0, 1, 2), self.bias,
                     stride=self.stride, padding=padding)
        return y if self.data_format == "NCDHW" else y.permute(0, 2, 3, 4, 1)


def _nchw(x, data_format):
    return x if data_format == "NCHW" else x.permute(0, 3, 1, 2)


class SpatialSeparableConvolution(Module):
    """A depthwise then a pointwise convolution (reference
    nn/SpatialSeparableConvolution.scala): ``depth_weight`` (kh, kw, 1, in
    * depth_multiplier) ~ U(-1/sqrt(kh kw), ...), ``point_weight`` (1, 1,
    in * depth_multiplier, out) ~ U(-1/sqrt(in * depth_multiplier), ...),
    a zero bias.  The regularizer arguments are accepted and unused, as
    in the reference."""

    def __init__(self, n_input_channel: int, n_output_channel: int,
                 depth_multiplier: int, kw: int, kh: int,
                 sw: int = 1, sh: int = 1, pw: int = 0, ph: int = 0,
                 has_bias: bool = True, data_format: str = "NHWC",
                 w_regularizer=None, b_regularizer=None,
                 p_regularizer=None, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        _check_format(data_format)
        dev = resolve_device(device)
        self.stride = (sh, sw)
        self.pad = (ph, pw)
        self.n_input_channel = n_input_channel
        self.depth_multiplier = depth_multiplier
        self.with_bias = has_bias
        self.data_format = data_format
        mid = n_input_channel * depth_multiplier
        self.depth_weight = nn.Parameter(_uniform(
            (kh, kw, 1, mid), 1.0 / math.sqrt(kh * kw), generator).to(dev))
        self.point_weight = nn.Parameter(_uniform(
            (1, 1, mid, n_output_channel), 1.0 / math.sqrt(mid),
            generator).to(dev))
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(n_output_channel,
                                                 device=dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        y = _conv2d(_nchw(x, self.data_format), self.depth_weight, None,
                    self.stride, self.pad, groups=self.n_input_channel)
        y = _conv2d(y, self.point_weight, None, (1, 1), (0, 0))
        if self.with_bias:
            y = y + self.bias[:, None, None]
        return y if self.data_format == "NCHW" else y.permute(0, 2, 3, 1)


class TemporalConvolution(Module):
    """1-D convolution over [batch, time, input_frame_size], no padding
    (reference nn/TemporalConvolution.scala); weight (kw, in, out) and
    bias ~ U(-1/sqrt(in kw), 1/sqrt(in kw)).  An unbatched [time, in]
    input gives [time', out].  ``propagate_back`` and the regularizer
    arguments are accepted and unused, as in the reference."""

    def __init__(self, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1,
                 propagate_back: bool = True, w_regularizer=None,
                 b_regularizer=None, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.stride_w = stride_w
        bound = 1.0 / math.sqrt(input_frame_size * kernel_w)
        self.weight = nn.Parameter(_uniform(
            (kernel_w, input_frame_size, output_frame_size), bound,
            generator).to(dev))
        self.bias = nn.Parameter(
            _uniform((output_frame_size,), bound, generator).to(dev))

    def forward(self, x):
        unbatched = x.dim() == 2
        if unbatched:
            x = x[None]
        y = F.conv1d(x.transpose(1, 2), self.weight.permute(2, 1, 0),
                     stride=self.stride_w).transpose(1, 2) + self.bias
        return y[0] if unbatched else y


class VolumetricFullConvolution(Module):
    """3-D transposed convolution over NDHWC (reference
    nn/VolumetricFullConvolution.scala): output (in - 1) * stride - 2 * pad
    + kernel + adj; weight (kt, kh, kw, in, out) ~ U(-1/sqrt(fan_in), ...),
    a zero bias.  ``n_group`` and the regularizer arguments are accepted
    and unused, as in the reference."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 k_t: int, k_w: int, k_h: int,
                 d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 adj_t: int = 0, adj_w: int = 0, adj_h: int = 0,
                 n_group: int = 1, no_bias: bool = False,
                 w_regularizer=None, b_regularizer=None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.kernel = (k_t, k_h, k_w)
        self.stride = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.adj = (adj_t, adj_h, adj_w)
        self.with_bias = not no_bias
        bound = 1.0 / math.sqrt(n_input_plane * k_t * k_h * k_w)
        self.weight = nn.Parameter(_uniform(
            (k_t, k_h, k_w, n_input_plane, n_output_plane), bound,
            generator).to(dev))
        if self.with_bias:
            self.bias = nn.Parameter(torch.zeros(n_output_plane, device=dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3),
                               self.weight.permute(3, 4, 0, 1, 2),
                               stride=self.stride)
        # crop pad at each end of the full output, zero-pad adj at the end
        (pt, ph, pw), (at, ah, aw) = self.pad, self.adj
        if (pt, ph, pw, at, ah, aw) != (0,) * 6:
            y = F.pad(y, (-pw, aw - pw, -ph, ah - ph, -pt, at - pt))
        if self.with_bias:
            y = y + self.bias[:, None, None, None]
        return y.permute(0, 2, 3, 4, 1)


class LocallyConnected2D(Module):
    """A convolution with unshared weights (reference
    nn/LocallyConnected2D.scala): weight (out_h, out_w, kh kw in, out) ~
    U(-1/sqrt(fan_in), ...), bias (out_h, out_w, out) zero, unless given
    as ``init_weight`` / ``init_bias``.  ``propagate_back`` and the
    regularizer arguments are accepted and unused, as in the
    reference."""

    def __init__(self, n_input_plane: int, input_width: int,
                 input_height: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 propagate_back: bool = True,
                 w_regularizer=None, b_regularizer=None,
                 init_weight=None, init_bias=None,
                 with_bias: bool = True, data_format: str = "NHWC", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _check_format(data_format)
        dev = resolve_device(device)
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        self.with_bias = with_bias
        self.data_format = data_format
        out_h = (input_height + 2 * pad_h - kernel_h) // stride_h + 1
        out_w = (input_width + 2 * pad_w - kernel_w) // stride_w + 1
        self.out_size = (out_h, out_w)
        shape = (out_h, out_w, kernel_h * kernel_w * n_input_plane,
                 n_output_plane)
        if init_weight is not None:
            weight = _given(init_weight, shape, "init_weight")
        else:
            weight = _uniform(shape, 1.0 / math.sqrt(
                n_input_plane * kernel_h * kernel_w), _needed(generator))
        self.weight = nn.Parameter(weight.to(dev))
        if with_bias:
            bshape = (out_h, out_w, n_output_plane)
            bias = (_given(init_bias, bshape, "init_bias")
                    if init_bias is not None else torch.zeros(bshape))
            self.bias = nn.Parameter(bias.to(dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        (oh, ow) = self.out_size
        cols = F.unfold(_nchw(x, self.data_format), self.kernel,
                        padding=self.pad, stride=self.stride)
        patches = cols.transpose(1, 2).reshape(x.shape[0], oh, ow, -1)
        y = torch.einsum("nhwk,hwko->nhwo", patches, self.weight)
        if self.with_bias:
            y = y + self.bias
        return y.permute(0, 3, 1, 2) if self.data_format == "NCHW" else y


class LocallyConnected1D(Module):
    """A temporal convolution with unshared weights per output frame
    (reference nn/LocallyConnected1D.scala) over [batch, time, in]: weight
    (n_out, out, kw, in) and bias (n_out, out) ~ U(-1/sqrt(kw in), ...),
    unless given.  ``propagate_back`` and the regularizer arguments are
    accepted and unused, as in the reference."""

    def __init__(self, n_input_frame: int, input_frame_size: int,
                 output_frame_size: int, kernel_w: int, stride_w: int = 1,
                 propagate_back: bool = True,
                 w_regularizer=None, b_regularizer=None,
                 init_weight=None, init_bias=None, with_bias: bool = True,
                 *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.with_bias = with_bias
        n_out = (n_input_frame - kernel_w) // stride_w + 1
        self.n_output_frame = n_out
        bound = 1.0 / math.sqrt(kernel_w * input_frame_size)
        shape = (n_out, output_frame_size, kernel_w, input_frame_size)
        weight = (_given(init_weight, shape, "init_weight")
                  if init_weight is not None
                  else _uniform(shape, bound, _needed(generator)))
        self.weight = nn.Parameter(weight.to(dev))
        if with_bias:
            bias = (_given(init_bias, (n_out, output_frame_size),
                           "init_bias") if init_bias is not None
                    else _uniform((n_out, output_frame_size), bound,
                                  _needed(generator)))
            self.bias = nn.Parameter(bias.to(dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        idx = (torch.arange(self.n_output_frame, device=x.device)[:, None]
               * self.stride_w
               + torch.arange(self.kernel_w, device=x.device)[None, :])
        y = torch.einsum("bokc,olkc->bol", x[:, idx], self.weight)
        return y + self.bias if self.with_bias else y


class SpatialConvolutionMap(Module):
    """A convolution over an explicit input -> output connection table
    (reference nn/SpatialConvolutionMap.scala): a dense NHWC convolution
    whose HWIO weight is masked by the table (the ``mask`` buffer), so
    only connected pairs carry gradient.  ``conn_table`` holds 1-based
    [in_plane, out_plane] pairs (:meth:`full`, :meth:`one_to_one`,
    :meth:`random`); pass the plane counts where the table may leave the
    last planes out.  Weight and bias ~ U(-1/sqrt(fan_in), ...), fan_in
    the links per output plane times kh kw.  The regularizer arguments
    are accepted and unused, as in the reference."""

    def __init__(self, conn_table, kw: int, kh: int,
                 dw: int = 1, dh: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_input_plane: int = 0, n_output_plane: int = 0,
                 w_regularizer=None, b_regularizer=None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        conn = np.asarray(conn_table, np.int64)
        n_in = n_input_plane or int(conn[:, 0].max())
        n_out = n_output_plane or int(conn[:, 1].max())
        if conn[:, 0].max() > n_in or conn[:, 1].max() > n_out:
            raise ValueError("connection table references planes beyond "
                             "the declared counts")
        mask = torch.zeros((kh, kw, n_in, n_out))
        for i, o in conn:
            mask[:, :, i - 1, o - 1] = 1.0
        self.register_buffer("mask", mask.to(dev))
        self.stride = (dh, dw)
        self.pad = (pad_h, pad_w)
        bound = 1.0 / math.sqrt(int(conn.shape[0] / n_out * kh * kw))
        self.weight = nn.Parameter(
            _uniform((kh, kw, n_in, n_out), bound, generator).to(dev))
        self.bias = nn.Parameter(_uniform((n_out,), bound, generator).to(dev))

    @staticmethod
    def full(n_in: int, n_out: int):
        return [[i + 1, o + 1] for o in range(n_out) for i in range(n_in)]

    @staticmethod
    def one_to_one(n_features: int):
        return [[i + 1, i + 1] for i in range(n_features)]

    @staticmethod
    def random(n_in: int, n_out: int, n_from: int, seed: int = 0):
        """A random table as Torch's, numpy's ``RandomState(seed)``
        drawing as the reference's."""
        rng = np.random.RandomState(seed)
        table = []
        for o in range(n_out):
            for i in rng.choice(n_in, size=n_from, replace=False):
                table.append([int(i) + 1, o + 1])
        return table

    def forward(self, x):
        y = _conv2d(x.permute(0, 3, 1, 2), self.weight * self.mask, None,
                    self.stride, self.pad)
        return y.permute(0, 2, 3, 1) + self.bias
