"""2-D convolution (counterpart of ``SpatialConvolution`` in
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
applied to the gradients by the ``Optimizer``'s step.  The reference's
``init_weight``/``init_bias`` and ``propagate_back`` are not ported
(ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module

__all__ = ["SpatialConvolution", "same_pads"]


def same_pads(size: int, k: int, s: int):
    """(lo, hi) SAME padding of one spatial dim, as XLA computes it."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SpatialConvolution(Module):
    """2-D convolution (reference nn/SpatialConvolution.scala)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, *, with_bias: bool = True,
                 data_format: str = "NHWC", init_method=None,
                 w_regularizer=None, b_regularizer=None,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"do not split into {n_group} groups")
        if data_format not in ("NHWC", "NCHW"):
            raise ValueError(f"data_format must be NHWC or NCHW, got "
                             f"{data_format!r}")
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
        im = init_method or init_methods.RandomUniform()
        self.weight = nn.Parameter(im(
            (kernel_h, kernel_w, n_input_plane // n_group, n_output_plane),
            generator=generator, fan_in=fan_in, fan_out=fan_out).to(dev))
        if with_bias:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = nn.Parameter(
                ((torch.rand((n_output_plane,), generator=generator) * 2.0
                  - 1.0) * bound).to(dev))
        else:
            self.register_parameter("bias", None)

    def _padding(self, h: int, w: int):
        """(top, bottom, left, right)."""
        pad_h, pad_w = self.pad
        if pad_h == -1 or pad_w == -1:
            return (*same_pads(h, self.kernel[0], self.stride[0]),
                    *same_pads(w, self.kernel[1], self.stride[1]))
        return pad_h, pad_h, pad_w, pad_w

    def forward(self, x):
        unbatched = x.dim() == 3
        if unbatched:
            x = x[None]
        nchw = x if self.data_format == "NCHW" else x.permute(0, 3, 1, 2)
        top, bottom, left, right = self._padding(*nchw.shape[2:])
        if top == bottom and left == right:
            padding = (top, left)
        else:
            nchw = F.pad(nchw, (left, right, top, bottom))
            padding = (0, 0)
        y = F.conv2d(nchw, self.weight.permute(3, 2, 0, 1), self.bias,
                     stride=self.stride, padding=padding,
                     groups=self.n_group)
        if self.data_format == "NHWC":
            y = y.permute(0, 2, 3, 1)
        return y[0] if unbatched else y
