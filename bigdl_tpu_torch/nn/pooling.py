"""2-D pooling (counterpart of ``SpatialMaxPooling``,
``SpatialAveragePooling``, ``GlobalAveragePooling2D`` and ``_pool_pads``
in ``bigdl_tpu/nn/pooling.py``).

NHWC by default, NCHW through ``data_format``.  The padding is the
reference's explicit (lo, hi) per spatial dim, implementing its floor or
ceil output size; padded positions hold -inf for a max and 0 for an
average, as ``reduce_window`` pads them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core.module import Module

__all__ = ["SpatialMaxPooling", "SpatialAveragePooling",
           "GlobalAveragePooling2D"]


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
