"""Shape, indexing and reduction layers (counterpart of
``bigdl_tpu/nn/shape_ops.py``, all 26 classes).

Dim arguments follow the reference's Torch convention: 1-based, and for
the layers that take ``num_input_dims``/``n_input_dim`` offset by the
batch axis when the input has one.  None of them holds a parameter.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core.module import Module

__all__ = [
    "Reshape", "View", "Squeeze", "Unsqueeze", "Transpose", "Select",
    "Narrow", "Replicate", "Padding", "SpatialZeroPadding", "Cropping2D",
    "Cropping3D", "Tile", "ExpandSize", "InferReshape", "Contiguous",
    "Index", "MaskedSelect", "Max", "Min", "Mean", "Sum", "Masking",
    "Pack", "Reverse", "Flatten",
]


def _batch_offset(d: int, x, n_dims: int) -> int:
    """0-based axis of the 1-based ``d`` + 1, shifted by the batch axes
    when ``x`` has more dims than ``n_dims`` (> 0)."""
    if n_dims > 0 and x.dim() > n_dims:
        d += x.dim() - n_dims
    return d


class Reshape(Module):
    """Reshape the non-batch dims to ``size``; the batch dim is kept when
    ``batch_mode`` is True, or (None) when the input holds more entries
    than ``size``."""

    def __init__(self, size: Sequence[int],
                 batch_mode: Optional[bool] = None):
        super().__init__()
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        n_elem = 1
        for s in self.size:
            n_elem *= s
        if self.batch_mode is True or (
                self.batch_mode is None and x.numel() != n_elem):
            return x.reshape((x.shape[0],) + self.size)
        return x.reshape(self.size)


class Flatten(Module):
    """Collapse every non-batch dim."""

    def forward(self, x):
        return x.reshape((x.shape[0], -1))


class View(Module):
    """Reshape with -1 inference, batch kept."""

    def __init__(self, *sizes: int):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(sizes)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.sizes)


class Squeeze(Module):
    """Drop the singleton dim ``dim`` (1-based), or every singleton."""

    def __init__(self, dim: Optional[int] = None, num_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def forward(self, x):
        if self.dim is None:
            return torch.squeeze(x)
        return torch.squeeze(
            x, _batch_offset(self.dim - 1, x, self.num_input_dims))


class Unsqueeze(Module):
    """Insert a singleton dim at ``pos`` (1-based)."""

    def __init__(self, pos: int, num_input_dims: int = -1):
        super().__init__()
        self.pos = pos
        self.num_input_dims = num_input_dims

    def forward(self, x):
        return torch.unsqueeze(
            x, _batch_offset(self.pos - 1, x, self.num_input_dims))


class Transpose(Module):
    """Swap each listed pair of dims (1-based), in order."""

    def __init__(self, permutations: Sequence[Tuple[int, int]]):
        super().__init__()
        self.permutations = tuple(tuple(p) for p in permutations)

    def forward(self, x):
        for d1, d2 in self.permutations:
            x = torch.transpose(x, d1 - 1, d2 - 1)
        return x


class Select(Module):
    """Take ``index`` along ``dim`` and drop the dim (1-based; negative
    values count from the end)."""

    def __init__(self, dim: int, index: int):
        super().__init__()
        self.dim, self.index = dim, index

    def forward(self, x):
        dim = self.dim - 1 if self.dim > 0 else x.dim() + self.dim
        idx = self.index - 1 if self.index > 0 else x.shape[dim] + self.index
        return torch.select(x, dim, idx)


class Narrow(Module):
    """``length`` entries from ``offset`` along ``dimension`` (1-based; a
    negative length ends that far before the end + 1)."""

    def __init__(self, dimension: int, offset: int, length: int = 1):
        super().__init__()
        self.dimension, self.offset, self.length = dimension, offset, length

    def forward(self, x):
        dim = (self.dimension - 1 if self.dimension > 0
               else x.dim() + self.dimension)
        start = self.offset - 1
        length = (self.length if self.length >= 0
                  else x.shape[dim] - start + self.length + 1)
        return torch.narrow(x, dim, start, length)


class Replicate(Module):
    """Insert a new dim of ``n_features`` copies at ``dim``."""

    def __init__(self, n_features: int, dim: int = 1,
                 n_dim: int = 2147483647):
        super().__init__()
        self.n_features, self.dim = n_features, dim

    def forward(self, x):
        y = torch.unsqueeze(x, self.dim - 1)
        reps = [1] * y.dim()
        reps[self.dim - 1] = self.n_features
        return y.repeat(reps)


class Padding(Module):
    """Pad ``|pad|`` entries of ``value`` along ``dim``: before it when
    ``pad`` is negative, after it otherwise."""

    def __init__(self, dim: int, pad: int, n_input_dim: int,
                 value: float = 0.0, n_index: int = 1):
        super().__init__()
        self.dim, self.pad, self.value = dim, pad, value
        self.n_input_dim = n_input_dim

    def forward(self, x):
        dim = _batch_offset(self.dim - 1, x, self.n_input_dim)
        widths = [0, 0] * x.dim()
        # F.pad lists (lo, hi) pairs from the last dim backwards
        slot = 2 * (x.dim() - 1 - dim)
        if self.pad < 0:
            widths[slot] = -self.pad
        else:
            widths[slot + 1] = self.pad
        return F.pad(x, widths, value=self.value)


class SpatialZeroPadding(Module):
    """Zero-pad the H and W of NHWC (or NCHW) images."""

    def __init__(self, pad_left: int, pad_right: int, pad_top: int,
                 pad_bottom: int, data_format: str = "NHWC"):
        super().__init__()
        self.pads = (pad_left, pad_right, pad_top, pad_bottom)
        self.data_format = data_format

    def forward(self, x):
        left, right, top, bottom = self.pads
        if self.data_format == "NHWC":
            return F.pad(x, (0, 0, left, right, top, bottom))
        return F.pad(x, (left, right, top, bottom))


class Cropping2D(Module):
    """Crop H and W."""

    def __init__(self, height_crop: Tuple[int, int] = (0, 0),
                 width_crop: Tuple[int, int] = (0, 0),
                 data_format: str = "NHWC"):
        super().__init__()
        self.height_crop = tuple(height_crop)
        self.width_crop = tuple(width_crop)
        self.data_format = data_format

    def forward(self, x):
        (t, b), (l, r) = self.height_crop, self.width_crop
        if self.data_format == "NHWC":
            return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :]
        return x[:, :, t:x.shape[2] - b, l:x.shape[3] - r]


class Cropping3D(Module):
    """Crop D, H and W of NDHWC (or NCDHW) volumes."""

    def __init__(self, dim1_crop=(0, 0), dim2_crop=(0, 0),
                 dim3_crop=(0, 0), data_format: str = "NDHWC"):
        super().__init__()
        self.crops = (tuple(dim1_crop), tuple(dim2_crop), tuple(dim3_crop))
        self.data_format = data_format

    def forward(self, x):
        (d1a, d1b), (d2a, d2b), (d3a, d3b) = self.crops
        if self.data_format == "NDHWC":
            return x[:, d1a:x.shape[1] - d1b, d2a:x.shape[2] - d2b,
                     d3a:x.shape[3] - d3b, :]
        return x[:, :, d1a:x.shape[2] - d1b, d2a:x.shape[3] - d2b,
                 d3a:x.shape[4] - d3b]


class Tile(Module):
    """Repeat ``copies`` times along ``dim``."""

    def __init__(self, dim: int = 1, copies: int = 2):
        super().__init__()
        self.dim, self.copies = dim, copies

    def forward(self, x):
        reps = [1] * x.dim()
        reps[self.dim - 1] = self.copies
        return x.repeat(reps)


class ExpandSize(Module):
    """Broadcast singleton dims to ``sizes`` (-1 keeps a dim)."""

    def __init__(self, sizes: Sequence[int]):
        super().__init__()
        self.sizes = tuple(sizes)

    def forward(self, x):
        return x.expand(tuple(x.shape[i] if s == -1 else s
                              for i, s in enumerate(self.sizes)))


class InferReshape(Module):
    """Reshape where -1 infers a dim and 0 copies the input's."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False):
        super().__init__()
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        in_shape = x.shape[1:] if self.batch_mode else x.shape
        out = tuple(in_shape[i] if s == 0 else s
                    for i, s in enumerate(self.size))
        if self.batch_mode:
            return x.reshape((x.shape[0],) + out)
        return x.reshape(out)


class Contiguous(Module):
    """A contiguous copy where the input is a strided view."""

    def forward(self, x):
        return x.contiguous()


class Index(Module):
    """Table input (tensor, 1-based indices): take along ``dimension``."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, inputs):
        x, idx = inputs
        idx = torch.as_tensor(idx, device=x.device).long() - 1
        return torch.index_select(x, self.dimension - 1, idx.reshape(-1)) \
            .reshape(x.shape[:self.dimension - 1] + idx.shape
                     + x.shape[self.dimension:])


class MaskedSelect(Module):
    """Table input (tensor, mask): the masked entries, flattened."""

    def forward(self, inputs):
        x, mask = inputs
        return x[torch.as_tensor(mask, device=x.device).bool()]


class Max(Module):
    """Max along ``dim`` (1-based, batch-offset by ``num_input_dims``)."""

    def __init__(self, dim: int = 1, num_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def _axis(self, x):
        return _batch_offset(self.dim - 1, x, self.num_input_dims)

    def forward(self, x):
        return torch.amax(x, dim=self._axis(x))


class Min(Max):
    def forward(self, x):
        return torch.amin(x, dim=self._axis(x))


class Mean(Module):
    """Mean along ``dimension``; ``squeeze=False`` keeps the dim."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.squeeze = squeeze

    def forward(self, x):
        d = _batch_offset(self.dimension - 1, x, self.n_input_dims)
        return torch.mean(x, dim=d, keepdim=not self.squeeze)


class Sum(Module):
    """Sum (or, with ``size_average``, mean) along ``dimension``."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 size_average: bool = False, squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.size_average = size_average
        self.squeeze = squeeze

    def forward(self, x):
        d = _batch_offset(self.dimension - 1, x, self.n_input_dims)
        if self.size_average:
            return torch.mean(x, dim=d, keepdim=not self.squeeze)
        return torch.sum(x, dim=d, keepdim=not self.squeeze)


class Masking(Module):
    """Zero the timesteps whose every feature equals ``mask_value``."""

    def __init__(self, mask_value: float = 0.0):
        super().__init__()
        self.mask_value = float(mask_value)

    def forward(self, x):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return x * keep.to(x.dtype)


class Pack(Module):
    """Stack a table of tensors along a new dim (1-based)."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.dimension = dimension

    def forward(self, xs):
        return torch.stack(list(xs), dim=self.dimension - 1)


class Reverse(Module):
    """Reverse along ``dimension`` (1-based)."""

    def __init__(self, dimension: int = 1, is_inplace: bool = False):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        return torch.flip(x, dims=(self.dimension - 1,))
