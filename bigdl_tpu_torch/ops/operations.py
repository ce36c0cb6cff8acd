"""TensorFlow-style stateless operations (counterpart of
``bigdl_tpu/ops/operations.py``, every name).

Each op is a thin Module over the matching torch function, with the
reference's table (tuple) inputs.  Where torch's function differs from
the JAX one the reference calls, the op keeps JAX's result:

* ``FloorDiv`` / ``FloorMod`` floor (``torch.div(rounding_mode="floor")``,
  ``torch.remainder``); ``Mod`` and ``TruncateDiv`` truncate, C-style
  (``torch.fmod``, ``rounding_mode="trunc"``), so ``truncatediv(x, y) * y +
  mod(x, y) == x``;
* ``Round`` and ``Rint`` round half to even; ``Sign`` keeps NaN and -0.0;
* ``OneHot`` gives a row of off-values for an index out of range (a
  negative one too), where ``F.one_hot`` raises;
* ``TopK`` takes a stable descending sort, so ties come out lower index
  first, as ``lax.top_k`` gives them; ``InTopK`` counts the predictions
  strictly above the target's;
* ``BucketizedCol`` is ``torch.bucketize(right=True)``, the reference's
  ``searchsorted(side="right")``;
* ``Gather`` wraps an index in [-n, 0) and gives zeros for one beyond,
  ``jnp.take(mode="fill")``.

Shape-like operands (axis, paddings, multiples, depth, shape, range
bounds) are read on the host, as the reference reads them at trace time.
The random ops draw from the generator in scope
(:func:`~bigdl_tpu_torch.core.module.forward_context`), and raise without
one, as the reference's do without a key.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module, next_generator

__all__ = [
    "Operation", "All", "Any", "ArgMax", "BatchMatMul", "Cast", "Ceil",
    "Equal", "NotEqual", "Greater", "GreaterEqual", "Less", "LessEqual",
    "Erf", "Erfc", "Expm1", "Floor", "FloorDiv", "FloorMod", "Inv",
    "IsFinite", "IsInf", "IsNan", "L2Loss", "Lgamma", "Digamma", "Log1p",
    "LogicalAnd", "LogicalOr", "LogicalNot", "MaximumOp", "MinimumOp",
    "Mod", "OneHot", "Pad", "Pow", "Prod", "RandomUniform", "RangeOps",
    "Rank", "Rint", "Round", "Rsqrt", "SelectOp", "Sign", "Slice",
    "SquaredDifference", "SumOp", "TileOp", "TopK", "TruncateDiv",
    "TruncatedNormal", "BucketizedCol", "CrossEntropy", "DepthwiseConv2D",
    "TensorOp",
]


def _t(x):
    return torch.as_tensor(x)


def _pair(a, b):
    return _t(a), _t(b)


def _axes(axis, ndim):
    """The reference's axis operand (None, an int or a list) as dims."""
    if axis is None:
        return tuple(range(ndim))
    return tuple(int(a) for a in np.asarray(axis).ravel())


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


class Operation(Module):
    """Stateless op (reference nn/ops/Operation.scala: no backward of its
    own; gradients flow through torch where defined)."""


class _Unary(Operation):
    fn = None

    def forward(self, x):
        return type(self).fn(_t(x))


class _Binary(Operation):
    """A table (pair) input, as the reference's ops take."""
    fn = None

    def forward(self, xs):
        a, b = xs
        return type(self).fn(*_pair(a, b))


class _AxisReduce(Operation):
    """A reduction over an ``axis`` table input (All, Any)."""

    fn = None

    def __init__(self, keep_dims: bool = False):
        super().__init__()
        self.keep_dims = keep_dims

    def forward(self, xs):
        x, axis = (xs if isinstance(xs, (tuple, list)) else (xs, None))
        x = _t(x)
        return type(self).fn(x, dim=_axes(axis, x.dim()),
                             keepdim=self.keep_dims)


class All(_AxisReduce):
    """(≙ nn/ops/All.scala)"""
    fn = staticmethod(torch.all)


class Any(_AxisReduce):
    """(≙ nn/ops/Any.scala)"""
    fn = staticmethod(torch.any)


class ArgMax(Operation):
    """The first maximum's index along ``axis``."""

    def __init__(self, axis: int = 0):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return torch.argmax(_t(x), dim=self.axis)


class BatchMatMul(Operation):
    """(≙ nn/ops/BatchMatMul.scala) with the adj_x / adj_y transposes."""

    def __init__(self, adj_x: bool = False, adj_y: bool = False):
        super().__init__()
        self.adj_x, self.adj_y = adj_x, adj_y

    def forward(self, xs):
        a, b = _pair(*xs)
        if self.adj_x:
            a = a.transpose(-1, -2)
        if self.adj_y:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class Cast(Operation):
    """To ``dtype`` (a torch dtype, or a numpy one or its name)."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = _dtype(dtype)

    def forward(self, x):
        return _t(x).to(self.dtype)


class Ceil(_Unary):
    fn = staticmethod(torch.ceil)


class Equal(_Binary):
    fn = staticmethod(torch.eq)


class NotEqual(_Binary):
    fn = staticmethod(torch.ne)


class Greater(_Binary):
    fn = staticmethod(torch.gt)


class GreaterEqual(_Binary):
    fn = staticmethod(torch.ge)


class Less(_Binary):
    fn = staticmethod(torch.lt)


class LessEqual(_Binary):
    fn = staticmethod(torch.le)


class Erf(_Unary):
    fn = staticmethod(torch.special.erf)


class Erfc(_Unary):
    fn = staticmethod(torch.special.erfc)


class Expm1(_Unary):
    fn = staticmethod(torch.expm1)


class Floor(_Unary):
    fn = staticmethod(torch.floor)


class FloorDiv(_Binary):
    """Division rounded toward -inf (``jnp.floor_divide``)."""
    fn = staticmethod(lambda a, b: torch.div(a, b, rounding_mode="floor"))


class FloorMod(_Binary):
    """The remainder with the divisor's sign (``jnp.mod``)."""
    fn = staticmethod(torch.remainder)


class Inv(_Unary):
    """Reciprocal (≙ nn/ops/Inv.scala)."""
    fn = staticmethod(torch.reciprocal)


class IsFinite(_Unary):
    fn = staticmethod(torch.isfinite)


class IsInf(_Unary):
    fn = staticmethod(torch.isinf)


class IsNan(_Unary):
    fn = staticmethod(torch.isnan)


class L2Loss(Operation):
    """sum(x**2)/2 (≙ nn/ops/L2Loss.scala)."""

    def forward(self, x):
        return torch.sum(torch.square(_t(x))) / 2


class Lgamma(_Unary):
    fn = staticmethod(torch.lgamma)


class Digamma(_Unary):
    fn = staticmethod(torch.digamma)


class Log1p(_Unary):
    fn = staticmethod(torch.log1p)


class LogicalAnd(_Binary):
    fn = staticmethod(torch.logical_and)


class LogicalOr(_Binary):
    fn = staticmethod(torch.logical_or)


class LogicalNot(_Unary):
    fn = staticmethod(torch.logical_not)


class MaximumOp(_Binary):
    fn = staticmethod(torch.maximum)


class MinimumOp(_Binary):
    fn = staticmethod(torch.minimum)


class Mod(_Binary):
    """The C truncated remainder (``lax.rem``), the dividend's sign: pairs
    with TruncateDiv so that truncatediv(x, y) * y + mod(x, y) == x."""
    fn = staticmethod(torch.fmod)


class OneHot(Operation):
    """(≙ nn/ops/OneHot.scala): table input (indices, depth, on, off);
    an index outside [0, depth) gives a row of ``off``."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, xs):
        indices, depth = _t(xs[0]), int(xs[1])
        on = xs[2] if len(xs) > 2 else 1.0
        off = xs[3] if len(xs) > 3 else 0.0
        oh = (indices[..., None] == torch.arange(
            depth, device=indices.device)).to(torch.float32)
        oh = torch.movedim(oh, -1, self.axis)
        return oh * on + (1 - oh) * off


class Pad(Operation):
    """(≙ nn/ops/Pad.scala): table input (tensor, paddings [n, 2]); CONSTANT,
    REFLECT or SYMMETRIC (numpy's ``pad`` modes, over every axis)."""

    def __init__(self, mode: str = "CONSTANT", constant_value: float = 0.0):
        super().__init__()
        if mode not in ("CONSTANT", "REFLECT", "SYMMETRIC"):
            raise ValueError(f"unsupported pad mode {mode!r}")
        self.mode = mode
        self.constant_value = constant_value

    def forward(self, xs):
        x, paddings = xs
        x = _t(x)
        pads = [tuple(int(v) for v in row) for row in np.asarray(paddings)]
        if self.mode == "CONSTANT":
            flat = [v for row in reversed(pads) for v in row]
            return F.pad(x, flat, value=self.constant_value)
        for axis, row in enumerate(pads):
            idx = np.pad(np.arange(x.shape[axis]), row,
                         mode=self.mode.lower())
            x = torch.index_select(x, axis, torch.as_tensor(
                idx, device=x.device))
        return x


class Pow(_Binary):
    fn = staticmethod(torch.pow)


class Prod(Operation):
    def __init__(self, axis: int = 0, keep_dims: bool = False):
        super().__init__()
        self.axis, self.keep_dims = axis, keep_dims

    def forward(self, x):
        return torch.prod(_t(x), dim=self.axis, keepdim=self.keep_dims)


def _shape(shape):
    return tuple(int(s) for s in np.asarray(shape).ravel())


class RandomUniform(Operation):
    """(≙ nn/ops/RandomUniform.scala): U[minval, maxval) of the given
    shape, from the generator in scope."""

    def __init__(self, minval: float = 0.0, maxval: float = 1.0):
        super().__init__()
        self.minval, self.maxval = minval, maxval

    def forward(self, shape):
        g = next_generator()
        u = torch.rand(_shape(shape), generator=g, device=g.device)
        return u * (self.maxval - self.minval) + self.minval


class RangeOps(Operation):
    """(≙ nn/ops/RangeOps.scala): the (start, limit, delta) table; float
    ranges too, as tf.range.  Its inputs are numbers, so the range is
    made on ``device`` (``None``: the card)."""

    def __init__(self, device=None):
        super().__init__()
        self.device = resolve_device(device)

    def forward(self, xs):
        start, limit, delta = (np.asarray(v).item() for v in xs)
        return torch.arange(start, limit, delta, device=self.device)


class Rank(Operation):
    def forward(self, x):
        x = _t(x)
        return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


class Rint(_Unary):
    fn = staticmethod(torch.round)


class Round(_Unary):
    fn = staticmethod(torch.round)


class Rsqrt(_Unary):
    fn = staticmethod(torch.rsqrt)


class SelectOp(Operation):
    """tf.where(cond, x, y) (≙ nn/ops/Select.scala)."""

    def forward(self, xs):
        cond, x, y = (_t(v) for v in xs)
        return torch.where(cond, x, y)


def _sign(x):
    if not x.is_floating_point():
        return torch.sign(x)
    # jnp.sign keeps NaN and a signed zero
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


class Sign(_Unary):
    fn = staticmethod(_sign)


class Slice(Operation):
    """(≙ nn/ops/Slice.scala): static ``begin`` and ``size`` (-1: to the
    end)."""

    def __init__(self, begin: Sequence[int], size: Sequence[int]):
        super().__init__()
        self.begin = tuple(begin)
        self.size = tuple(size)

    def forward(self, x):
        x = _t(x)
        return x[tuple(slice(b, b + s if s != -1 else None)
                       for b, s in zip(self.begin, self.size))]


class SquaredDifference(_Binary):
    fn = staticmethod(lambda a, b: torch.square(a - b))


class SumOp(Operation):
    """reduce_sum with an axis table input (≙ nn/ops/Sum.scala)."""

    def __init__(self, keep_dims: bool = False):
        super().__init__()
        self.keep_dims = keep_dims

    def forward(self, xs):
        x, axis = (xs if isinstance(xs, (tuple, list)) else (xs, None))
        x = _t(x)
        return torch.sum(x, dim=_axes(axis, x.dim()), keepdim=self.keep_dims)


class TileOp(Operation):
    """(≙ nn/ops/Tile.scala): the (tensor, multiples) table."""

    def forward(self, xs):
        x, multiples = xs
        return torch.tile(_t(x), _shape(multiples))


class TopK(Operation):
    """The ``k`` largest along the last axis, sorted, and their indices;
    ties lower index first (a stable sort), as ``lax.top_k``."""

    def __init__(self, k: int, sorted: bool = True):
        super().__init__()
        self.k = k
        # always sorted, which sorted=False (order unspecified) allows
        self.sorted = sorted

    def forward(self, x):
        values, indices = torch.sort(_t(x), dim=-1, descending=True,
                                     stable=True)
        return values[..., :self.k], indices[..., :self.k]


def _truncate_div(a, b):
    if a.is_floating_point() or b.is_floating_point():
        return torch.trunc(a / b)
    return torch.div(a, b, rounding_mode="trunc")


class TruncateDiv(_Binary):
    fn = staticmethod(_truncate_div)


class TruncatedNormal(Operation):
    """(≙ nn/ops/TruncatedNormal.scala): N(mean, stddev^2) truncated to
    two standard deviations, by the inverse CDF of a uniform draw from the
    generator in scope (``jax.random.truncated_normal``'s method)."""

    def __init__(self, mean: float = 0.0, stddev: float = 1.0):
        super().__init__()
        self.mean, self.stddev = mean, stddev

    def forward(self, shape):
        g = next_generator()
        lo, hi = (math.erf(v / math.sqrt(2.0)) for v in (-2.0, 2.0))
        u = torch.rand(_shape(shape), generator=g, device=g.device)
        z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
        return z.clamp(-2.0, 2.0) * self.stddev + self.mean


class BucketizedCol(Operation):
    """Bucket ids by sorted boundaries (≙ nn/ops/BucketizedCol.scala): the
    count of boundaries <= x."""

    def __init__(self, boundaries: Sequence[float]):
        super().__init__()
        self.boundaries = tuple(sorted(boundaries))

    def forward(self, x):
        x = _t(x)
        b = torch.tensor(self.boundaries, device=x.device)
        dtype = torch.promote_types(x.dtype, b.dtype)
        return torch.bucketize(x.to(dtype), b.to(dtype), right=True) \
            .to(torch.int32)


class CrossEntropy(Operation):
    """Per-sample softmax cross entropy from logits
    (≙ nn/ops/CrossEntropy.scala): input (logits, one-hot labels)."""

    def forward(self, xs):
        logits, labels = _pair(*xs)
        return -torch.sum(labels * F.log_softmax(logits, dim=-1), dim=-1)


def _same_pads(size: int, k: int, stride: int):
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class DepthwiseConv2D(Operation):
    """(≙ nn/ops/DepthwiseConv2D.scala): input (x NHWC, filter HWCM);
    output channel c * M + m, as the reference's grouped convolution."""

    def __init__(self, stride_w: int = 1, stride_h: int = 1,
                 padding: str = "SAME"):
        super().__init__()
        self.strides = (stride_h, stride_w)
        self.padding = padding

    def forward(self, xs):
        x, w = _pair(*xs)
        kh, kw, c, m = w.shape
        xc = x.permute(0, 3, 1, 2)
        if self.padding == "SAME":
            (t, b), (lf, r) = (_same_pads(xc.shape[2], kh, self.strides[0]),
                               _same_pads(xc.shape[3], kw, self.strides[1]))
            xc = F.pad(xc, (lf, r, t, b))
        wc = w.permute(2, 3, 0, 1).reshape(c * m, 1, kh, kw)
        y = F.conv2d(xc, wc, stride=self.strides, groups=c)
        return y.permute(0, 2, 3, 1)


def _softsign(y):
    return y / (1 + torch.abs(y))


class TensorOp(Operation):
    """Composable tensor-function op (reference nn/ops/TensorOp.scala):
    arithmetic operators and chainable transforms build one op whose
    forward applies the whole chain, ``(TensorOp() * 2.0 + 1.0).sqrt()``.
    """

    def __init__(self, fn=None):
        super().__init__()
        self.fn = fn or (lambda x: x)

    def forward(self, x):
        return self.fn(_t(x))

    # -- composition -------------------------------------------------------
    def then(self, g) -> "TensorOp":
        f = self.fn
        return TensorOp(lambda x: g(f(x)))

    def _combine(self, other, op):
        if isinstance(other, TensorOp):
            f, g = self.fn, other.fn
            return TensorOp(lambda x: op(f(x), g(x)))
        return self.then(lambda y: op(y, other))

    def __add__(self, other):
        return self._combine(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._combine(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._combine(other, lambda a, b: a * b)

    def __truediv__(self, other):
        return self._combine(other, lambda a, b: a / b)

    def __pow__(self, p):
        return self.then(lambda y: y ** p)

    # -- chainable transforms (TensorOp.scala's method set) -----------------
    def abs(self):
        return self.then(torch.abs)

    def sqrt(self):
        return self.then(torch.sqrt)

    def rsqrt(self):
        return self.then(torch.rsqrt)

    def square(self):
        return self.then(torch.square)

    def exp(self):
        return self.then(torch.exp)

    def log(self):
        return self.then(torch.log)

    def log1p(self):
        return self.then(torch.log1p)

    def floor(self):
        return self.then(torch.floor)

    def ceil(self):
        return self.then(torch.ceil)

    def negative(self):
        return self.then(torch.negative)

    def inv(self):
        return self.then(torch.reciprocal)

    def sigmoid(self):
        return self.then(torch.sigmoid)

    def tanh(self):
        return self.then(torch.tanh)

    def relu(self):
        return self.then(torch.relu)

    def elu(self):
        return self.then(F.elu)

    def softmax(self):
        return self.then(lambda y: torch.softmax(y, dim=-1))

    def softplus(self):
        return self.then(F.softplus)

    def softsign(self):
        return self.then(_softsign)

    def clamp(self, lo, hi):
        return self.then(lambda y: torch.clamp(y, lo, hi))

    def sum(self, axis=None, keepdims=False):
        return self.then(lambda y: torch.sum(
            y, dim=_axes(axis, y.dim()), keepdim=keepdims))

    def mean(self, axis=None, keepdims=False):
        return self.then(lambda y: torch.mean(
            y, dim=_axes(axis, y.dim()), keepdim=keepdims))

    def t(self):
        return self.then(lambda y: y.transpose(-1, -2))


class ApproximateEqual(Operation):
    """|a - b| < tolerance (reference nn/ops/ApproximateEqual.scala)."""

    def __init__(self, tolerance: float = 1e-5):
        super().__init__()
        self.tolerance = float(tolerance)

    def forward(self, xs):
        a, b = _pair(*xs)
        return torch.abs(a - b) < self.tolerance


class Gather(Operation):
    """Rows of params by 0-based indices along axis 0 (reference
    nn/ops/Gather.scala): an index in [-n, 0) counts from the end, one
    out of range gives a zero row (TF's GPU behaviour, the reference's
    ``jnp.take(mode="fill")``)."""

    def forward(self, xs):
        params, indices = _pair(*xs)
        n = params.shape[0]
        idx = indices.long()
        idx = torch.where(idx < 0, idx + n, idx)
        valid = (idx >= 0) & (idx < n)
        rows = params[idx.clamp(0, n - 1)]
        mask = valid.reshape(valid.shape + (1,) * (params.dim() - 1))
        return torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                   device=rows.device))


class InTopK(Operation):
    """targets[i] in the top k of predictions[i] (reference
    nn/ops/InTopK.scala): fewer than k predictions strictly above the
    target's.  ``start_from_1``: 1-based targets.  An out-of-range
    target or a non-finite target prediction is False."""

    def __init__(self, k: int, start_from_1: bool = False):
        super().__init__()
        self.k = int(k)
        self.start_from_1 = start_from_1

    def forward(self, xs):
        predictions, targets = _pair(*xs)
        targets = targets.long()
        if self.start_from_1:
            targets = targets - 1
        n_classes = predictions.shape[1]
        valid = (targets >= 0) & (targets < n_classes)
        safe = targets.clamp(0, n_classes - 1)
        target_score = torch.gather(predictions, 1, safe[:, None])[:, 0]
        rank = torch.sum(predictions > target_score[:, None], dim=1)
        return valid & torch.isfinite(target_score) & (rank < self.k)


class SegmentSum(Operation):
    """Sum the rows sharing a segment id; ids sorted ascending (reference
    nn/ops/SegmentSum.scala, TF segment_sum).  ``max(id) + 1`` rows
    unless ``num_segments`` is given; ids out of range are dropped."""

    def __init__(self, num_segments=None):
        super().__init__()
        self.num_segments = num_segments

    def forward(self, xs):
        data, segment_ids = _pair(*xs)
        segment_ids = segment_ids.long()
        num = self.num_segments
        if num is None:
            if segment_ids.is_cuda and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "SegmentSum under a CUDA graph capture needs a static "
                    "segment count: construct it as "
                    "SegmentSum(num_segments=N) (the output shape cannot "
                    "be read from the ids on the host there)")
            num = int(segment_ids[-1]) + 1 if segment_ids.numel() else 0
        valid = (segment_ids >= 0) & (segment_ids < num)
        mask = valid.reshape(valid.shape + (1,) * (data.dim() - 1))
        data = torch.where(mask, data, torch.zeros((), dtype=data.dtype,
                                                   device=data.device))
        out = torch.zeros((num,) + tuple(data.shape[1:]), dtype=data.dtype,
                          device=data.device)
        return out.index_add(0, segment_ids.clamp(0, max(num - 1, 0)), data)


class ModuleToOperation(Operation):
    """Any Module as a forward-only op (reference
    nn/ops/ModuleToOperation.scala)."""

    def __init__(self, module: Module):
        super().__init__()
        self.module = module

    def forward(self, x):
        return self.module(x)


class Dilation2D(Operation):
    """Grayscale morphological dilation: out[b, y, x, c] = the max over
    the (dilated) window of input + filter (reference
    nn/ops/Dilation2D.scala, TF tf.nn.dilation2d).  NHWC input, [kh, kw,
    C] filter; strides and rates are TF's 4-element lists.  SAME pads
    with half the dtype's lowest value, so a padded element never wins."""

    def __init__(self, strides, rates, padding: str = "VALID"):
        super().__init__()
        self.strides = tuple(strides)
        self.rates = tuple(rates)
        self.padding = padding.upper()

    def forward(self, xs):
        x, filt = _pair(*xs)
        kh, kw, _ = filt.shape
        _, sh, sw, _ = self.strides
        _, rh, rw, _ = self.rates
        eff_h, eff_w = (kh - 1) * rh + 1, (kw - 1) * rw + 1
        if self.padding == "SAME":
            H, W = x.shape[1], x.shape[2]
            ph = max((-(-H // sh) - 1) * sh + eff_h - H, 0)
            pw = max((-(-W // sw) - 1) * sw + eff_w - W, 0)
            neg = (torch.iinfo(x.dtype).min // 2 if not x.is_floating_point()
                   else torch.finfo(x.dtype).min / 2)
            x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2,
                          ph - ph // 2), value=neg)
        oh = (x.shape[1] - eff_h) // sh + 1
        ow = (x.shape[2] - eff_w) // sw + 1
        out = None
        for i in range(kh):
            for j in range(kw):
                tap = x[:, i * rh:i * rh + (oh - 1) * sh + 1:sh,
                        j * rw:j * rw + (ow - 1) * sw + 1:sw, :] + filt[i, j]
                out = tap if out is None else torch.maximum(out, tap)
        return out


class Substr(Operation):
    """Substrings of byte-string arrays (reference nn/ops/Substr.scala, TF
    Substr): a host op over numpy object or bytes arrays and (pos, len)
    scalars; a position out of range raises, as TF does."""

    def forward(self, xs):
        strings, pos, length = xs
        pos, length = int(pos), int(length)
        arr = np.asarray(strings, dtype=object)

        def sub(s):
            if pos < 0 or pos > len(s):
                raise ValueError(
                    f"Substr pos {pos} out of range for input of "
                    f"length {len(s)}")
            return s[pos:pos + length]

        if arr.shape == ():
            return sub(arr[()])
        out = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            out[idx] = sub(arr[idx])
        return out


# the reference's aliases: nn/ops names that clashed with jnp builtins,
# and nn/ops/Compare.scala, the comparison ops' base
Maximum = MaximumOp
Minimum = MinimumOp
Compare = _Binary

__all__ += ["ApproximateEqual", "Gather", "InTopK", "SegmentSum",
            "ModuleToOperation", "Dilation2D", "Substr", "Maximum",
            "Minimum", "Compare"]
