"""Int8 quantized inference (counterpart of ``bigdl_tpu/nn/quantized.py``).

``Quantizer`` walks a trained model and swaps ``Linear``,
``SpatialConvolution`` and ``SpatialDilatedConvolution`` (exact types) for
int8 versions, as the reference's does.  The quantization windows are the
reference's:

* weights: symmetric per-output-channel max-abs scaling, computed once at
  quantize time (``scale = amax / 127`` where ``amax > 0``, else 1);
* activations: symmetric per-row (per-sample) max-abs scaling computed
  for each batch, so a padded row changes no other row's values.

``round`` is half-to-even, as ``jnp.round``.  The int8 x int8 -> int32
product is ``torch._int_mm`` (:func:`int8_matmul`: cuBLASLt's int8 GEMM on
the card, a CPU kernel on the host), padded with zero rows and columns to
its shape rules on the card (more than 16 rows, K and N multiples of 8),
which leaves every int32 sum exact.  The convolution is an im2col of the
int8 NHWC activations over the HWIO kernel's taps (stride, SAME or
explicit padding, dilation), chunked over the batch, followed by that
product.  The epilogue keeps the reference's order: ``(acc * sx) *
wscale``, then the bias, then a cast to the input's dtype.

:func:`plain_int8_matmul` and :func:`plain_int8_conv` give the same int32
sums through a float64 product, exact below 2**53: the tests and
``chip_smoke.py`` hold the int8 path against them, swapped in for
:func:`int8_matmul` and :func:`int8_conv` (``chip_smoke.plain_products``).

Quantized weights live as int8 *buffers*, not parameters (``qweight``
HWIO for a convolution, (out, in) for a linear layer, ``wscale`` and
``bias``), so the quantized model is inference-only and its buffers load
by name from the reference's (``interop.load_jax_buffers``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.module import Module, clone
from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                     SpatialDilatedConvolution, same_pads)
from bigdl_tpu_torch.nn.linear import Linear

__all__ = ["QuantizedLinear", "QuantizedSpatialConvolution", "Quantizer",
           "quantize"]

# the im2col columns of one chunk of the batch stay under this many bytes
COLUMN_BYTES = 1 << 28


def _quantized(v: torch.Tensor, amax: torch.Tensor):
    """int8 values of ``v`` and their float32 scale from its max-abs
    ``amax``: amax / 127 where amax > 0, else 1.  The divisor 127 is a
    tensor on ``v``'s device: on the card a tensor divided by a Python
    number is multiplied by its reciprocal, one rounding off the
    reference's quotient."""
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _quantize_per_channel(w: torch.Tensor, channel_axis: int):
    """Symmetric max-abs int8 quantization with a per-output-channel
    scale: (int8 values, float32 scale shaped to broadcast over ``w``)."""
    reduce = [i for i in range(w.dim()) if i != channel_axis]
    return _quantized(w, w.abs().amax(dim=reduce, keepdim=True))


def _quantize_rows(x: torch.Tensor):
    """Dynamic symmetric per-row activation quantization: each sample row
    gets its own max-abs window."""
    return _quantized(x, x.abs().amax(dim=list(range(1, x.dim())),
                                      keepdim=True))


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def int8_matmul(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 times [N, K] int8, transposed, -> [M, N] int32 by
    ``torch._int_mm``, the operands padded with zeros to at least 24 rows
    and K and N to multiples of 8."""
    m, k = qx.shape
    n = qw.shape[0]
    mp, kp, np_ = max(_up8(m), 24), _up8(k), _up8(n)
    if (mp, kp) != (m, k):
        qx = F.pad(qx, (0, kp - k, 0, mp - m))
    w = F.pad(qw, (0, kp - k, 0, np_ - n)) if (kp, np_) != (k, n) \
        else qw.contiguous()
    return torch._int_mm(qx, w.t())[:m, :n]


def plain_int8_matmul(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """:func:`int8_matmul`'s int32 sums through a float64 product."""
    return (qx.double() @ qw.double().t()).to(torch.int32)


def _conv_pads(h: int, w: int, kernel, stride, pad, dilation):
    """(top, bottom, left, right): SAME over the dilated kernel's extent
    where ``pad[0]`` is -1, as the reference takes it, else symmetric."""
    if pad[0] == -1:
        top, bottom = same_pads(h, (kernel[0] - 1) * dilation[0] + 1,
                                stride[0])
        left, right = same_pads(w, (kernel[1] - 1) * dilation[1] + 1,
                                stride[1])
        return top, bottom, left, right
    return pad[0], pad[0], pad[1], pad[1]


def int8_conv(qx: torch.Tensor, qweight: torch.Tensor, stride, pad,
              dilation) -> torch.Tensor:
    """The int32 convolution of int8 NHWC ``qx`` by the int8 HWIO
    ``qweight``: an im2col over the kernel's taps (columns ordered as the
    weight's (kh, kw, in) rows, K padded to a multiple of 8 with zeros),
    then :func:`int8_matmul`, a chunk of the batch at a time."""
    b, h, w, c = qx.shape
    kh, kw, cin, cout = qweight.shape
    (sh, sw), (dh, dw) = stride, dilation
    top, bottom, left, right = _conv_pads(h, w, (kh, kw), stride, pad,
                                          dilation)
    oh = (h + top + bottom - (kh - 1) * dh - 1) // sh + 1
    ow = (w + left + right - (kw - 1) * dw - 1) // sw + 1
    if (top, bottom, left, right) != (0, 0, 0, 0):
        qx = F.pad(qx, (0, 0, left, right, top, bottom))
    k = kh * kw * c
    kp = _up8(k)
    wmat = qweight.reshape(k, cout).t()
    if kp != k:
        wmat = F.pad(wmat, (0, kp - k))
    chunk = max(1, min(b, COLUMN_BYTES // max(oh * ow * kp, 1)))
    out = torch.empty((b, oh, ow, cout), dtype=torch.int32,
                      device=qx.device)
    for lo in range(0, b, chunk):
        part = qx[lo:lo + chunk]
        cb = part.shape[0]
        if (kh, kw, sh, sw, kp) == (1, 1, 1, 1, k):
            cols = part.reshape(cb * oh * ow, k)
        else:
            cols = (torch.zeros if kp != k else torch.empty)(
                (cb, oh, ow, kp), dtype=torch.int8, device=qx.device)
            for i in range(kh):
                for j in range(kw):
                    t = i * kw + j
                    cols[..., t * c:(t + 1) * c] = part[
                        :, i * dh:i * dh + (oh - 1) * sh + 1:sh,
                        j * dw:j * dw + (ow - 1) * sw + 1:sw, :]
            cols = cols.reshape(cb * oh * ow, kp)
        out[lo:lo + cb] = int8_matmul(cols, wmat).reshape(cb, oh, ow, cout)
    return out


def plain_int8_conv(qx: torch.Tensor, qweight: torch.Tensor, stride, pad,
                    dilation) -> torch.Tensor:
    """:func:`int8_conv`'s int32 sums through a float64 ``F.conv2d``."""
    kh, kw = qweight.shape[:2]
    top, bottom, left, right = _conv_pads(qx.shape[1], qx.shape[2],
                                          (kh, kw), stride, pad, dilation)
    x = F.pad(qx.double().permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(x, qweight.double().permute(3, 2, 0, 1), stride=stride,
                 dilation=dilation)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def _epilogue(acc, sx, wscale, bias, dtype):
    out = acc.float() * sx * wscale
    if bias is not None:
        out = out + bias
    return out.to(dtype)


class QuantizedLinear(Module):
    """An int8 ``Linear`` (reference nn/quantized/Linear.scala): ``qweight``
    (out, in) int8, ``wscale`` (out,), ``bias`` as the layer's."""

    def __init__(self, linear: Linear):
        super().__init__()
        qw, sw = _quantize_per_channel(linear.weight.detach(), 0)
        self.register_buffer("qweight", qw)
        self.register_buffer("wscale", sw.reshape(-1))
        self.register_buffer("bias", None if linear.bias is None
                             else linear.bias.detach().clone())
        self.input_size = linear.input_size
        self.output_size = linear.output_size

    def accumulate(self, x):
        """(int8 rows, their scales, the int32 sums) of a 2-D ``x``."""
        qx, sx = _quantize_rows(x)
        return qx, sx, int8_matmul(qx, self.qweight)

    def forward(self, x):
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        _, sx, acc = self.accumulate(x)
        out = _epilogue(acc, sx, self.wscale[None, :], self.bias, x.dtype)
        return out[0] if squeeze else out


class QuantizedSpatialConvolution(Module):
    """An int8 ``SpatialConvolution`` or ``SpatialDilatedConvolution``
    (reference nn/quantized/SpatialConvolution.scala): NHWC (NCHW through
    ``data_format``), ``qweight`` HWIO int8.  A grouped convolution
    raises ``NotImplementedError`` and stays float under ``Quantizer``."""

    def __init__(self, conv):
        super().__init__()
        if getattr(conv, "n_group", 1) != 1:
            raise NotImplementedError(
                "grouped conv quantization not supported")
        qw, sw = _quantize_per_channel(conv.weight.detach(), 3)
        self.register_buffer("qweight", qw)
        self.register_buffer("wscale", sw.reshape(-1))
        self.register_buffer("bias", None if conv.bias is None
                             else conv.bias.detach().clone())
        self.stride = tuple(conv.stride)
        self.pad = tuple(conv.pad)
        self.dilation = tuple(getattr(conv, "dilation", (1, 1)))
        self.data_format = conv.data_format

    def accumulate(self, x):
        """(int8 activations, their scales, the int32 sums, NHWC) of an
        NHWC ``x``."""
        qx, sx = _quantize_rows(x)
        return qx, sx, int8_conv(qx, self.qweight, self.stride, self.pad,
                                 self.dilation)

    def forward(self, x):
        if self.data_format == "NCHW":
            x = x.permute(0, 2, 3, 1)
        _, sx, acc = self.accumulate(x)
        out = _epilogue(acc, sx, self.wscale, self.bias, x.dtype)
        if self.data_format == "NCHW":
            out = out.permute(0, 3, 1, 2)
        return out


class Quantizer:
    """Walk a trained model and swap quantizable layers for int8 versions
    (reference nn/quantized/Quantizer.scala): exact types only, on an
    evaluation-mode copy; the model itself is left as it was."""

    SWAPS = {
        Linear: QuantizedLinear,
        SpatialConvolution: QuantizedSpatialConvolution,
        SpatialDilatedConvolution: QuantizedSpatialConvolution,
    }

    @classmethod
    def quantize(cls, model: nn.Module) -> nn.Module:
        model = clone(model).train(False)
        swapped = cls._maybe_swap(model)
        if swapped is model:
            cls._walk(model)
        return swapped

    @classmethod
    def _maybe_swap(cls, mod: nn.Module) -> nn.Module:
        dst = cls.SWAPS.get(type(mod))
        if dst is None:
            return mod
        try:
            return dst(mod)
        except NotImplementedError:
            return mod

    @classmethod
    def _walk(cls, mod: nn.Module):
        # a ModuleList's items are its children "0", "1", ... here
        for name, child in list(mod._modules.items()):
            if child is None:
                continue
            swapped = cls._maybe_swap(child)
            if swapped is not child:
                mod._modules[name] = swapped
            else:
                cls._walk(child)


def quantize(model: nn.Module) -> nn.Module:
    """``quantize(model)`` (reference AbstractModule.quantize)."""
    return Quantizer.quantize(model)
