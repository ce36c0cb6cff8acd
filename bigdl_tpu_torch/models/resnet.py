"""ResNet for CIFAR-10 (basic blocks) and ImageNet (bottlenecks,
ResNet-50): the counterpart of ``bigdl_tpu/models/resnet.py``.

NHWC activations and HWIO conv weights, as the reference keeps them; MSRA
init (fan_out) for the convs, ``RandomNormal(0, 0.01)`` for the head and
the last BN of each residual branch zero-initialised.  Global average
pooling is the mean over H and W.

The fused bottleneck.  With ``fused=True`` (or the environment variable
``BIGDL_TPU_TORCH_FUSED_CONVBN``) a train-mode ``Bottleneck`` runs its
1x1 convs through :func:`~bigdl_tpu_torch.ops.conv_bn_kernels.fused_matmul_bn`
(kernels #8/#9: the previous BN's normalize+ReLU applied to the input on
the fly, the next BN's batch statistics summed in the epilogue) and its
stride-1 3x3 conv2 through ``fused_conv3x3_bn`` (kernels #10/#11), so
the normalized activations inside the block are never written out.  It
falls back to the plain path where the reference does: eval mode, a
non-NHWC BN, a strided conv2 (plain conv, statistics here) and shapes the
kernels cannot take.  The variable takes the reference's values: ``0``
(off everywhere), ``1`` (the default set) or a comma list drawn from
``conv1,conv2,conv3``; ``force`` is accepted and means the same as ``1``:
the port's device rule already decides, CUDA tensors launching the
kernels and CPU tensors running their plain versions.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import SpatialBatchNormalization
from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling
from bigdl_tpu_torch.ops import conv_bn_kernels as ck

__all__ = ["ResNet", "resnet_cifar", "resnet50", "BasicBlock", "Bottleneck",
           "FUSED_ENV"]

FUSED_ENV = "BIGDL_TPU_TORCH_FUSED_CONVBN"


def _conv(nin, nout, k, stride, pad, gen, dev):
    return SpatialConvolution(nin, nout, k, k, stride, stride, pad, pad,
                              with_bias=False,
                              init_method=init_methods.MsraFiller(False),
                              generator=gen, device=dev)


def _bn(n, gen, dev, zero=False):
    return SpatialBatchNormalization(
        n, init_weight=torch.zeros(n) if zero else None, generator=gen,
        device=dev)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (reference ResNet.scala basicBlock)."""

    expansion = 1

    def __init__(self, nin, nout, stride=1, zero_init_residual=True, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        g = generator
        self.conv1 = _conv(nin, nout, 3, stride, 1, g, dev)
        self.bn1 = _bn(nout, g, dev)
        self.conv2 = _conv(nout, nout, 3, 1, 1, g, dev)
        self.bn2 = _bn(nout, g, dev, zero_init_residual)
        self.has_down = stride != 1 or nin != nout
        if self.has_down:
            self.down_conv = _conv(nin, nout, 1, stride, 0, g, dev)
            self.down_bn = _bn(nout, g, dev)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        sc = self.down_bn(self.down_conv(x)) if self.has_down else x
        return torch.relu(y + sc)


def _norm_vectors(bn, mean, var):
    """(mean, scale, beta) f32 vectors folding ``bn``'s batch statistics
    into the kernels' subtract-first normalize."""
    inv = torch.rsqrt(var.float() + bn.eps)
    return mean.float(), inv * bn.weight.float(), bn.bias.float()


class Bottleneck(nn.Module):
    """1x1 / 3x3 / 1x1 bottleneck (reference ResNet.scala bottleneck);
    ``fused`` routes train mode through the conv+BN kernels (see the
    module docstring)."""

    expansion = 4
    _FUSABLE = frozenset({"conv1", "conv2", "conv3"})

    def __init__(self, nin, planes, stride=1, zero_init_residual=True,
                 fused=False, *, generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        g = generator
        nout = planes * self.expansion
        self.conv1 = _conv(nin, planes, 1, 1, 0, g, dev)
        self.bn1 = _bn(planes, g, dev)
        self.conv2 = _conv(planes, planes, 3, stride, 1, g, dev)
        self.bn2 = _bn(planes, g, dev)
        self.conv3 = _conv(planes, nout, 1, 1, 0, g, dev)
        self.bn3 = _bn(nout, g, dev, zero_init_residual)
        self.has_down = stride != 1 or nin != nout
        if self.has_down:
            self.down_conv = _conv(nin, nout, 1, stride, 0, g, dev)
            self.down_bn = _bn(nout, g, dev)
        self.fused = fused

    def _fused_selection(self):
        """Which convs to fuse, or None for the plain path."""
        env = os.environ.get(FUSED_ENV)
        if env == "0" or (not self.fused and not env):
            return None
        if not self.training or self.bn1.data_format != "NHWC":
            return None
        parts = {p.strip() for p in (env or "").split(",")
                 if p.strip() not in ("", "0", "1", "force")}
        unknown = parts - self._FUSABLE
        if unknown:
            raise ValueError(
                f"{FUSED_ENV}: unknown selector(s) {sorted(unknown)}; "
                f"valid: {sorted(self._FUSABLE)}, force, 0, 1")
        return parts or set(self._FUSABLE)

    def forward(self, x):
        sel = self._fused_selection()
        if sel is not None:
            return self._forward_fused(x, sel)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = self.down_bn(self.down_conv(x)) if self.has_down else x
        return torch.relu(y + sc)

    def _forward_fused(self, x, sel):
        # conv1: a 1x1 product with bn1's statistics as its epilogue
        b, h, w, cin = x.shape
        w1 = self.conv1.weight[0, 0]
        m1, n1 = b * h * w, w1.shape[1]
        if "conv1" in sel and ck.fused_block_supported(
                m1, cin, n1, x.element_size()):
            y1, s1, s2 = ck.fused_matmul_bn(
                x.reshape(m1, cin), w1,
                kshift=self.bn1.running_mean.detach())
            y1 = y1.reshape(b, h, w, n1)
            mean1, var1 = self.bn1.fold_stats(s1 / m1, s2 / m1, m1)
        else:
            y1 = self.conv1(x)
            d1, q1 = self.bn1.batch_stats(y1)
            mean1, var1 = self.bn1.fold_stats(d1, q1, m1)
        # conv2: a stride-1 3x3 applies bn1's normalize+ReLU on the fly
        # and sums bn2's statistics; a strided conv2 stays plain
        w2 = self.conv2.weight
        if ("conv2" in sel and self.conv2.stride == (1, 1)
                and ck.fused_conv3x3_supported(
                    y1.shape[1], y1.shape[2], y1.shape[3], w2.shape[-1],
                    y1.element_size())):
            y2, u1, u2 = ck.fused_conv3x3_bn(
                y1, w2, norm=_norm_vectors(self.bn1, mean1, var1),
                kshift=self.bn2.running_mean.detach())
            m2n = self.bn2.stat_count(y2)
            mean2, var2 = self.bn2.fold_stats(u1 / m2n, u2 / m2n, m2n)
        else:
            z1 = torch.relu(self.bn1.normalize(y1, mean1, var1))
            y2 = self.conv2(z1)
            d2, q2 = self.bn2.batch_stats(y2)
            mean2, var2 = self.bn2.fold_stats(d2, q2,
                                              self.bn2.stat_count(y2))
        # conv3: a 1x1 applying bn2's normalize+ReLU, bn3's statistics
        bb, hh, ww, p = y2.shape
        w3 = self.conv3.weight[0, 0]
        m3, n3 = bb * hh * ww, w3.shape[1]
        if "conv3" in sel and ck.fused_block_supported(
                m3, p, n3, y2.element_size()):
            y3, t1, t2 = ck.fused_matmul_bn(
                y2.reshape(m3, p), w3,
                norm=_norm_vectors(self.bn2, mean2, var2),
                kshift=self.bn3.running_mean.detach())
            y3 = y3.reshape(bb, hh, ww, n3)
            mean3, var3 = self.bn3.fold_stats(t1 / m3, t2 / m3, m3)
        else:
            z2 = torch.relu(self.bn2.normalize(y2, mean2, var2))
            y3 = self.conv3(z2)
            d3, q3 = self.bn3.batch_stats(y3)
            mean3, var3 = self.bn3.fold_stats(d3, q3, m3)

        z3 = self.bn3.normalize(y3, mean3, var3)
        sc = self.down_bn(self.down_conv(x)) if self.has_down else x
        return torch.relu(z3 + sc)


class ResNet(nn.Module):
    """Reference ResNet.scala apply(): ImageNet stem (7x7/2 conv, BN,
    ReLU, 3x3/2 max pool) or the CIFAR stem, then the stages."""

    def __init__(self, block, layers, class_num=1000, cifar=False,
                 zero_init_residual=True, fused=False, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        g = generator
        self.cifar = cifar
        if cifar:
            self.stem_conv = _conv(3, 16, 3, 1, 1, g, dev)
            self.stem_bn = _bn(16, g, dev)
            nin, widths, strides = 16, [16, 32, 64], [1, 2, 2]
        else:
            self.stem_conv = _conv(3, 64, 7, 2, 3, g, dev)
            self.stem_bn = _bn(64, g, dev)
            self.stem_pool = SpatialMaxPooling(3, 3, 2, 2, 1, 1)
            nin, widths, strides = 64, [64, 128, 256, 512], [1, 2, 2, 2]
        blocks = []
        for w, s, n in zip(widths, strides, layers):
            for i in range(n):
                kw = {"fused": fused} if block is Bottleneck else {}
                blocks.append(block(nin, w, s if i == 0 else 1,
                                    zero_init_residual, **kw, generator=g,
                                    device=dev))
                nin = w * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Linear(nin, class_num, generator=g, device=dev,
                           init_method=init_methods.RandomNormal(0, 0.01))

    def forward(self, x):
        y = torch.relu(self.stem_bn(self.stem_conv(x)))
        if not self.cifar:
            y = self.stem_pool(y)
        for b in self.blocks:
            y = b(y)
        return self.head(y.mean(dim=(1, 2)))   # global average pool


def resnet_cifar(depth: int = 20, class_num: int = 10, *,
                 generator: torch.Generator, device=None) -> ResNet:
    """CIFAR ResNet (reference ResNet.scala CIFAR-10 path): depth 6n+2."""
    if (depth - 2) % 6:
        raise ValueError(f"depth must be 6n + 2, got {depth}")
    n = (depth - 2) // 6
    return ResNet(BasicBlock, [n, n, n], class_num, cifar=True,
                  generator=generator, device=device)


def resnet50(class_num: int = 1000, fused=False, *,
             generator: torch.Generator,
             device: Optional[str] = None) -> ResNet:
    """ImageNet ResNet-50 (reference TrainImageNet recipe); ``fused``
    routes train-mode bottlenecks through the conv+BN kernels."""
    return ResNet(Bottleneck, [3, 4, 6, 3], class_num, fused=fused,
                  generator=generator, device=device)
