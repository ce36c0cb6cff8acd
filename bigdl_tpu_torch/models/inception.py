"""Inception v1 (GoogLeNet) and v2 (BN-Inception) (counterpart of
``bigdl_tpu/models/inception.py``; the reference's
models/inception/Inception_v1.scala and Inception_v2.scala).  NHWC; each
inception block runs parallel towers concatenated on the channel axis.
Every convolution is Xavier-initialised; the modules keep the
reference's names (``set_name("3a")``, ``conv1/7x7_s2``) and attributes
(``stem``, ``i3a`` ... ``i5b``, v2's ``blocks`` list, ``head``), so the
reference's weights load by name.  Both towers end in a global mean over
the grid and ``log_softmax``; v1's ``Dropout(0.4)`` acts in training
only.  Weights are drawn from the caller's ``torch.Generator`` on the
CPU and moved to ``device`` (default ``cuda``)."""

from __future__ import annotations

import torch
from torch import nn as tnn

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.module import Module

__all__ = ["InceptionModule", "Inception_v1", "InceptionV2Module",
           "Inception_v2", "inception_module"]


def _conv(nin, nout, kw, kh, sw=1, sh=1, pw=0, ph=0, name="", *, gen):
    c = nn.SpatialConvolution(nin, nout, kw, kh, sw, sh, pw, ph,
                              init_method=init_methods.Xavier, **gen)
    if name:
        c.set_name(name)
    return c


class InceptionModule(Module):
    """One inception block (reference Inception_v1.scala inception()):
    1x1, 1x1 → 3x3, 1x1 → 5x5 and 3x3 max pool → 1x1 towers."""

    def __init__(self, input_size, c1x1, c3x3r, c3x3, c5x5r, c5x5, pool_proj,
                 name="inception", *, generator: torch.Generator,
                 device=None):
        super().__init__()
        gen = dict(generator=generator, device=device)
        self.b1 = nn.Sequential(_conv(input_size, c1x1, 1, 1, gen=gen),
                                nn.ReLU())
        self.b2 = nn.Sequential(
            _conv(input_size, c3x3r, 1, 1, gen=gen), nn.ReLU(),
            _conv(c3x3r, c3x3, 3, 3, 1, 1, 1, 1, gen=gen), nn.ReLU())
        self.b3 = nn.Sequential(
            _conv(input_size, c5x5r, 1, 1, gen=gen), nn.ReLU(),
            _conv(c5x5r, c5x5, 5, 5, 1, 1, 2, 2, gen=gen), nn.ReLU())
        self.b4 = nn.Sequential(
            nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1),
            _conv(input_size, pool_proj, 1, 1, gen=gen), nn.ReLU())
        self.set_name(name)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                         dim=-1)


def inception_module(*args, **kw):
    return InceptionModule(*args, **kw)


class Inception_v1(Module):
    """GoogLeNet's main tower (reference Inception_v1.scala; the two
    auxiliary classifiers are train-time extras there and are left out,
    as in the reference package)."""

    def __init__(self, class_num: int = 1000, has_dropout: bool = True, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        gen = dict(generator=generator, device=device)
        self.stem = nn.Sequential(
            _conv(3, 64, 7, 7, 2, 2, 3, 3, "conv1/7x7_s2", gen=gen),
            nn.ReLU(),
            nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
            nn.SpatialCrossMapLRN(5, 0.0001, 0.75),
            _conv(64, 64, 1, 1, name="conv2/3x3_reduce", gen=gen), nn.ReLU(),
            _conv(64, 192, 3, 3, 1, 1, 1, 1, "conv2/3x3", gen=gen),
            nn.ReLU(),
            nn.SpatialCrossMapLRN(5, 0.0001, 0.75),
            nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
        self.i3a = InceptionModule(192, 64, 96, 128, 16, 32, 32, "3a", **gen)
        self.i3b = InceptionModule(256, 128, 128, 192, 32, 96, 64, "3b",
                                   **gen)
        self.pool3 = nn.SpatialMaxPooling(3, 3, 2, 2).ceil()
        self.i4a = InceptionModule(480, 192, 96, 208, 16, 48, 64, "4a", **gen)
        self.i4b = InceptionModule(512, 160, 112, 224, 24, 64, 64, "4b",
                                   **gen)
        self.i4c = InceptionModule(512, 128, 128, 256, 24, 64, 64, "4c",
                                   **gen)
        self.i4d = InceptionModule(512, 112, 144, 288, 32, 64, 64, "4d",
                                   **gen)
        self.i4e = InceptionModule(528, 256, 160, 320, 32, 128, 128, "4e",
                                   **gen)
        self.pool4 = nn.SpatialMaxPooling(3, 3, 2, 2).ceil()
        self.i5a = InceptionModule(832, 256, 160, 320, 32, 128, 128, "5a",
                                   **gen)
        self.i5b = InceptionModule(832, 384, 192, 384, 48, 128, 128, "5b",
                                   **gen)
        self.has_dropout = has_dropout
        if has_dropout:
            self.dropout = nn.Dropout(0.4)
        self.head = nn.Linear(1024, class_num, **gen)

    def forward(self, x):
        y = self.stem(x)
        y = self.pool3(self.i3b(self.i3a(y)))
        y = self.i4e(self.i4d(self.i4c(self.i4b(self.i4a(y)))))
        y = self.pool4(y)
        y = self.i5b(self.i5a(y))
        y = torch.mean(y, dim=(1, 2))
        if self.has_dropout and self.training:
            y = self.dropout(y)
        return torch.log_softmax(self.head(y), dim=-1)


def _cbr(nin, nout, k, stride=1, pad=0, name="", *, gen):
    """conv → BN(eps 1e-3) → ReLU, v2's unit (Inception_v2.scala puts a
    SpatialBatchNormalization(·, 1e-3) after every convolution)."""
    return [_conv(nin, nout, k, k, stride, stride, pad, pad, name, gen=gen),
            nn.SpatialBatchNormalization(nout, eps=1e-3, **gen),
            nn.ReLU()]


class InceptionV2Module(Module):
    """One BN-inception block (reference Inception_Layer_v2,
    Inception_v2.scala:28): an optional 1x1 tower, a 3x3 tower, a double
    3x3 tower and a pool tower with an optional projection.
    ``pool_type == "max"`` with no projection is the grid reduction:
    both conv towers and the pool stride 2, the input rides the pool
    tower unprojected."""

    def __init__(self, input_size, c1, c3r, c3, d3r, d3,
                 pool_type="avg", pool_proj=0, name="inception", *,
                 generator: torch.Generator, device=None):
        super().__init__()
        gen = dict(generator=generator, device=device)
        downsample = pool_type == "max" and pool_proj == 0
        self.downsample = downsample
        stride = 2 if downsample else 1
        if c1:
            self.b1 = nn.Sequential(*_cbr(input_size, c1, 1, gen=gen))
        self.has_b1 = bool(c1)
        self.b2 = nn.Sequential(*_cbr(input_size, c3r, 1, gen=gen),
                                *_cbr(c3r, c3, 3, stride, 1, gen=gen))
        self.b3 = nn.Sequential(*_cbr(input_size, d3r, 1, gen=gen),
                                *_cbr(d3r, d3, 3, 1, 1, gen=gen),
                                *_cbr(d3, d3, 3, stride, 1, gen=gen))
        if downsample:
            pool = nn.SpatialMaxPooling(3, 3, 2, 2).ceil()
        elif pool_type == "max":
            pool = nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()
        else:
            pool = nn.SpatialAveragePooling(3, 3, 1, 1, 1, 1).ceil()
        layers = [pool]
        if pool_proj:
            layers += _cbr(input_size, pool_proj, 1, gen=gen)
        self.b4 = nn.Sequential(*layers)
        self.set_name(name)

    def forward(self, x):
        if self.downsample and (x.shape[1] % 2 or x.shape[2] % 2):
            # on an odd grid the stride-2 conv towers round the size down
            # and the ceil-mode pool rounds it up: the concat cannot meet
            raise ValueError(
                f"Inception_v2 grid-reduction block {self.name!r} needs "
                f"an even feature map, got {x.shape[1]}x{x.shape[2]}; "
                f"use an input size divisible by 32 (e.g. 224)")
        towers = ([self.b1(x)] if self.has_b1 else []) \
            + [self.b2(x), self.b3(x), self.b4(x)]
        return torch.cat(towers, dim=-1)


class Inception_v2(Module):
    """BN-Inception's main tower (reference Inception_v2_NoAuxClassifier,
    Inception_v2.scala:185)."""

    def __init__(self, class_num: int = 1000, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        gen = dict(generator=generator, device=device)
        self.stem = nn.Sequential(
            *_cbr(3, 64, 7, 2, 3, "conv1/7x7_s2", gen=gen),
            nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
            *_cbr(64, 64, 1, name="conv2/3x3_reduce", gen=gen),
            *_cbr(64, 192, 3, 1, 1, "conv2/3x3", gen=gen),
            nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
        cfg = [
            (192, 64, 64, 64, 64, 96, "avg", 32, "3a"),
            (256, 64, 64, 96, 64, 96, "avg", 64, "3b"),
            (320, 0, 128, 160, 64, 96, "max", 0, "3c"),
            (576, 224, 64, 96, 96, 128, "avg", 128, "4a"),
            (576, 192, 96, 128, 96, 128, "avg", 128, "4b"),
            (576, 160, 128, 160, 128, 160, "avg", 96, "4c"),
            (576, 96, 128, 192, 160, 192, "avg", 96, "4d"),
            (576, 0, 128, 192, 192, 256, "max", 0, "4e"),
            (1024, 352, 192, 320, 160, 224, "avg", 128, "5a"),
            (1024, 352, 192, 320, 192, 224, "max", 128, "5b"),
        ]
        self.blocks = tnn.ModuleList(
            [InceptionV2Module(*c[:-1], name=c[-1], **gen) for c in cfg])
        self.head = nn.Linear(1024, class_num, **gen)

    def forward(self, x):
        y = self.stem(x)
        for b in self.blocks:
            y = b(y)
        y = torch.mean(y, dim=(1, 2))  # the 7x7 global average pool
        return torch.log_softmax(self.head(y), dim=-1)
