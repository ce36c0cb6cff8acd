"""VGG-16/19 and the CIFAR-10 variant (counterpart of
``bigdl_tpu/models/vgg.py``; the reference's models/vgg/VggForCifar10.scala
and the Vgg_16/Vgg_19 builders of its perf tool).  NHWC input; the
layers sit in one ``Sequential`` in the reference's order, so the
reference's ``layers[i]`` weights load by name.  The CIFAR variant's max
pools round up (ceil), the ImageNet ones down; ``Vgg_16``'s head is
``Linear(512 * 7 * 7, 4096)``, so it takes 224 x 224 images.  Weights
are drawn from the caller's ``torch.Generator`` on the CPU and moved to
``device`` (default ``cuda``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn

__all__ = ["VggForCifar10", "Vgg_16", "Vgg_19"]


def _block(seq, nin, nout, with_bn, kw):
    seq.add(nn.SpatialConvolution(nin, nout, 3, 3, 1, 1, 1, 1, **kw))
    if with_bn:
        seq.add(nn.SpatialBatchNormalization(nout, 1e-3, **kw))
    seq.add(nn.ReLU())
    return nout


def VggForCifar10(class_num: int = 10, has_dropout: bool = True, *,
                  generator: torch.Generator, device=None) -> nn.Sequential:
    """Conv-BN VGG for 32 x 32 inputs (reference VggForCifar10.scala)."""
    kw = dict(generator=generator, device=device)
    m = nn.Sequential()
    cfg = [(3, 64), (64, 64), "M", (64, 128), (128, 128), "M",
           (128, 256), (256, 256), (256, 256), "M",
           (256, 512), (512, 512), (512, 512), "M",
           (512, 512), (512, 512), (512, 512), "M"]
    for c in cfg:
        if c == "M":
            m.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
        else:
            _block(m, c[0], c[1], True, kw)
    m.add(nn.Flatten())
    m.add(nn.Linear(512, 512, **kw))
    m.add(nn.BatchNormalization(512, **kw))
    m.add(nn.ReLU())
    if has_dropout:
        m.add(nn.Dropout(0.5))
    m.add(nn.Linear(512, class_num, **kw))
    m.add(nn.LogSoftMax())
    return m


def _vgg(cfg, class_num, has_dropout, kw):
    m = nn.Sequential()
    nin = 3
    for c in cfg:
        if c == "M":
            m.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            nin = _block(m, nin, c, False, kw)
    m.add(nn.Flatten())
    m.add(nn.Linear(512 * 7 * 7, 4096, **kw))
    m.add(nn.ReLU())
    if has_dropout:
        m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, 4096, **kw))
    m.add(nn.ReLU())
    if has_dropout:
        m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, class_num, **kw))
    m.add(nn.LogSoftMax())
    return m


def Vgg_16(class_num: int = 1000, has_dropout: bool = True, *,
           generator: torch.Generator, device=None) -> nn.Sequential:
    return _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                 512, 512, 512, "M", 512, 512, 512, "M"],
                class_num, has_dropout,
                dict(generator=generator, device=device))


def Vgg_19(class_num: int = 1000, has_dropout: bool = True, *,
           generator: torch.Generator, device=None) -> nn.Sequential:
    return _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
                class_num, has_dropout,
                dict(generator=generator, device=device))
