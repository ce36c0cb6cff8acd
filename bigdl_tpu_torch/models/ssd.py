"""SSD-300 over VGG16 (counterpart of ``bigdl_tpu/models/ssd.py``;
BASELINE config #5): the reference's architecture and Caffe-SSD layer
names, NHWC activations and HWIO weights, so the JAX package's
parameters load by name (``interop.load_jax_parameters``).

Input: [B, 300, 300, 3] mean-subtracted BGR (Caffe's convention).
Output: [B, keep_top_k, 6] rows [label, score, x1, y1, x2, y2] in
normalised [0, 1] coordinates, empty rows all zero; 8,732 priors.
"""

from __future__ import annotations

from typing import List

import torch

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                     SpatialDilatedConvolution)
from bigdl_tpu_torch.nn.detection import DetectionOutputSSD, PriorBox
from bigdl_tpu_torch.nn.normalization import NormalizeScale
from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling

__all__ = ["SSDVGG16", "ssd_vgg16_300"]

# (min_size, max_size, aspect_ratios, step, n_priors) per source map
_SSD300_PRIORS = [
    (30.0, 60.0, (2.0,), 8.0, 4),          # conv4_3_norm, 38x38
    (60.0, 111.0, (2.0, 3.0), 16.0, 6),    # fc7, 19x19
    (111.0, 162.0, (2.0, 3.0), 32.0, 6),   # conv6_2, 10x10
    (162.0, 213.0, (2.0, 3.0), 64.0, 6),   # conv7_2, 5x5
    (213.0, 264.0, (2.0,), 100.0, 4),      # conv8_2, 3x3
    (264.0, 315.0, (2.0,), 300.0, 4),      # conv9_2, 1x1
]


def _conv(nin, nout, k, stride=1, pad=0, dilation=1, name="", **kw):
    if dilation != 1:
        m = SpatialDilatedConvolution(nin, nout, k, k, stride, stride, pad,
                                      pad, dilation, dilation, **kw)
    else:
        m = SpatialConvolution(nin, nout, k, k, stride, stride, pad, pad,
                               **kw)
    return m.set_name(name)


class SSDVGG16(Module):
    """SSD-300 over the modified VGG16 base (fc6/fc7 as atrous convs,
    pool5 3x3/s1, an L2-normalised conv4_3 source)."""

    def __init__(self, class_num: int = 21, nms_thresh: float = 0.45,
                 nms_topk: int = 400, keep_top_k: int = 200,
                 conf_thresh: float = 0.01, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(generator=generator, device=dev)
        self.class_num = class_num
        cfg = [(3, 64, "conv1_1"), (64, 64, "conv1_2"),
               (64, 128, "conv2_1"), (128, 128, "conv2_2"),
               (128, 256, "conv3_1"), (256, 256, "conv3_2"),
               (256, 256, "conv3_3"),
               (256, 512, "conv4_1"), (512, 512, "conv4_2"),
               (512, 512, "conv4_3"),
               (512, 512, "conv5_1"), (512, 512, "conv5_2"),
               (512, 512, "conv5_3")]
        self.base = torch.nn.ModuleList(
            _conv(i, o, 3, pad=1, name=nm, **kw) for i, o, nm in cfg)
        self.pool = SpatialMaxPooling(2, 2, 2, 2)
        self.pool_ceil = SpatialMaxPooling(2, 2, 2, 2).ceil()
        self.pool5 = SpatialMaxPooling(3, 3, 1, 1, 1, 1)
        self.fc6 = _conv(512, 1024, 3, pad=6, dilation=6, name="fc6", **kw)
        self.fc7 = _conv(1024, 1024, 1, name="fc7", **kw)
        self.conv6_1 = _conv(1024, 256, 1, name="conv6_1", **kw)
        self.conv6_2 = _conv(256, 512, 3, stride=2, pad=1, name="conv6_2",
                             **kw)
        self.conv7_1 = _conv(512, 128, 1, name="conv7_1", **kw)
        self.conv7_2 = _conv(128, 256, 3, stride=2, pad=1, name="conv7_2",
                             **kw)
        self.conv8_1 = _conv(256, 128, 1, name="conv8_1", **kw)
        self.conv8_2 = _conv(128, 256, 3, name="conv8_2", **kw)
        self.conv9_1 = _conv(256, 128, 1, name="conv9_1", **kw)
        self.conv9_2 = _conv(128, 256, 3, name="conv9_2", **kw)
        self.conv4_3_norm = NormalizeScale(
            p=2.0, scale=20.0, size=(512,), device=dev) \
            .set_name("conv4_3_norm")
        src_channels = [512, 1024, 512, 256, 256, 256]
        src_names = ["conv4_3_norm", "fc7", "conv6_2", "conv7_2",
                     "conv8_2", "conv9_2"]
        locs, confs, priors = [], [], []
        for ch, name, (mn, mx, ars, step, np_) in zip(
                src_channels, src_names, _SSD300_PRIORS):
            locs.append(_conv(ch, np_ * 4, 3, pad=1,
                              name=f"{name}_mbox_loc", **kw))
            confs.append(_conv(ch, np_ * class_num, 3, pad=1,
                               name=f"{name}_mbox_conf", **kw))
            priors.append(PriorBox(
                min_sizes=[mn], max_sizes=[mx], aspect_ratios=list(ars),
                is_flip=True, is_clip=False,
                variances=[0.1, 0.1, 0.2, 0.2], offset=0.5,
                img_size=300, step=step))
        self.loc_layers = torch.nn.ModuleList(locs)
        self.conf_layers = torch.nn.ModuleList(confs)
        self.prior_layers = torch.nn.ModuleList(priors)
        self.detection = DetectionOutputSSD(
            n_classes=class_num, nms_thresh=nms_thresh, nms_topk=nms_topk,
            keep_top_k=keep_top_k, conf_thresh=conf_thresh)

    def feature_maps(self, x) -> List[torch.Tensor]:
        """The six SSD source maps (conv4_3_norm … conv9_2)."""
        r = torch.relu
        i = 0
        for upto, pool in ((2, self.pool), (4, self.pool),
                           (7, self.pool_ceil)):
            while i < upto:
                x = r(self.base[i](x))
                i += 1
            x = pool(x)
        while i < 10:
            x = r(self.base[i](x))
            i += 1
        s1 = self.conv4_3_norm(x)
        x = self.pool(x)
        while i < 13:
            x = r(self.base[i](x))
            i += 1
        x = self.pool5(x)
        x = r(self.fc6(x))
        s2 = r(self.fc7(x))
        x = r(self.conv6_1(s2))
        s3 = r(self.conv6_2(x))
        x = r(self.conv7_1(s3))
        s4 = r(self.conv7_2(x))
        x = r(self.conv8_1(s4))
        s5 = r(self.conv8_2(x))
        x = r(self.conv9_1(s5))
        s6 = r(self.conv9_2(x))
        return [s1, s2, s3, s4, s5, s6]

    def heads(self, x):
        """(loc (B, P*4), conf (B, P*C) after the softmax over classes,
        priors (2, P*4)): everything before DetectionOutputSSD."""
        b = x.shape[0]
        locs, confs, priors = [], [], []
        for src, loc_l, conf_l, prior_l in zip(
                self.feature_maps(x), self.loc_layers, self.conf_layers,
                self.prior_layers):
            locs.append(loc_l(src).reshape(b, -1))
            confs.append(conf_l(src).reshape(b, -1))
            priors.append(prior_l(src))
        conf = torch.softmax(torch.cat(confs, 1).reshape(
            b, -1, self.class_num), dim=-1).reshape(b, -1)
        return torch.cat(locs, 1), conf, torch.cat(priors, 1)

    def forward(self, x):
        return self.detection(self.heads(x))


def ssd_vgg16_300(class_num: int = 21, *, generator: torch.Generator,
                  device=None, **kw) -> SSDVGG16:
    """SSD-300 VGG16 (the reference whitepaper's fig10 benchmark
    model)."""
    return SSDVGG16(class_num=class_num, generator=generator, device=device,
                    **kw)
