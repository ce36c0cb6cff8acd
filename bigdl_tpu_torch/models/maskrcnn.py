"""Mask R-CNN inference (counterpart of ``bigdl_tpu/models/maskrcnn.py``):
a ResNet-50-FPN backbone, the region proposal network, the box head and
the mask head of ``nn/detection.py``, every stage at static shapes with
validity masks, so that a forward reads nothing back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.models.resnet import Bottleneck
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.detection import (FPN, BoxHead, MaskHead,
                                          RegionProposal)
from bigdl_tpu_torch.nn.normalization import SpatialBatchNormalization
from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling

__all__ = ["MaskRCNN", "MaskRCNNParams", "ResNetFPNBackbone"]


@dataclass
class MaskRCNNParams:
    """The reference's MaskRCNNParams (models/maskrcnn/MaskRCNN.scala:35)."""
    anchor_sizes: Tuple[float, ...] = (32, 64, 128, 256, 512)
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_stride: Tuple[float, ...] = (4, 8, 16, 32, 64)
    pre_nms_topn_test: int = 1000
    post_nms_topn_test: int = 1000
    pre_nms_topn_train: int = 2000
    post_nms_topn_train: int = 2000
    rpn_nms_thresh: float = 0.7
    min_size: int = 0
    box_resolution: int = 7
    mask_resolution: int = 14
    scales: Tuple[float, ...] = (0.25, 0.125, 0.0625, 0.03125)
    sampling_ratio: int = 2
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    max_per_image: int = 100
    output_size: int = 1024
    layers: Tuple[int, ...] = (256, 256, 256, 256)
    dilation: int = 1
    use_gn: bool = False


class ResNetFPNBackbone(Module):
    """ResNet-50 C2–C5 (the port's ``Bottleneck``) and an FPN with P6
    (the reference's MaskRCNN.buildBackbone)."""

    def __init__(self, out_channels: int = 256, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(generator=generator, device=dev)
        self.stem_conv = SpatialConvolution(
            3, 64, 7, 7, 2, 2, 3, 3, with_bias=False,
            init_method=init_methods.MsraFiller(False), **kw)
        self.stem_bn = SpatialBatchNormalization(64, eps=1e-3, **kw)
        self.stem_pool = SpatialMaxPooling(3, 3, 2, 2, 1, 1)
        stages = []
        nin = 64
        for width, blocks, stride in ((64, 3, 1), (128, 4, 2),
                                      (256, 6, 2), (512, 3, 2)):
            stage = []
            for i in range(blocks):
                stage.append(Bottleneck(nin, width,
                                        stride if i == 0 else 1, **kw))
                nin = width * Bottleneck.expansion
            stages.append(torch.nn.ModuleList(stage))
        self.stages = torch.nn.ModuleList(stages)
        self.fpn = FPN([256, 512, 1024, 2048], out_channels, top_blocks=1,
                       **kw)

    def forward(self, x) -> List[torch.Tensor]:
        y = self.stem_pool(torch.relu(self.stem_bn(self.stem_conv(x))))
        cs = []
        for stage in self.stages:
            for block in stage:
                y = block(y)
            cs.append(y)
        return self.fpn(cs)


class MaskRCNN(Module):
    """``forward((images (1, H, W, 3), image_info (4,)))`` →
    ``(boxes (max_per_image, 4), labels, scores, valid, masks
    (max_per_image, 2 * mask_resolution, 2 * mask_resolution))``.
    ``image_info`` holds (height, width, original height, original
    width); the first two clip the boxes.  Resizing masks to the original
    image is a host-side step, left out as in the reference."""

    def __init__(self, in_channels: int = 256, out_channels: int = 256,
                 num_classes: int = 81, config: MaskRCNNParams = None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(generator=generator, device=dev)
        cfg = config or MaskRCNNParams()
        self.config = cfg
        self.backbone = ResNetFPNBackbone(out_channels, **kw)
        self.rpn = RegionProposal(
            in_channels, cfg.anchor_sizes, cfg.aspect_ratios,
            cfg.anchor_stride, cfg.pre_nms_topn_test,
            cfg.post_nms_topn_test, cfg.pre_nms_topn_train,
            cfg.post_nms_topn_train, cfg.rpn_nms_thresh, cfg.min_size, **kw)
        self.box_head = BoxHead(
            in_channels, cfg.box_resolution, cfg.scales,
            cfg.sampling_ratio, cfg.box_score_thresh, cfg.box_nms_thresh,
            cfg.max_per_image, cfg.output_size, num_classes, **kw)
        self.mask_head = MaskHead(
            in_channels, cfg.mask_resolution, cfg.scales,
            cfg.sampling_ratio, cfg.layers, cfg.dilation, num_classes,
            use_gn=cfg.use_gn, **kw)

    def forward(self, inputs):
        images, image_info = inputs
        im_hw = image_info[:2]
        features = self.backbone(images)
        proposals, prop_scores = self.rpn((features, im_hw))
        boxes, labels, scores, valid = self.box_head(
            (features, proposals, im_hw, prop_scores > float("-inf")))
        masks, _ = self.mask_head((features, boxes, labels))
        masks = torch.where(valid[:, None, None], masks, 0.0)
        return boxes, labels, scores, valid, masks
