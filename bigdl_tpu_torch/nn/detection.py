"""The object-detection layers (counterpart of ``bigdl_tpu/nn/detection.py``,
whole): box arithmetic, NMS, anchors, RoiAlign / RoiPooling, FPN, Pooler,
the region proposal layers, the box and mask heads, SSD's PriorBox and
DetectionOutputSSD, Faster R-CNN's DetectionOutputFrcnn and the two
detection criteria.

The reference keeps static shapes and validity masks (fixed output slots,
``-inf`` scores and zero boxes in empty ones), and so does the port, so
that a forward reads nothing back to the host.  Where the reference loops
in Python over classes or pyramid levels around :func:`nms`, the port
makes one batched call: :func:`nms` takes leading batch dims and runs
the reference's greedy loop once over every (image, class) or level row,
two device ops a step.  Its arithmetic is the reference's: the same IoU
expression, a suppression where IoU > the threshold, every ranking a
stable descending sort (:func:`_ranked`: ties to the lower index, as
``jax.lax.top_k`` and ``jnp.argsort`` break them), and the same
compaction of the kept slots.

:class:`Pooler` gathers each ROI from its own level only: the levels'
maps are flattened into one buffer and each ROI's samples are indexed at
its level's offset, height, width and scale, one gather for every level
(the reference pools every ROI from every level and selects by mask).
:class:`PriorBox` and :class:`Anchor` compute their boxes on the host in
numpy, as the reference's do, and cache them on the device per feature
map shape.
"""

from __future__ import annotations

import math
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                     SpatialDilatedConvolution,
                                     SpatialFullConvolution)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import GroupNorm

__all__ = [
    "Anchor", "Nms", "nms", "box_iou", "bbox_transform_inv", "bbox_encode",
    "clip_boxes", "RoiAlign", "RoiPooling", "FPN", "Pooler",
    "RegionProposal", "Proposal", "BoxHead", "MaskHead", "PriorBox",
    "DetectionOutputSSD", "DetectionOutputFrcnn",
    "SmoothL1CriterionWithWeights", "SoftmaxWithCriterion",
]

_NEG_INF = float("-inf")


def _upto(x, hi):
    """min(x, hi), ``hi`` a number or a tensor (an image size on the
    device)."""
    return torch.minimum(x, hi) if torch.is_tensor(hi) else \
        torch.clamp(x, max=hi)


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: min(max(x, lo), hi)."""
    return _upto(torch.clamp(x, min=lo), hi)


# --------------------------------------------------------------------------
# Box utilities (reference transform/vision/image/util/BboxUtil.scala)
# --------------------------------------------------------------------------

def box_iou(a, b):
    """Pairwise IoU of corner boxes ``a (..., N, 4)`` and ``b (..., M, 4)``
    → ``(..., N, M)``, the reference's expression per coordinate."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    w = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                    min=0)
    h = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                    min=0)
    inter = w * h
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) \
        * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) \
        * torch.clamp(b[..., 3] - b[..., 1], min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def bbox_transform_inv(boxes, deltas, weights=(1.0, 1.0, 1.0, 1.0),
                       clip_h: float = math.log(1000.0 / 16)):
    """Decode regression ``deltas (..., 4)`` against ``boxes (..., 4)``
    (reference BboxUtil.bboxTransformInv)."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    dx, dy, dw, dh = (deltas[..., 0] / wx, deltas[..., 1] / wy,
                      deltas[..., 2] / ww, deltas[..., 3] / wh)
    dw = torch.clamp(dw, max=clip_h)
    dh = torch.clamp(dh, max=clip_h)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w,
                        pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w - 1.0,
                        pred_ctr_y + 0.5 * pred_h - 1.0], dim=-1)


def bbox_encode(ex_boxes, gt_boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """Inverse of :func:`bbox_transform_inv` (training targets)."""
    wx, wy, ww, wh = weights
    ex_w = ex_boxes[..., 2] - ex_boxes[..., 0] + 1.0
    ex_h = ex_boxes[..., 3] - ex_boxes[..., 1] + 1.0
    ex_cx = ex_boxes[..., 0] + 0.5 * ex_w
    ex_cy = ex_boxes[..., 1] + 0.5 * ex_h
    gt_w = gt_boxes[..., 2] - gt_boxes[..., 0] + 1.0
    gt_h = gt_boxes[..., 3] - gt_boxes[..., 1] + 1.0
    gt_cx = gt_boxes[..., 0] + 0.5 * gt_w
    gt_cy = gt_boxes[..., 1] + 0.5 * gt_h
    return torch.stack([wx * (gt_cx - ex_cx) / ex_w,
                        wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w),
                        wh * torch.log(gt_h / ex_h)], dim=-1)


def clip_boxes(boxes, height, width):
    """Clip corner boxes into ``[0, w-1] x [0, h-1]`` (``height`` and
    ``width`` numbers or 0-d tensors)."""
    return torch.stack([_clip(boxes[..., 0], 0, width - 1),
                        _clip(boxes[..., 1], 0, height - 1),
                        _clip(boxes[..., 2], 0, width - 1),
                        _clip(boxes[..., 3], 0, height - 1)], dim=-1)


# --------------------------------------------------------------------------
# NMS (reference nn/Nms.scala; the reference's masked fori_loop)
# --------------------------------------------------------------------------

def _ranked(scores, k: int):
    """(values, indices) of the ``k`` largest along the last dim, in
    descending order, ties to the lower index: ``jax.lax.top_k``'s
    order, by a stable sort (``torch.topk`` promises no tie order)."""
    values, indices = torch.sort(scores, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


def _overlaps(iou, iou_threshold: float):
    """Where a kept box suppresses a later one."""
    return iou > iou_threshold


def _greedy_keep(over, keep):
    """The reference's greedy loop over the score-sorted slots, on every
    leading row at once: if slot i survives, it suppresses every later
    slot it overlaps.  ``over (..., n, n)`` must already be masked to
    later slots; ``keep (..., n)`` is updated in place and returned.  No
    value is read back to the host."""
    for i in range(over.shape[-1]):
        keep.masked_fill_(over[..., i, :] & keep[..., i:i + 1], False)
    return keep


_NMS_LOCK = threading.Lock()


def nms(boxes, scores, iou_threshold: float, max_output: int,
        pre_topk: Optional[int] = None):
    """Greedy NMS with a static output size over ``boxes (..., n, 4)`` and
    ``scores (..., n)``, every leading row independent.

    Returns ``(indices, valid)``, each ``(..., max_output)``: indices
    (int64) into the input's last dims, kept slots first in score order,
    and their validity; invalid slots point at index 0.  A ``-inf`` score
    is never kept.  ``pre_topk`` first caps each row to its top-k scores
    (the reference's SSD cap, DetectionOutputSSD.scala:49).  Each call
    that runs the loop counts once in ``nms.launches`` and its steps in
    ``nms.steps``."""
    n = boxes.shape[-2]
    if pre_topk is not None and pre_topk < n:
        top_s, top_i = _ranked(scores, pre_topk)
        sub_boxes = torch.gather(
            boxes, -2, top_i[..., None].expand(*top_i.shape, 4))
        sub_idx, sub_valid = nms(sub_boxes, top_s, iou_threshold,
                                 max_output)
        return torch.gather(top_i, -1, sub_idx), sub_valid
    sscores, order = _ranked(scores, n)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape,
                                                             4))
    pos = torch.arange(n, device=boxes.device)
    over = _overlaps(box_iou(sboxes, sboxes), iou_threshold) \
        & (pos[None, :] > pos[:, None])
    keep = _greedy_keep(over, sscores > _NEG_INF)
    with _NMS_LOCK:
        nms.launches += 1
        nms.steps += n
    # compact: kept slots first, preserving score order
    perm = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    if n >= max_output:
        perm = perm[..., :max_output]
    else:
        perm = F.pad(perm, (0, max_output - n))
    valid = torch.gather(keep, -1, perm) \
        & (torch.arange(max_output, device=boxes.device) < n)
    indices = torch.where(valid, torch.gather(order, -1, perm),
                          torch.zeros_like(perm))
    return indices, valid


nms.launches = 0
nms.steps = 0


class Nms(Module):
    """Module wrapper (reference nn/Nms.scala:26): callable
    ``(scores, boxes) -> (indices, valid)``."""

    def __init__(self, iou_threshold: float = 0.5, max_output: int = 100):
        super().__init__()
        self.iou_threshold = float(iou_threshold)
        self.max_output = int(max_output)

    def forward(self, scores, boxes):
        return nms(boxes, scores, self.iou_threshold, self.max_output)


def _take(x, index):
    """``x[..., index, :]`` along dim -2 for ``index (..., m)``."""
    return torch.gather(x, -2, index[..., None].expand(
        *index.shape, x.shape[-1]))


# --------------------------------------------------------------------------
# Anchor generation (reference nn/Anchor.scala:26)
# --------------------------------------------------------------------------

class Anchor:
    """Faster R-CNN anchors: a base box of ``base_size`` enumerated over
    aspect ratios and scales (numpy rounding, as the reference), shifted
    over the feature grid; each grid's anchors cached on its device."""

    def __init__(self, ratios: Sequence[float], scales: Sequence[float]):
        self.ratios = np.asarray(ratios, np.float32)
        self.scales = np.asarray(scales, np.float32)
        self._cache = {}

    @property
    def anchor_num(self) -> int:
        return len(self.ratios) * len(self.scales)

    def base_anchors(self, base_size: float) -> np.ndarray:
        base = np.array([0, 0, base_size - 1, base_size - 1], np.float32)
        w = base[2] - base[0] + 1
        h = base[3] - base[1] + 1
        cx = base[0] + 0.5 * (w - 1)
        cy = base[1] + 0.5 * (h - 1)
        size = w * h
        out = []
        for r in self.ratios:
            ws = np.round(np.sqrt(size / r))
            hs = np.round(ws * r)
            for s in self.scales:
                wss, hss = ws * s, hs * s
                out.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
        return np.asarray(out, np.float32)

    def generate(self, feat_h: int, feat_w: int, stride: float,
                 device=None) -> torch.Tensor:
        """All anchors of a ``feat_h x feat_w`` grid: ``(H*W*A, 4)`` on
        ``device`` (default ``cuda``)."""
        dev = resolve_device(device)
        key = (feat_h, feat_w, float(stride), str(dev))
        if key not in self._cache:
            base = self.base_anchors(stride)
            shift_x = np.arange(feat_w, dtype=np.float32) * stride
            shift_y = np.arange(feat_h, dtype=np.float32) * stride
            sx, sy = np.meshgrid(shift_x, shift_y)
            shifts = np.stack([sx.ravel(), sy.ravel(),
                               sx.ravel(), sy.ravel()], axis=1)
            anchors = (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)
            self._cache[key] = torch.from_numpy(
                np.ascontiguousarray(anchors, np.float32)).to(dev)
        return self._cache[key]


# --------------------------------------------------------------------------
# RoiAlign / RoiPooling (reference nn/RoiAlign.scala:45, nn/RoiPooling.scala)
# --------------------------------------------------------------------------

def _roi_align(flat, base, h, w, scale, rois, pooled_h: int, pooled_w: int,
               sr: int, aligned: bool, mode: str):
    """RoiAlign of each ROI from its own map: ``flat (S, C)`` holds the
    maps' rows, ROI r's map starting at row ``base[r]`` with ``h[r] x
    w[r]`` positions and ``scale[r]`` (each a number or an ``(N,)``
    tensor).  The reference's arithmetic per ROI (RoiAlign.forward and
    _bilinear_gather): the ``inside`` mask on [-1, h] x [-1, w], the
    clip before ``floor``, ``y1 = min(y0 + 1, h - 1)``, the average (or
    max) over the sr x sr samples.  → ``(N, pooled_h, pooled_w, C)``."""
    dev = rois.device
    off = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * scale - off
    y1 = rois[:, 1] * scale - off
    x2 = rois[:, 2] * scale - off
    y2 = rois[:, 3] * scale - off
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    bin_h = roi_h / pooled_h
    bin_w = roi_w / pooled_w
    py = torch.arange(pooled_h, dtype=torch.float32, device=dev)
    px = torch.arange(pooled_w, dtype=torch.float32, device=dev)
    iy = (torch.arange(sr, dtype=torch.float32, device=dev) + 0.5) / sr
    ys = y1[:, None, None] + (py[None, :, None] + iy[None, None, :]) \
        * bin_h[:, None, None]                     # (N, ph, sr)
    xs = x1[:, None, None] + (px[None, :, None] + iy[None, None, :]) \
        * bin_w[:, None, None]                     # (N, pw, sr)
    ys_b = ys[:, :, :, None, None]                 # (N, ph, sr, 1, 1)
    xs_b = xs[:, None, None, :, :]                 # (N, 1, 1, pw, sr)

    def per_roi(v):
        return v[:, None, None, None, None] if torch.is_tensor(v) else v
    h_, w_, base_ = per_roi(h), per_roi(w), per_roi(base)
    inside = (ys_b >= -1.0) & (ys_b <= h_) & (xs_b >= -1.0) & (xs_b <= w_)
    y = _clip(ys_b, 0.0, h_ - 1)
    x = _clip(xs_b, 0.0, w_ - 1)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1i = _upto(y0 + 1, h_ - 1)
    x1i = _upto(x0 + 1, w_ - 1)
    ly = y - y0
    lx = x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    row0, row1 = base_ + y0 * w_, base_ + y1i * w_

    def at(rows, cols):
        return flat[rows + cols]                    # (N, ph, sr, pw, sr, C)

    def wgt(a, b):
        return (a * b)[..., None]
    out = (wgt(hy, hx) * at(row0, x0) + wgt(hy, lx) * at(row0, x1i)
           + wgt(ly, hx) * at(row1, x0) + wgt(ly, lx) * at(row1, x1i))
    vals = torch.where(inside[..., None], out, torch.zeros((), device=dev))
    if mode == "avg":
        return vals.mean(dim=(2, 4))
    return vals.amax(dim=(2, 4))


class RoiAlign(Module):
    """ROI-Align over an NHWC map (reference nn/RoiAlign.scala:45):
    ``forward((features (1, H, W, C), rois (N, 4)))`` → ``(N, pooled_h,
    pooled_w, C)``, rois corner boxes in image coordinates mapped by
    ``spatial_scale``.  ``sampling_ratio`` 0 takes 2, as the reference
    does."""

    def __init__(self, spatial_scale: float, sampling_ratio: int,
                 pooled_h: int, pooled_w: int, mode: str = "avg",
                 aligned: bool = True):
        super().__init__()
        if mode not in ("avg", "max"):
            raise ValueError(f"mode must be 'avg' or 'max', got {mode!r}")
        self.spatial_scale = float(spatial_scale)
        self.sampling_ratio = int(sampling_ratio) if sampling_ratio > 0 else 2
        self.pooled_h, self.pooled_w = int(pooled_h), int(pooled_w)
        self.mode = mode
        self.aligned = bool(aligned)

    def forward(self, inputs):
        feat, rois = inputs
        if feat.dim() == 4:
            feat = feat[0]
        h, w, c = feat.shape
        return _roi_align(feat.reshape(h * w, c), 0, h, w,
                          self.spatial_scale, rois, self.pooled_h,
                          self.pooled_w, self.sampling_ratio, self.aligned,
                          self.mode)


class RoiPooling(Module):
    """Max ROI-pooling (reference nn/RoiPooling.scala): rois ``(N, 5)``
    rows ``[batch_idx, x1, y1, x2, y2]``; a dense max over each bin's
    membership mask, rows first, as the reference's."""

    def __init__(self, pooled_w: int, pooled_h: int, spatial_scale: float):
        super().__init__()
        self.pooled_w, self.pooled_h = int(pooled_w), int(pooled_h)
        self.spatial_scale = float(spatial_scale)

    def forward(self, inputs):
        feat, rois = inputs  # feat (B, H, W, C)
        b, h, w, c = feat.shape
        dev = feat.device
        scale = self.spatial_scale
        x1 = torch.round(rois[:, 1] * scale)
        y1 = torch.round(rois[:, 2] * scale)
        x2 = torch.round(rois[:, 3] * scale)
        y2 = torch.round(rois[:, 4] * scale)
        roi_w = torch.clamp(x2 - x1 + 1, min=1.0)
        roi_h = torch.clamp(y2 - y1 + 1, min=1.0)
        bin_w = roi_w / self.pooled_w
        bin_h = roi_h / self.pooled_h
        ph = torch.arange(self.pooled_h, dtype=torch.float32, device=dev)
        pw = torch.arange(self.pooled_w, dtype=torch.float32, device=dev)
        hstart = torch.clamp(torch.floor(ph[None] * bin_h[:, None])
                             + y1[:, None], 0, h)
        hend = torch.clamp(torch.ceil((ph[None] + 1) * bin_h[:, None])
                           + y1[:, None], 0, h)
        wstart = torch.clamp(torch.floor(pw[None] * bin_w[:, None])
                             + x1[:, None], 0, w)
        wend = torch.clamp(torch.ceil((pw[None] + 1) * bin_w[:, None])
                           + x1[:, None], 0, w)
        ygrid = torch.arange(h, dtype=torch.float32, device=dev)
        xgrid = torch.arange(w, dtype=torch.float32, device=dev)
        ymask = ((ygrid[None, None] >= hstart[..., None])
                 & (ygrid[None, None] < hend[..., None]))
        xmask = ((xgrid[None, None] >= wstart[..., None])
                 & (xgrid[None, None] < wend[..., None]))
        per_roi = feat[rois[:, 0].long()]            # (N, H, W, C)
        neg = torch.tensor(torch.finfo(feat.dtype).min, device=dev)
        rows = torch.where(ymask[:, :, :, None, None], per_roi[:, None],
                           neg).amax(dim=2)          # (N, ph, W, C)
        out = torch.where(xmask[:, None, :, :, None], rows[:, :, None],
                          neg).amax(dim=3)           # (N, ph, pw, C)
        empty = ((hend <= hstart)[:, :, None, None]
                 | (wend <= wstart)[:, None, :, None])
        return torch.where(empty, torch.zeros((), device=dev), out)


# --------------------------------------------------------------------------
# FPN (reference nn/FPN.scala:41)
# --------------------------------------------------------------------------

def _nearest_upsample2(x, out_h: int, out_w: int):
    y = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return y[:, :out_h, :out_w, :]


class FPN(Module):
    """Feature Pyramid Network: ``forward([C_i]) -> [P_i] (+ extra)``.
    ``top_blocks=1`` appends P6 as P5 subsampled by 2 (Mask R-CNN);
    ``top_blocks=2`` appends conv P6/P7 from ``in_channels_p6p7``
    (RetinaNet)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 top_blocks: int = 0, in_channels_p6p7: int = 0,
                 out_channels_p6p7: int = 0, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.top_blocks = int(top_blocks)
        self.inner_blocks = nn.ModuleList(
            SpatialConvolution(c, out_channels, 1, 1, **kw)
            for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            SpatialConvolution(out_channels, out_channels, 3, 3, 1, 1, 1, 1,
                               **kw) for _ in in_channels)
        if top_blocks == 2:
            self.p6 = SpatialConvolution(
                in_channels_p6p7, out_channels_p6p7, 3, 3, 2, 2, 1, 1, **kw)
            self.p7 = SpatialConvolution(
                out_channels_p6p7, out_channels_p6p7, 3, 3, 2, 2, 1, 1,
                **kw)

    def forward(self, features) -> List[torch.Tensor]:
        laterals = [blk(f) for blk, f in zip(self.inner_blocks, features)]
        merged = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = _nearest_upsample2(merged[0], lat.shape[1], lat.shape[2])
            merged.insert(0, lat + up)
        outs = [blk(m) for blk, m in zip(self.layer_blocks, merged)]
        if self.top_blocks == 1:
            # a 1x1 max window at stride 2 (the reference's reduce_window)
            outs.append(outs[-1][:, ::2, ::2, :])
        elif self.top_blocks == 2:
            p6 = self.p6(features[-1])
            outs.append(p6)
            outs.append(self.p7(torch.relu(p6)))
        return outs


# --------------------------------------------------------------------------
# Pooler (reference nn/Pooler.scala:33): multi-level ROI pooling
# --------------------------------------------------------------------------

class Pooler(Module):
    """RoiAlign of each ROI from the FPN level of the canonical heuristic
    ``floor(4 + log2(sqrt(area) / 224 + 1e-6))``, clipped to the levels;
    a level with no pooler gives zeros, as the reference's select does.
    One gather serves every level (see the module docstring)."""

    def __init__(self, resolution: int, scales: Sequence[float],
                 sampling_ratio: int):
        super().__init__()
        self.resolution = int(resolution)
        self.scales = tuple(float(s) for s in scales)
        self.poolers = nn.ModuleList(
            RoiAlign(s, sampling_ratio, resolution, resolution)
            for s in self.scales)
        self.lvl_min = int(-math.log2(self.scales[0]))
        self.lvl_max = int(-math.log2(self.scales[-1]))

    def level_of(self, rois):
        area = torch.clamp(rois[:, 2] - rois[:, 0], min=0) \
            * torch.clamp(rois[:, 3] - rois[:, 1], min=0)
        lvl = torch.floor(4.0 + torch.log2(torch.sqrt(area) / 224.0 + 1e-6))
        return torch.clamp(lvl, self.lvl_min, self.lvl_max).int()

    def forward(self, inputs):
        features, rois = inputs
        level = self.level_of(rois) - self.lvl_min
        maps = [f[0] if f.dim() == 4 else f
                for f in features[:len(self.poolers)]]
        c = maps[0].shape[-1]
        flat = torch.cat([m.reshape(-1, c) for m in maps])
        # each ROI's map: its level's first row, height, width and scale
        zero = torch.zeros(rois.shape[0], device=rois.device)
        base, h, w, scale = (zero.long(), zero.long(), zero.long(), zero)
        start = 0
        for i, (m, pooler) in enumerate(zip(maps, self.poolers)):
            at = level == i
            base = torch.where(at, start, base)
            h = torch.where(at, m.shape[0], h)
            w = torch.where(at, m.shape[1], w)
            scale = torch.where(at, pooler.spatial_scale, scale)
            start += m.shape[0] * m.shape[1]
        p = self.poolers[0]
        out = _roi_align(flat, base, h, w, scale, rois, p.pooled_h,
                         p.pooled_w, p.sampling_ratio, p.aligned, p.mode)
        pooled = (level >= 0) & (level < len(maps))
        return torch.where(pooled[:, None, None, None], out,
                           torch.zeros((), device=out.device))


# --------------------------------------------------------------------------
# RPN (reference nn/RegionProposal.scala:40 + ProposalPostProcessor)
# --------------------------------------------------------------------------

class RegionProposal(Module):
    """Region Proposal Network over FPN levels:
    ``forward((features: [P_i], im_info (2,)))`` →
    ``(proposals (post_nms_topn, 4), scores (post_nms_topn,))``, padded
    slots at ``-inf``.  Every level's NMS runs in one batched call, the
    levels padded to the largest with ``-inf`` slots (never kept, and
    sorted after every real slot, so each level's result is its own)."""

    def __init__(self, in_channels: int, anchor_sizes: Sequence[float],
                 aspect_ratios: Sequence[float],
                 anchor_stride: Sequence[float],
                 pre_nms_topn_test: int = 1000,
                 post_nms_topn_test: int = 1000,
                 pre_nms_topn_train: int = 2000,
                 post_nms_topn_train: int = 2000,
                 nms_thresh: float = 0.7, min_size: int = 0, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if len(anchor_sizes) != len(anchor_stride):
            raise ValueError("anchor_sizes and anchor_stride differ in "
                             "length")
        self.anchor_sizes = tuple(float(s) for s in anchor_sizes)
        self.anchor_stride = tuple(float(s) for s in anchor_stride)
        self.anchors = [Anchor(aspect_ratios, [s / st])
                        for s, st in zip(self.anchor_sizes,
                                         self.anchor_stride)]
        a = self.anchors[0].anchor_num
        kw = dict(init_method=init_methods.RandomNormal(0, 0.01),
                  generator=generator, device=device)
        self.conv = SpatialConvolution(in_channels, in_channels, 3, 3, 1, 1,
                                       1, 1, **kw)
        self.cls_logits = SpatialConvolution(in_channels, a, 1, 1, **kw)
        self.bbox_pred = SpatialConvolution(in_channels, a * 4, 1, 1, **kw)
        self.pre_nms_topn_test = pre_nms_topn_test
        self.post_nms_topn_test = post_nms_topn_test
        self.pre_nms_topn_train = pre_nms_topn_train
        self.post_nms_topn_train = post_nms_topn_train
        self.nms_thresh = float(nms_thresh)
        self.min_size = float(min_size)

    def level_outputs(self, features):
        """The head's ``(logits (1, H, W, A), deltas (1, H, W, 4A))`` of
        each level."""
        out = []
        for feat in features[:len(self.anchors)]:
            t = torch.relu(self.conv(feat))
            out.append((self.cls_logits(t), self.bbox_pred(t)))
        return out

    def _level_candidates(self, logits, deltas, anchor: Anchor, stride,
                          im_info, pre):
        """One level's top ``pre`` decoded, clipped boxes and their
        logits (``-inf`` under ``min_size``)."""
        h, w = logits.shape[1], logits.shape[2]
        scores = logits.reshape(-1)
        deltas = deltas.reshape(-1, 4)
        anchors = anchor.generate(h, w, stride, device=logits.device)
        k = min(pre, scores.shape[0])
        top_scores, idx = _ranked(scores, k)
        boxes = bbox_transform_inv(anchors[idx], deltas[idx])
        boxes = clip_boxes(boxes, im_info[0], im_info[1])
        ws = boxes[:, 2] - boxes[:, 0] + 1
        hs = boxes[:, 3] - boxes[:, 1] + 1
        ok = (ws >= self.min_size) & (hs >= self.min_size)
        return boxes, torch.where(ok, top_scores, _NEG_INF)

    def propose(self, outputs, im_info):
        """The proposals from :meth:`level_outputs`: each level's top
        boxes, one NMS over the levels, the top ``post`` of them all."""
        pre = self.pre_nms_topn_train if self.training \
            else self.pre_nms_topn_test
        post = self.post_nms_topn_train if self.training \
            else self.post_nms_topn_test
        levels = [self._level_candidates(logits, deltas, anchor, stride,
                                         im_info, pre)
                  for (logits, deltas), anchor, stride in zip(
                      outputs, self.anchors, self.anchor_stride)]
        width = max(s.shape[0] for _, s in levels)
        boxes = torch.stack([F.pad(b, (0, 0, 0, width - b.shape[0]))
                             for b, _ in levels])
        scores = torch.stack([F.pad(s, (0, width - s.shape[0]),
                                    value=_NEG_INF) for _, s in levels])
        outs = [min(post, s.shape[0]) for _, s in levels]
        keep, valid = nms(boxes, scores, self.nms_thresh, max(outs))
        sel_boxes = torch.where(valid[..., None], _take(boxes, keep), 0.0)
        # sigmoid of the valid slots' logits; padding stays -inf
        sel_scores = torch.where(valid, torch.sigmoid(
            torch.gather(scores, -1, keep)), _NEG_INF)
        all_boxes = torch.cat([sel_boxes[i, :m] for i, m in enumerate(outs)])
        all_scores = torch.cat([sel_scores[i, :m]
                                for i, m in enumerate(outs)])
        k = min(post, all_scores.shape[0])
        top_scores, idx = _ranked(all_scores, k)
        return all_boxes[idx], top_scores

    def forward(self, inputs):
        features, im_info = inputs
        return self.propose(self.level_outputs(features), im_info)


class Proposal(Module):
    """Single-level proposal layer (reference nn/Proposal.scala, classic
    Faster R-CNN): ``(cls_prob (1, H, W, 2A), bbox_pred (1, H, W, 4A),
    im_info)`` → ``post_nms_topn`` rois ``(N, 5)`` with a leading batch
    index column, and their scores."""

    def __init__(self, pre_nms_topn: int, post_nms_topn: int,
                 ratios: Sequence[float], scales: Sequence[float],
                 rpn_pre_nms_topn_train: int = 12000,
                 rpn_post_nms_topn_train: int = 2000,
                 base_size: float = 16.0, nms_thresh: float = 0.7,
                 min_size: float = 16.0):
        super().__init__()
        self.anchor = Anchor(ratios, scales)
        self.pre_nms_topn = pre_nms_topn
        self.post_nms_topn = post_nms_topn
        self.pre_nms_topn_train = rpn_pre_nms_topn_train
        self.post_nms_topn_train = rpn_post_nms_topn_train
        self.base_size = base_size
        self.nms_thresh = nms_thresh
        self.min_size = min_size

    def forward(self, inputs):
        cls_prob, bbox_pred, im_info = inputs
        h, w = cls_prob.shape[1], cls_prob.shape[2]
        a = self.anchor.anchor_num
        # foreground scores: the second half of the 2A channels
        scores = cls_prob[0, :, :, a:].reshape(-1)
        deltas = bbox_pred[0].reshape(-1, 4)
        anchors = self.anchor.generate(h, w, self.base_size,
                                       device=cls_prob.device)
        pre = self.pre_nms_topn_train if self.training else self.pre_nms_topn
        post = (self.post_nms_topn_train if self.training
                else self.post_nms_topn)
        k = min(pre, scores.shape[0])
        top_scores, idx = _ranked(scores, k)
        boxes = bbox_transform_inv(anchors[idx], deltas[idx])
        boxes = clip_boxes(boxes, im_info[0], im_info[1])
        ws = boxes[:, 2] - boxes[:, 0] + 1
        hs = boxes[:, 3] - boxes[:, 1] + 1
        min_sz = self.min_size * im_info[2]
        top_scores = torch.where((ws >= min_sz) & (hs >= min_sz),
                                 top_scores, _NEG_INF)
        keep, valid = nms(boxes, top_scores, self.nms_thresh, min(post, k))
        out_boxes = torch.where(valid[:, None], boxes[keep], 0.0)
        rois = torch.cat([torch.zeros_like(out_boxes[:, :1]), out_boxes], 1)
        return rois, torch.where(valid, top_scores[keep], _NEG_INF)


# --------------------------------------------------------------------------
# BoxHead / MaskHead (reference nn/BoxHead.scala:30, nn/MaskHead.scala:24)
# --------------------------------------------------------------------------

def _per_class_top(boxes, scores, nms_thresh: float, per_cls: int,
                   out: int, pre_topk=None):
    """The per-class NMS and the final ranking that DetectionOutputSSD,
    DetectionOutputFrcnn and BoxHead share: ``boxes (..., C', n, 4)`` and
    ``scores (..., C', n)`` of the foreground classes (labels 1..C' after
    the one left out), one batched :func:`nms`, the kept slots of every
    class in class order, then the top ``out`` → (boxes, labels (int64),
    scores, valid), ``(..., out)`` each, empty slots zero."""
    keep, valid = nms(boxes, scores, nms_thresh, per_cls, pre_topk)
    cand_boxes = torch.where(valid[..., None], _take(boxes, keep), 0.0)
    cand_scores = torch.where(valid, torch.gather(scores, -1, keep),
                              _NEG_INF)
    lead = cand_scores.shape[:-2]
    cand_boxes = cand_boxes.reshape(*lead, -1, 4)
    cand_scores = cand_scores.reshape(*lead, -1)
    k = min(out, cand_scores.shape[-1])
    top, idx = _ranked(cand_scores, k)
    valid = top > _NEG_INF
    return (torch.where(valid[..., None], _take(cand_boxes, idx), 0.0),
            torch.where(valid, idx // keep.shape[-1], 0), top, valid)


class BoxHead(Module):
    """Second-stage box head: Pooler → two-layer MLP → class and box
    predictors → per-class NMS (one batched call over the classes).
    ``forward((features, proposals, im_info[, proposal_valid]))`` →
    ``(boxes (max_per_image, 4), labels, scores, valid)``."""

    def __init__(self, in_channels: int, resolution: int,
                 scales: Sequence[float], sampling_ratio: int,
                 score_thresh: float, nms_thresh: float,
                 max_per_image: int, output_size: int, num_classes: int, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.num_classes = num_classes
        self.score_thresh = float(score_thresh)
        self.nms_thresh = float(nms_thresh)
        self.max_per_image = int(max_per_image)
        self.pooler = Pooler(resolution, scales, sampling_ratio)
        flat = in_channels * resolution * resolution
        self.fc1 = Linear(flat, output_size, **kw)
        self.fc2 = Linear(output_size, output_size, **kw)
        self.cls_score = Linear(
            output_size, num_classes,
            init_method=init_methods.RandomNormal(0, 0.01), **kw)
        self.bbox_pred = Linear(
            output_size, num_classes * 4,
            init_method=init_methods.RandomNormal(0, 0.001), **kw)
        self.box_weights = (10.0, 10.0, 5.0, 5.0)

    def features_of(self, features, proposals):
        return self.mlp(self.pooler((features, proposals)))

    def mlp(self, pooled):
        x = pooled.reshape(pooled.shape[0], -1)
        return torch.relu(self.fc2(torch.relu(self.fc1(x))))

    def predict(self, pooled):
        """(class logits (N, C), box deltas (N, 4C)) of ``pooled (N, r,
        r, C)``, the head's output after its Pooler."""
        feats = self.mlp(pooled)
        return self.cls_score(feats), self.bbox_pred(feats)

    def select(self, logits, deltas, proposals, im_info, prop_valid=None):
        """The detections from :meth:`predict`'s output: per-class decode
        and NMS, then the top ``max_per_image``."""
        probs = torch.softmax(logits, dim=-1)
        n = proposals.shape[0]
        deltas = deltas.reshape(n, self.num_classes, 4)
        # every foreground class at once: (C - 1, n, 4) and (C - 1, n)
        dec = clip_boxes(bbox_transform_inv(
            proposals[None], deltas[:, 1:].transpose(0, 1),
            self.box_weights), im_info[0], im_info[1])
        fg = probs[:, 1:].t()
        sc = torch.where(fg > self.score_thresh, fg, _NEG_INF)
        if prop_valid is not None:
            sc = torch.where(prop_valid, sc, _NEG_INF)
        per_cls = min(max(1, self.max_per_image), n)
        boxes, cls, scores, valid = _per_class_top(
            dec, sc, self.nms_thresh, per_cls, self.max_per_image)
        labels = torch.where(valid, cls + 1, 0).int()
        return boxes, labels, torch.where(valid, scores, 0.0), valid

    def forward(self, inputs):
        # an optional 4th element: the proposals' validity.  Without it,
        # RegionProposal's padded zero boxes would be classified too.
        features, proposals, im_info = inputs[:3]
        prop_valid = inputs[3] if len(inputs) == 4 else None
        return self.select(*self.predict(self.pooler((features, proposals))),
                           proposals, im_info, prop_valid)


class MaskHead(Module):
    """Mask branch: Pooler → conv tower (dilated where ``dilation`` > 1)
    → a 2x2 stride-2 transposed conv → per-class mask logits.
    ``forward((features, boxes, labels))`` → ``(masks (N, 2r, 2r): the
    sigmoid of each box's class, logits (N, C, 2r, 2r))``."""

    def __init__(self, in_channels: int, resolution: int,
                 scales: Sequence[float], sampling_ratio: int,
                 layers: Sequence[int], dilation: int, num_classes: int,
                 use_gn: bool = False, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.pooler = Pooler(resolution, scales, sampling_ratio)
        convs, norms = [], []
        nin = in_channels
        for nout in layers:
            if dilation == 1:
                convs.append(SpatialConvolution(
                    nin, nout, 3, 3, 1, 1, 1, 1,
                    init_method=init_methods.MsraFiller(False), **kw))
            else:
                convs.append(SpatialDilatedConvolution(
                    nin, nout, 3, 3, 1, 1, dilation, dilation,
                    dilation, dilation, **kw))
            if use_gn:
                norms.append(GroupNorm(nout, device=device))
            nin = nout
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.use_gn = bool(use_gn)
        self.dilation = int(dilation)
        self.deconv = SpatialFullConvolution(nin, nin, 2, 2, 2, 2, **kw)
        self.predictor = SpatialConvolution(
            nin, num_classes, 1, 1,
            init_method=init_methods.MsraFiller(False), **kw)
        self.num_classes = num_classes

    def masks_of(self, pooled, labels):
        """The head after its Pooler: ``pooled (N, r, r, C)``."""
        x = pooled
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.use_gn:
                x = self.norms[i](x)
            x = torch.relu(x)
        x = torch.relu(self.deconv(x))
        logits = self.predictor(x)                 # (N, 2r, 2r, C)
        n = logits.shape[0]
        sel = logits[torch.arange(n, device=logits.device), :, :,
                     labels.long()]
        return torch.sigmoid(sel), logits.permute(0, 3, 1, 2)

    def forward(self, inputs):
        features, boxes, labels = inputs
        return self.masks_of(self.pooler((features, boxes)), labels)


# --------------------------------------------------------------------------
# SSD: PriorBox + DetectionOutputSSD (reference nn/PriorBox.scala:42,
# nn/DetectionOutputSSD.scala:49)
# --------------------------------------------------------------------------

def _prior(cx, cy, bw, bh, img_w, img_h):
    return [(cx - bw / 2.0) / img_w, (cy - bh / 2.0) / img_h,
            (cx + bw / 2.0) / img_w, (cy + bh / 2.0) / img_h]


class PriorBox(Module):
    """Caffe-SSD prior (default box) generator for one feature map:
    ``forward(feature (B, H, W, C))`` → ``(2, H*W*num_priors*4)``, row 0
    the normalised corner boxes, row 1 the variances.  The boxes are the
    reference's numpy arithmetic (Python floats, then float32), built
    once per map shape and device and kept there."""

    def __init__(self, min_sizes: Sequence[float],
                 max_sizes: Optional[Sequence[float]] = None,
                 aspect_ratios: Optional[Sequence[float]] = None,
                 is_flip: bool = True, is_clip: bool = False,
                 variances: Optional[Sequence[float]] = None,
                 offset: float = 0.5, img_h: int = 0, img_w: int = 0,
                 img_size: int = 0, step_h: float = 0.0,
                 step_w: float = 0.0, step: float = 0.0):
        super().__init__()
        self.min_sizes = [float(s) for s in min_sizes]
        self.max_sizes = [float(s) for s in (max_sizes or [])]
        ars = [1.0]
        for ar in (aspect_ratios or []):
            if not any(abs(ar - a) < 1e-6 for a in ars):
                ars.append(float(ar))
                if is_flip:
                    ars.append(1.0 / float(ar))
        self.aspect_ratios = ars
        self.is_clip = is_clip
        self.variances = list(variances or [0.1])
        self.offset = float(offset)
        self.img_h = img_h or img_size
        self.img_w = img_w or img_size
        self.step_h = step_h or step
        self.step_w = step_w or step
        if self.max_sizes and len(self.max_sizes) != len(self.min_sizes):
            raise ValueError("max_sizes and min_sizes differ in length")
        self.num_priors = (len(ars) * len(self.min_sizes)
                           + len(self.max_sizes))
        self._cache = {}

    def priors(self, layer_h: int, layer_w: int) -> np.ndarray:
        """The (2, H*W*num_priors*4) float32 array, on the host."""
        img_h, img_w = self.img_h, self.img_w
        step_h = self.step_h or img_h / layer_h
        step_w = self.step_w or img_w / layer_w
        boxes = []
        for hi in range(layer_h):
            for wi in range(layer_w):
                cx = (wi + self.offset) * step_w
                cy = (hi + self.offset) * step_h
                for i, mn in enumerate(self.min_sizes):
                    boxes.append(_prior(cx, cy, mn, mn, img_w, img_h))
                    if self.max_sizes:
                        sz = math.sqrt(mn * self.max_sizes[i])
                        boxes.append(_prior(cx, cy, sz, sz, img_w, img_h))
                    for ar in self.aspect_ratios:
                        if abs(ar - 1.0) < 1e-6:
                            continue
                        bw = mn * math.sqrt(ar)
                        bh = mn / math.sqrt(ar)
                        boxes.append(_prior(cx, cy, bw, bh, img_w, img_h))
        out = np.asarray(boxes, np.float32).reshape(-1)
        if self.is_clip:
            out = np.clip(out, 0.0, 1.0)
        if len(self.variances) == 1:
            var = np.full_like(out, self.variances[0])
        else:
            var = np.tile(np.asarray(self.variances, np.float32),
                          out.size // 4)
        return np.stack([out, var])

    def forward(self, feature):
        layer_h, layer_w = int(feature.shape[1]), int(feature.shape[2])
        key = (layer_h, layer_w, str(feature.device))
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(
                self.priors(layer_h, layer_w)).to(feature.device)
        return self._cache[key]


def _decode_ssd(priors, variances, loc, variance_encoded: bool):
    """Decode SSD loc predictions ``loc (..., P, 4)`` against corner
    priors ``(P, 4)``."""
    pw = priors[:, 2] - priors[:, 0]
    ph = priors[:, 3] - priors[:, 1]
    pcx = (priors[:, 0] + priors[:, 2]) / 2
    pcy = (priors[:, 1] + priors[:, 3]) / 2
    v = torch.ones_like(priors) if variance_encoded else variances
    cx = v[:, 0] * loc[..., 0] * pw + pcx
    cy = v[:, 1] * loc[..., 1] * ph + pcy
    w = torch.exp(v[:, 2] * loc[..., 2]) * pw
    h = torch.exp(v[:, 3] * loc[..., 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


class DetectionOutputSSD(Module):
    """SSD post-processing (reference nn/DetectionOutputSSD.scala:49):
    ``forward((loc (B, nPriors*4), conf (B, nPriors*nClasses), priors (2,
    nPriors*4)))`` → ``(B, keep_top_k, 6)`` rows ``[label, score, x1, y1,
    x2, y2]``, empty slots all zero.  :meth:`decode` and :meth:`select`
    are its two stages; one NMS call serves every image and class."""

    def __init__(self, n_classes: int = 21, share_location: bool = True,
                 bg_label: int = 0, nms_thresh: float = 0.45,
                 nms_topk: int = 400, keep_top_k: int = 200,
                 conf_thresh: float = 0.01,
                 variance_encoded_in_target: bool = False,
                 conf_post_process: bool = True):
        super().__init__()
        if not share_location:
            raise ValueError("only shared-location SSD is supported")
        self.n_classes = n_classes
        self.bg_label = bg_label
        self.nms_thresh = float(nms_thresh)
        self.nms_topk = int(nms_topk)
        self.keep_top_k = int(keep_top_k)
        self.conf_thresh = float(conf_thresh)
        self.variance_encoded = variance_encoded_in_target

    def decode(self, loc, prior):
        """``(B, P, 4)`` corner boxes from ``loc (B, P*4)``."""
        priors = prior[0].reshape(-1, 4)
        variances = prior[1].reshape(-1, 4)
        return _decode_ssd(priors, variances,
                           loc.reshape(loc.shape[0], -1, 4),
                           self.variance_encoded)

    def select(self, boxes, conf):
        """The rows from decoded ``boxes (B, P, 4)`` and ``conf (B,
        P*C)``: per-class NMS over the top ``nms_topk`` boxes, then the
        top ``keep_top_k`` over the classes."""
        b, n_priors = boxes.shape[0], boxes.shape[1]
        conf = conf.reshape(b, n_priors, self.n_classes)
        bg = self.bg_label
        has_bg = 0 <= bg < self.n_classes
        fg = torch.cat([conf[..., :bg], conf[..., bg + 1:]], -1) \
            if has_bg else conf
        fg = fg.transpose(1, 2)                               # (B, C', P)
        sc = torch.where(fg > self.conf_thresh, fg, _NEG_INF)
        per_cls = min(self.nms_topk, n_priors)
        bxs, cls, top, valid = _per_class_top(
            boxes[:, None].expand(b, fg.shape[1], n_priors, 4), sc,
            self.nms_thresh, per_cls, self.keep_top_k,
            pre_topk=self.nms_topk)
        # the class of the c-th foreground column
        labels = cls + (cls >= bg).long() if has_bg else cls
        row = torch.cat([
            torch.where(valid, labels, 0).float()[..., None],
            torch.where(valid, top, 0.0)[..., None], bxs], dim=-1)
        if row.shape[1] < self.keep_top_k:
            row = F.pad(row, (0, 0, 0, self.keep_top_k - row.shape[1]))
        return row

    def forward(self, inputs):
        loc, conf, prior = inputs
        if loc.dim() == 1:
            loc, conf = loc[None], conf[None]
        return self.select(self.decode(loc, prior), conf)


class DetectionOutputFrcnn(Module):
    """Faster R-CNN post-processing (reference
    nn/DetectionOutputFrcnn.scala): per-class decode and NMS over the ROI
    head's outputs.  ``forward((im_info, cls_prob (N, C), bbox_pred (N,
    4C), rois (N, 5)))`` → ``(max_per_image, 6)`` rows [label, score,
    box]."""

    def __init__(self, n_classes: int = 21, nms_thresh: float = 0.3,
                 max_per_image: int = 100, thresh: float = 0.05):
        super().__init__()
        self.n_classes = n_classes
        self.nms_thresh = float(nms_thresh)
        self.max_per_image = int(max_per_image)
        self.thresh = float(thresh)

    def forward(self, inputs):
        im_info, cls_prob, bbox_pred, rois = inputs
        n = rois.shape[0]
        deltas = bbox_pred.reshape(n, self.n_classes, 4)
        dec = clip_boxes(bbox_transform_inv(
            rois[None, :, 1:5], deltas[:, 1:].transpose(0, 1)),
            im_info[0], im_info[1])
        fg = cls_prob[:, 1:].t()
        sc = torch.where(fg > self.thresh, fg, _NEG_INF)
        bxs, cls, top, valid = _per_class_top(
            dec, sc, self.nms_thresh, min(self.max_per_image, n),
            self.max_per_image)
        return torch.cat([
            torch.where(valid, cls + 1, 0).float()[:, None],
            torch.where(valid, top, 0.0)[:, None], bxs], dim=1)


# --------------------------------------------------------------------------
# Detection criteria (reference nn/SmoothL1CriterionWithWeights.scala,
# nn/SoftmaxWithCriterion.scala)
# --------------------------------------------------------------------------

class SmoothL1CriterionWithWeights(Module):
    """Smooth-L1 with per-element inside and outside weights, divided by
    ``num`` when it is positive: ``target`` is the target or a (target,
    inside weights, outside weights) tuple."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__()
        self.sigma2 = float(sigma) ** 2
        self.num = num

    def forward(self, input, target):
        if isinstance(target, (tuple, list)):
            tgt, in_w, out_w = target[0], target[1], target[2]
        else:
            tgt, in_w, out_w = target, 1.0, 1.0
        d = in_w * (input - tgt)
        ad = torch.abs(d)
        loss = torch.where(ad < 1.0 / self.sigma2,
                           0.5 * self.sigma2 * d * d, ad - 0.5 / self.sigma2)
        loss = torch.sum(out_w * loss)
        return loss / self.num if self.num > 0 else loss


class SoftmaxWithCriterion(Module):
    """Softmax + NLL over (B, C) or spatial (B, C, H, W) inputs, 1-based
    targets, an optional ignored label; ``normalize_mode`` VALID (the
    count not ignored), FULL, BATCH_SIZE or anything else (the sum)."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID"):
        super().__init__()
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def forward(self, input, target):
        logp = torch.log_softmax(input, dim=1)
        tgt = target.long() - 1
        if self.ignore_label is not None:
            mask = target != self.ignore_label
            # an ignored label may lie outside the classes
            tgt = torch.where(mask, tgt, 0)
        picked = torch.gather(logp, 1, tgt[:, None])[:, 0]
        if self.ignore_label is not None:
            picked = torch.where(mask, picked, 0.0)
            count = torch.clamp(mask.sum(), min=1)
        else:
            count = picked.numel()
        if self.normalize_mode == "VALID":
            return -picked.sum() / count
        if self.normalize_mode == "FULL":
            return -picked.sum() / picked.numel()
        if self.normalize_mode == "BATCH_SIZE":
            return -picked.sum() / input.shape[0]
        return -picked.sum()
