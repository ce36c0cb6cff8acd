"""Validation methods (counterpart of ``bigdl_tpu/optim/validation.py``
but ``aggregate_across_processes``, a merge across processes that waits
for ROADMAP.md queue 1, item 11).

``batch_stats(output, target)`` runs on the output's device and returns
(numerator, denominator) as tensors; ``to_result`` reads them back into a
mergeable ``ValidationResult``.  Class targets are 1-based.  The ranking
metrics (``MeanAveragePrecision``, ``PrecisionRecallAUC``) return the
batch's scores and targets and accumulate them on the host, computing the
metric at ``result()``; ``MeanAveragePrecisionObjectDetection`` is host
arithmetic over decoded detections (``evaluate``) and, as the
reference's, refuses ``batch_stats``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ValidationResult", "AccuracyResult", "LossResult",
    "ValidationMethod", "Top1Accuracy", "Top5Accuracy", "TopKAccuracy",
    "Loss", "MAE", "HitRatio", "NDCG", "MeanAveragePrecision",
    "MeanAveragePrecisionObjectDetection", "PrecisionRecallAUC",
    "TreeNNAccuracy", "MAPResult", "AUCResult",
]


class ValidationResult:
    """Mergeable metric accumulator: ``a + b`` sums, ``result()`` gives
    (numerator / denominator, count)."""

    def __init__(self, numerator: float, denominator: float, fmt: str):
        self.numerator = float(numerator)
        self.denominator = float(denominator)
        self.fmt = fmt

    def result(self) -> Tuple[float, int]:
        value = self.numerator / max(self.denominator, 1e-12)
        return value, int(self.denominator)

    def __add__(self, other: "ValidationResult") -> "ValidationResult":
        return ValidationResult(self.numerator + other.numerator,
                                self.denominator + other.denominator,
                                self.fmt)

    def __repr__(self):
        v, n = self.result()
        return f"{self.fmt}: {v:.6f} (count {n})"


class AccuracyResult(ValidationResult):
    def __init__(self, correct, count):
        super().__init__(correct, count, "Accuracy")


class LossResult(ValidationResult):
    def __init__(self, loss, count):
        super().__init__(loss, count, "Loss")


class ValidationMethod:
    """``batch_stats(output, target)`` -> (num, den) tensors;
    ``to_result`` wraps them."""

    fmt = "Metric"

    def batch_stats(self, output, target):
        raise NotImplementedError

    def to_result(self, num, den) -> ValidationResult:
        return ValidationResult(float(num), float(den), self.fmt)

    def __call__(self, output, target) -> ValidationResult:
        num, den = self.batch_stats(output, target)
        return self.to_result(num, den)

    def __repr__(self):
        return self.fmt


class TopKAccuracy(ValidationMethod):
    """Top-k classification accuracy over 1-based integer targets."""

    def __init__(self, k: int = 1):
        self.k = k
        self.fmt = f"Top{k}Accuracy"

    def batch_stats(self, output, target):
        t = torch.as_tensor(target, device=output.device).long() \
            .reshape(-1) - 1
        out = output.reshape(-1, output.shape[-1])
        if self.k == 1:
            correct = (out.argmax(-1) == t).float().sum()
        else:
            topk = out.topk(self.k, dim=-1).indices
            correct = (topk == t[:, None]).any(-1).float().sum()
        return correct, torch.tensor(float(t.shape[0]))


class Top1Accuracy(TopKAccuracy):
    def __init__(self):
        super().__init__(1)


class Top5Accuracy(TopKAccuracy):
    def __init__(self):
        super().__init__(5)


class Loss(ValidationMethod):
    """Mean criterion loss over samples (CrossEntropy by default)."""

    fmt = "Loss"

    def __init__(self, criterion=None):
        if criterion is None:
            from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
            criterion = CrossEntropyCriterion()
        self.criterion = criterion

    def batch_stats(self, output, target):
        n = output.shape[0]
        return self.criterion(output, target) * n, torch.tensor(float(n))


class MAE(ValidationMethod):
    """Mean absolute error per sample, averaged over samples."""

    fmt = "MAE"

    def batch_stats(self, output, target):
        target = torch.as_tensor(target, device=output.device)
        err = torch.abs(output - target).mean(
            dim=tuple(range(1, output.dim())))
        return err.sum(), torch.tensor(float(output.shape[0]))


def _rank_of_first(output):
    """The 1-based rank of column 0 among each row's scores (the ones
    strictly above it, plus one)."""
    return (output > output[..., :1]).int().sum(-1) + 1


class HitRatio(ValidationMethod):
    """HR@k for recommendation (the NCF protocol): ``output [batch, 1 +
    neg]`` scores, the positive item in column 0."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.fmt = f"HitRatio@{k}"

    def batch_stats(self, output, target=None):
        hits = (_rank_of_first(output) <= self.k).float().sum()
        return hits, torch.tensor(float(output.shape[0]))


class NDCG(ValidationMethod):
    """NDCG@k under HitRatio's protocol: log(2) / log(rank + 1) within
    the top k."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.fmt = f"NDCG@{k}"

    def batch_stats(self, output, target=None):
        rank = _rank_of_first(output)
        gain = torch.where(rank <= self.k, math.log(2.0)
                           / torch.log(rank + 1.0), 0.0)
        return gain.sum(), torch.tensor(float(output.shape[0]))


class TreeNNAccuracy(ValidationMethod):
    """Accuracy at the root node of TreeLSTM-style (B, nodes, C) outputs;
    ``root_index`` -1 (children-first encodings) by default."""

    def __init__(self, root_index: int = -1):
        self.root_index = root_index
        self.fmt = "TreeNNAccuracy()"

    def batch_stats(self, output, target):
        if isinstance(output, (tuple, list)):
            output = output[0]
        target = torch.as_tensor(target, device=output.device)
        if output.dim() == 3:
            output = output[:, self.root_index]
        pred = output.argmax(-1) + 1
        tgt = target[:, self.root_index] if target.dim() == 2 else target
        correct = (pred == tgt.to(pred.dtype)).float().sum()
        return correct, torch.tensor(float(output.shape[0]))

    def to_result(self, num, den):
        return AccuracyResult(float(num), float(den))


# --------------------------------------------------------------------------
# Ranking metrics: the batches' scores accumulate on the host and the
# metric is computed at result()
# --------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class _ArrayResult(ValidationResult):
    """A mergeable result holding host arrays (``+`` concatenates); the
    subclass computes the metric in ``result()``."""

    def __init__(self, fmt: str, *arrays):
        self.fmt = fmt
        self.arrays = [_host(a) for a in arrays]

    def __add__(self, other):
        merged = [np.concatenate([a, b], axis=0)
                  for a, b in zip(self.arrays, other.arrays)]
        return type(self)(self.fmt, *merged)

    def result(self):
        raise NotImplementedError

    def __repr__(self):
        v, n = self.result()
        return f"{self.fmt}: {v:.6f} (on {n} samples)"


def _average_precision(scores, is_pos, n_pos, k=None):
    """AP of one class from ranked ``scores`` and the positive mask."""
    if n_pos == 0:
        return 0.0
    order = np.argsort(-scores)
    pos = is_pos[order]
    if k is not None:
        pos = pos[:k]
    tp = np.cumsum(pos)
    precision = tp / (np.arange(len(pos)) + 1)
    return float(np.sum(precision * pos) / n_pos)


class MAPResult(_ArrayResult):
    def __init__(self, fmt, scores, targets, k=None, classes=0):
        super().__init__(fmt, scores, targets)
        self.k = k
        self.classes = classes

    def __add__(self, other):
        merged = [np.concatenate([a, b], axis=0)
                  for a, b in zip(self.arrays, other.arrays)]
        return MAPResult(self.fmt, *merged, k=self.k, classes=self.classes)

    def result(self):
        scores, targets = self.arrays
        n = scores.shape[0]
        # classes bounds the averaged columns; 0 means all
        n_classes = min(self.classes or scores.shape[1], scores.shape[1])
        aps = []
        for c in range(n_classes):
            is_pos = targets == c + 1  # 1-based labels
            aps.append(_average_precision(scores[:, c], is_pos,
                                          int(is_pos.sum()), self.k))
        return float(np.mean(aps)), n


class MeanAveragePrecision(ValidationMethod):
    """Classification mean average precision over classes (the
    reference's MAPValidationResult)."""

    def __init__(self, k: Optional[int] = None, classes: int = 0):
        self.k = k
        self.classes = classes
        self.fmt = "MAP@" + (str(k) if k else "all")

    def batch_stats(self, output, target):
        if output.dim() == 1:
            output = output[None]
        return output, torch.as_tensor(target).reshape(-1)

    def to_result(self, scores, targets):
        return MAPResult(self.fmt, scores, targets, k=self.k,
                         classes=self.classes)


_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class AUCResult(_ArrayResult):
    def result(self):
        scores, labels = self.arrays
        order = np.argsort(-scores)
        lab = labels[order] > 0.5
        n_pos = int(lab.sum())
        n_neg = len(lab) - n_pos
        if n_pos == 0 or n_neg == 0:
            return 0.0, len(lab)
        tp = np.cumsum(lab)
        fp = np.cumsum(~lab)
        precision = tp / np.maximum(tp + fp, 1)
        recall = tp / n_pos
        # the trapezoid over recall, anchored at recall 0 with the first
        # observed precision
        recall = np.concatenate([[0.0], recall])
        precision = np.concatenate([[precision[0]], precision])
        return float(_trapezoid(precision, recall)), len(lab)


class PrecisionRecallAUC(ValidationMethod):
    """Area under the precision-recall curve of binary scores."""

    fmt = "PrecisionRecallAUC"

    def batch_stats(self, output, target):
        return output.reshape(-1), torch.as_tensor(target).reshape(-1)

    def to_result(self, scores, labels):
        return AUCResult(self.fmt, scores, labels)


# --------------------------------------------------------------------------
# Object-detection mAP (VOC07 11-point, VOC area, COCO over IoU
# 0.5:0.05:0.95), host arithmetic over decoded detections
# --------------------------------------------------------------------------

def _det_iou(box, boxes):
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = a + b - inter
    return np.where(union > 0, inter / union, 0.0)


def _voc_ap(recall, precision, use_07_metric=False):
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class MeanAveragePrecisionObjectDetection(ValidationMethod):
    """Detection mAP; ``style`` "VOC07" (11-point), "VOC" (area) or
    "COCO" (the mean over IoU 0.5:0.05:0.95).
    ``evaluate(detections, ground_truths)``: per image
    ``detections[i] = (labels (N,), scores (N,), boxes (N, 4))`` and
    ``ground_truths[i] = (labels (M,), boxes (M, 4))``, the empty rows
    already stripped."""

    def __init__(self, classes: int, iou_thresh: float = 0.5,
                 style: str = "VOC"):
        self.classes = classes
        self.iou_thresh = iou_thresh
        self.style = style
        self.fmt = f"mAP[{style}]"

    def batch_stats(self, output, target):
        raise TypeError(
            "MeanAveragePrecisionObjectDetection is a host-side metric "
            "over decoded detections — call .evaluate(detections, "
            "ground_truths) instead of running it through Evaluator")

    def _ap_at(self, dets, gts, iou_thresh):
        aps = []
        for c in range(1, self.classes + 1):
            records = []  # (score, image index, box)
            n_gt = 0
            gt_per_img = []
            for glab, gbox in gts:
                sel = _host(glab) == c
                gt_per_img.append(_host(gbox)[sel])
                n_gt += int(sel.sum())
            for i, (dlab, dsc, dbox) in enumerate(dets):
                sel = _host(dlab) == c
                for s, b in zip(_host(dsc)[sel], _host(dbox)[sel]):
                    records.append((float(s), i, b))
            if n_gt == 0:
                continue
            records.sort(key=lambda r: -r[0])
            matched = [np.zeros(len(g), bool) for g in gt_per_img]
            tp = np.zeros(len(records))
            fp = np.zeros(len(records))
            for k, (s, i, b) in enumerate(records):
                g = gt_per_img[i]
                if len(g) == 0:
                    fp[k] = 1
                    continue
                ious = _det_iou(b, g)
                j = int(np.argmax(ious))
                if ious[j] >= iou_thresh and not matched[i][j]:
                    tp[k] = 1
                    matched[i][j] = True
                else:
                    fp[k] = 1
            ctp, cfp = np.cumsum(tp), np.cumsum(fp)
            recall = ctp / n_gt
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            aps.append(_voc_ap(recall, precision, self.style == "VOC07"))
        return float(np.mean(aps)) if aps else 0.0

    def evaluate(self, detections, ground_truths) -> float:
        if self.style == "COCO":
            return float(np.mean([
                self._ap_at(detections, ground_truths, t)
                for t in np.arange(0.5, 1.0, 0.05)]))
        return self._ap_at(detections, ground_truths, self.iou_thresh)
