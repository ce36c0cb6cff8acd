"""Validation methods (counterpart of ``ValidationResult``,
``AccuracyResult``, ``LossResult``, ``ValidationMethod``,
``TopKAccuracy``, ``Top1Accuracy``, ``Top5Accuracy``, ``Loss`` and
``MAE`` in ``bigdl_tpu/optim/validation.py``).

``batch_stats(output, target)`` runs on the output's device and returns
(numerator, denominator) as tensors; ``to_result`` reads them back into a
mergeable ``ValidationResult``.  Class targets are 1-based.  The ranking
and detection methods are not ported yet (ROADMAP.md queue 1, item 9b).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "ValidationResult", "AccuracyResult", "LossResult",
    "ValidationMethod", "Top1Accuracy", "Top5Accuracy", "TopKAccuracy",
    "Loss", "MAE",
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
