"""Loss criteria (counterpart of ``bigdl_tpu/nn/criterion.py``, every
export).

``forward(input, target)`` returns a scalar tensor; autograd gives the
gradient, and ``backward(input, target)`` the input's through
``torch.autograd.grad`` (the reference's ``updateGradInput``).  Class
targets are 1-based, the reference's Torch convention.  Every formula is
the reference's, not ``torch.nn.functional``'s: several mean over
elements where torch means over rows, or divide by the element count.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Criterion", "ClassNLLCriterion", "CrossEntropyCriterion",
    "CategoricalCrossEntropy", "BCECriterion", "MSECriterion",
    "AbsCriterion", "SmoothL1Criterion", "DistKLDivCriterion",
    "KLDCriterion", "GaussianCriterion", "CosineEmbeddingCriterion",
    "HingeEmbeddingCriterion", "MarginCriterion", "MarginRankingCriterion",
    "MultiCriterion", "ParallelCriterion", "MultiLabelMarginCriterion",
    "MultiLabelSoftMarginCriterion", "MultiMarginCriterion",
    "SoftMarginCriterion", "L1HingeEmbeddingCriterion",
    "CosineDistanceCriterion", "CosineProximityCriterion",
    "DotProductCriterion", "PoissonCriterion", "MeanAbsolutePercentageCriterion",
    "MeanSquaredLogarithmicCriterion", "KullbackLeiblerDivergenceCriterion",
    "ClassSimplexCriterion", "L1Cost", "DiceCoefficientCriterion",
    "PGCriterion", "TimeDistributedCriterion", "TransformerCriterion",
    "TimeDistributedMaskCriterion",
]


def _grad_leaf(x):
    if torch.is_tensor(x) and x.is_floating_point():
        return x.detach().requires_grad_(True)
    if isinstance(x, (tuple, list)):
        return type(x)(_grad_leaf(v) for v in x)
    return x


def _grad_leaves(x):
    if torch.is_tensor(x):
        return [x] if x.requires_grad else []
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _grad_leaves(v)]
    return []


class Criterion(nn.Module):
    """Base criterion: ``forward(input, target) -> scalar loss``."""

    def forward(self, input, target=None):
        raise NotImplementedError

    def backward(self, input, target=None):
        """The loss's gradient with respect to ``input`` (a tensor, or a
        tuple of them for a table input)."""
        x = _grad_leaf(input)
        with torch.enable_grad():
            loss = self.forward(x, target)
        grads = torch.autograd.grad(loss, _grad_leaves(x))
        return grads[0] if torch.is_tensor(x) else tuple(grads)


def _reduce(x, size_average: bool):
    return torch.mean(x) if size_average else torch.sum(x)


def _target(target, like):
    """A float target on ``like``'s device and dtype."""
    return torch.as_tensor(target, device=like.device).to(like.dtype)


def _one_based(target, like):
    return torch.as_tensor(target, device=like.device).long() - 1


def _buffer(module, name, values):
    module.register_buffer(name, None if values is None else
                           torch.as_tensor(values, dtype=torch.float32))


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


class ClassNLLCriterion(Criterion):
    """NLL over log-probabilities with 1-based class targets and optional
    class weights; rows whose target is ``paddingValue`` contribute zero.
    With ``size_average`` the sum is divided by the summed weights of
    the counted rows."""

    def __init__(self, weights=None, size_average: bool = True,
                 logProbAsInput: bool = True, paddingValue: int = -1):
        super().__init__()
        self.size_average = size_average
        self.log_prob_as_input = logProbAsInput
        self.padding_value = paddingValue
        _buffer(self, "class_weights", weights)

    def forward(self, input, target):
        logp = input if self.log_prob_as_input else torch.log(input + 1e-8)
        t = torch.as_tensor(target, device=logp.device).long()
        idx = (t - 1).clamp(0, logp.shape[-1] - 1)
        picked = logp.gather(-1, idx[..., None])[..., 0]
        w = (t != self.padding_value).to(logp.dtype)
        if self.class_weights is not None:
            w = self.class_weights.to(logp.device, logp.dtype)[idx] * w
        total = -(picked * w).sum()
        if self.size_average:
            return total / torch.clamp(w.sum(), min=1e-8)
        return total


class CrossEntropyCriterion(Criterion):
    """LogSoftMax followed by :class:`ClassNLLCriterion`."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.inner = ClassNLLCriterion(weights, size_average)

    def forward(self, input, target):
        return self.inner(torch.log_softmax(input, dim=-1), target)


class CategoricalCrossEntropy(Criterion):
    """Cross entropy with one-hot targets over probabilities."""

    def forward(self, input, target):
        logp = torch.log(torch.clamp(input, 1e-8, 1.0))
        return -torch.mean(torch.sum(_target(target, input) * logp, dim=-1))


class BCECriterion(Criterion):
    """Binary cross entropy on probabilities, optional per-element
    weights."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.size_average = size_average
        _buffer(self, "elem_weights", weights)

    def forward(self, input, target):
        eps = 1e-12
        t = _target(target, input)
        p = torch.clamp(input, eps, 1 - eps)
        ll = t * torch.log(p) + (1 - t) * torch.log1p(-p)
        if self.elem_weights is not None:
            ll = ll * self.elem_weights.to(input.device)
        return _reduce(-ll, self.size_average)


class MSECriterion(Criterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce((input - _target(target, input)) ** 2,
                       self.size_average)


class AbsCriterion(Criterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce(torch.abs(input - _target(target, input)),
                       self.size_average)


class SmoothL1Criterion(Criterion):
    """Huber with delta 1."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        d = torch.abs(input - _target(target, input))
        return _reduce(torch.where(d < 1.0, 0.5 * d * d, d - 0.5),
                       self.size_average)


class DistKLDivCriterion(Criterion):
    """KL(target || input) with input = log-probs; ``size_average``
    divides by the element count (the reference's nElement)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        t = _target(target, input)
        pointwise = t * (torch.log(torch.clamp(t, min=1e-12)) - input)
        pointwise = torch.where(t > 0, pointwise, torch.zeros_like(pointwise))
        return _reduce(pointwise, self.size_average)


class KLDCriterion(Criterion):
    """KL(N(mean, exp(log_var)) || N(0, 1)) of a (mean, log_var) table:
    the VAE loss."""

    def forward(self, input, target=None):
        mean, log_var = input
        return 0.5 * torch.sum(mean ** 2 + torch.exp(log_var) - log_var - 1.0)


# log(2 pi) as the reference's float32 log computes it
_LOG_2PI = float(np.log(np.float32(2 * math.pi)))


class GaussianCriterion(Criterion):
    """Negative log-likelihood of the target under N(mean,
    exp(log_var))."""

    def forward(self, input, target):
        mean, log_var = input
        t = _target(target, mean)
        return 0.5 * torch.sum(log_var + (t - mean) ** 2 / torch.exp(log_var)
                               + _LOG_2PI)


def _cos(a, b):
    return torch.sum(a * b, -1) / (_norm(a) * _norm(b) + 1e-12)


class CosineEmbeddingCriterion(Criterion):
    """y = 1: 1 - cos; y = -1: max(0, cos - margin)."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__()
        self.margin = float(margin)
        self.size_average = size_average

    def forward(self, input, target):
        x1, x2 = input
        y = _target(target, x1).reshape(-1)
        cos = _cos(x1, x2)
        loss = torch.where(y > 0, 1.0 - cos,
                           torch.clamp(cos - self.margin, min=0.0))
        return _reduce(loss, self.size_average)


class HingeEmbeddingCriterion(Criterion):
    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = float(margin)
        self.size_average = size_average

    def forward(self, input, target):
        t = _target(target, input)
        loss = torch.where(t > 0, input,
                           torch.clamp(self.margin - input, min=0.0))
        return _reduce(loss, self.size_average)


class L1HingeEmbeddingCriterion(Criterion):
    """Hinge on the L1 distance of a pair, summed."""

    def __init__(self, margin: float = 1.0):
        super().__init__()
        self.margin = float(margin)

    def forward(self, input, target):
        x1, x2 = input
        t = _target(target, x1)
        d = torch.sum(torch.abs(x1 - x2), dim=-1)
        loss = torch.where(t > 0, d, torch.clamp(self.margin - d, min=0.0))
        return torch.sum(loss)


class MarginCriterion(Criterion):
    """Hinge max(0, margin - y*x); squared for the L2-SVM."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared: bool = False):
        super().__init__()
        self.margin = float(margin)
        self.size_average = size_average
        self.squared = squared

    def forward(self, input, target):
        h = torch.clamp(self.margin - input * _target(target, input), min=0.0)
        if self.squared:
            h = h * h
        return _reduce(h, self.size_average)


class MarginRankingCriterion(Criterion):
    """max(0, -y*(x1 - x2) + margin)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = float(margin)
        self.size_average = size_average

    def forward(self, input, target):
        x1, x2 = input
        t = _target(target, x1)
        loss = torch.clamp(-t * (x1 - x2) + self.margin, min=0.0)
        return _reduce(loss, self.size_average)


class MultiCriterion(Criterion):
    """Weighted sum of criteria on the same (input, target)."""

    def __init__(self):
        super().__init__()
        self.crits = nn.ModuleList([])
        self.crit_weights = ()

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.crits.append(criterion)
        self.crit_weights = self.crit_weights + (float(weight),)
        return self

    def forward(self, input, target):
        total = 0.0
        for c, w in zip(self.crits, self.crit_weights):
            total = total + w * c(input, target)
        return total


class ParallelCriterion(Criterion):
    """The i-th criterion on the i-th (input, target) pair, weighted and
    summed; ``repeat_target`` gives every criterion the whole target."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.crits = nn.ModuleList([])
        self.crit_weights = ()
        self.repeat_target = repeat_target

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.crits.append(criterion)
        self.crit_weights = self.crit_weights + (float(weight),)
        return self

    def forward(self, input, target):
        total = 0.0
        for i, (c, w) in enumerate(zip(self.crits, self.crit_weights)):
            t = target if self.repeat_target else target[i]
            total = total + w * c(input[i], t)
        return total


class MultiLabelMarginCriterion(Criterion):
    """Multi-class multi-label hinge.  Targets: 1-based label indices
    padded with 0; the labels stop at the first 0."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        n_class = input.shape[-1]
        t = torch.as_tensor(target, device=input.device).long()
        valid = torch.cumprod((t > 0).to(input.dtype), dim=-1)   # [..., J]
        idx = (t - 1).clamp(0, n_class - 1)
        target_scores = input.gather(-1, idx)                     # [..., J]
        is_target = torch.clamp(torch.sum(
            F.one_hot(idx, n_class).to(input.dtype) * valid[..., None],
            dim=-2), 0, 1)                                        # [..., C]
        margins = torch.clamp(
            1.0 - (target_scores[..., :, None] - input[..., None, :]),
            min=0.0)
        loss = torch.sum(
            margins * valid[..., :, None] * (1.0 - is_target)[..., None, :],
            dim=(-1, -2)) / n_class
        return _reduce(loss, self.size_average)


class MultiLabelSoftMarginCriterion(Criterion):
    """Sigmoid cross entropy per label, meaned over the labels."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.size_average = size_average
        _buffer(self, "label_weights", weights)

    def forward(self, input, target):
        t = _target(target, input)
        ll = t * F.logsigmoid(input) + (1 - t) * F.logsigmoid(-input)
        if self.label_weights is not None:
            ll = ll * self.label_weights.to(input.device)
        return _reduce(-torch.mean(ll, dim=-1), self.size_average)


class MultiMarginCriterion(Criterion):
    """Multi-class hinge over 1-based targets."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__()
        self.p = p
        self.margin = float(margin)
        self.size_average = size_average
        _buffer(self, "class_weights", weights)

    def forward(self, input, target):
        n_class = input.shape[-1]
        idx = _one_based(target, input)
        correct = input.gather(-1, idx[..., None])
        m = torch.clamp(self.margin - (correct - input), min=0.0)
        if self.p == 2:
            m = m * m
        mask = 1.0 - F.one_hot(idx, n_class).to(input.dtype)
        loss = torch.sum(m * mask, dim=-1) / n_class
        if self.class_weights is not None:
            loss = loss * self.class_weights.to(input.device)[idx]
        return _reduce(loss, self.size_average)


class SoftMarginCriterion(Criterion):
    """log(1 + exp(-y*x))."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        z = -input * _target(target, input)
        return _reduce(torch.logaddexp(z, torch.zeros_like(z)),
                       self.size_average)


class CosineDistanceCriterion(Criterion):
    """1 - cos(input, target)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce(1.0 - _cos(input, _target(target, input)),
                       self.size_average)


class CosineProximityCriterion(Criterion):
    """-mean(cos), Keras-style."""

    def forward(self, input, target):
        t = _target(target, input)
        xn = input / (_norm(input)[..., None] + 1e-12)
        tn = t / (_norm(t)[..., None] + 1e-12)
        return -torch.mean(torch.sum(xn * tn, dim=-1))


class DotProductCriterion(Criterion):
    """-sum(x*y) (policy gradient)."""

    def __init__(self, size_average: bool = False):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        return -_reduce(input * _target(target, input), self.size_average)


class PoissonCriterion(Criterion):
    """Poisson NLL: mean(pred - target*log(pred))."""

    def forward(self, input, target):
        t = _target(target, input)
        return torch.mean(input - t * torch.log(input + 1e-8))


class MeanAbsolutePercentageCriterion(Criterion):
    """100 * mean(|t - p| / clip(|t|))."""

    def forward(self, input, target):
        t = _target(target, input)
        diff = torch.abs(t - input) / torch.clamp(torch.abs(t), min=1e-7)
        return 100.0 * torch.mean(diff)


class MeanSquaredLogarithmicCriterion(Criterion):
    """mean((log(t + 1) - log(p + 1))^2)."""

    def forward(self, input, target):
        t = _target(target, input)
        a = torch.log(torch.clamp(input, min=1e-7) + 1.0)
        b = torch.log(torch.clamp(t, min=1e-7) + 1.0)
        return torch.mean((a - b) ** 2)


class KullbackLeiblerDivergenceCriterion(Criterion):
    """sum(t * log(t / p)) over clipped probabilities, meaned over
    rows."""

    def forward(self, input, target):
        p = torch.clamp(input, 1e-7, 1.0)
        t = torch.clamp(_target(target, input), 1e-7, 1.0)
        return torch.mean(torch.sum(t * torch.log(t / p), dim=-1))


def simplex_embedding(n: int) -> np.ndarray:
    """The reference's regular-simplex class embedding, (n, n) float32."""
    mat = np.zeros((n, n), dtype=np.float32)
    mat[0, 0] = 1.0
    for k in range(1, n):
        s = 0.0
        for j in range(k):
            mat[k, j] = (-1.0 / n - np.dot(mat[k], mat[j])) / mat[j, j]
            s += mat[k, j] ** 2
        mat[k, k] = np.sqrt(max(1.0 - s, 0.0))
    return mat


class ClassSimplexCriterion(Criterion):
    """MSE against simplex-embedded 1-based class targets."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        self.register_buffer("simplex",
                             torch.from_numpy(simplex_embedding(n_classes)))

    def forward(self, input, target):
        t = self.simplex.to(input.device)[_one_based(target, input)]
        return torch.mean(torch.sum((input - t) ** 2, dim=-1))


class L1Cost(Criterion):
    """sum(|x|), the target ignored."""

    def forward(self, input, target=None):
        return torch.sum(torch.abs(input))


class DiceCoefficientCriterion(Criterion):
    """1 - the dice overlap, meaned over the batch."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__()
        self.epsilon = float(epsilon)

    def forward(self, input, target):
        t = _target(target, input)
        axes = tuple(range(1, input.ndim))
        inter = torch.sum(input * t, dim=axes)
        union = torch.sum(input, dim=axes) + torch.sum(t, dim=axes)
        dice = (2.0 * inter + self.epsilon) / (union + self.epsilon)
        return torch.mean(1.0 - dice)


class PGCriterion(Criterion):
    """Policy-gradient criterion: -sum(log(p) * reward)."""

    def __init__(self, sizeAverage: bool = False):
        super().__init__()
        self.size_average = sizeAverage

    def forward(self, input, target):
        logp = torch.log(torch.clamp(input, 1e-8, 1.0))
        return -_reduce(logp * _target(target, input), self.size_average)


class TimeDistributedCriterion(Criterion):
    """A criterion at every step of the time axis (``dimension``,
    1-based), the losses summed; ``size_average`` divides by the number
    of steps.  A 1-D target is every step's."""

    def __init__(self, critrn: Criterion, size_average: bool = False,
                 dimension: int = 2):
        super().__init__()
        self.critrn = critrn
        self.size_average = size_average
        self.dimension = dimension

    def forward(self, input, target):
        t_axis = self.dimension - 1
        n = input.shape[t_axis]
        x = torch.movedim(input, t_axis, 0)
        t = torch.as_tensor(target, device=input.device)
        t = torch.movedim(t, t_axis, 0) if t.ndim > 1 else \
            t.expand((n,) + tuple(t.shape))
        total = torch.sum(torch.stack([self.critrn(x[i], t[i])
                                       for i in range(n)]))
        return total / n if self.size_average else total


class TimeDistributedMaskCriterion(TimeDistributedCriterion):
    """Masked variant; padding is the inner criterion's
    ``paddingValue``."""


class TransformerCriterion(Criterion):
    """Transforms applied to the input and the target before an inner
    criterion."""

    def __init__(self, criterion: Criterion,
                 input_transformer: Optional[nn.Module] = None,
                 target_transformer: Optional[nn.Module] = None):
        super().__init__()
        self.criterion = criterion
        self.input_transformer = input_transformer
        self.target_transformer = target_transformer

    def forward(self, input, target):
        if self.input_transformer is not None:
            input = self.input_transformer.forward(input)
        if self.target_transformer is not None:
            target = self.target_transformer.forward(target)
        return self.criterion(input, target)
