"""Loss criteria (counterpart of ``Criterion``, ``ClassNLLCriterion`` and
``CrossEntropyCriterion`` in ``bigdl_tpu/nn/criterion.py``).

``forward(input, target)`` returns a scalar tensor; autograd gives the
gradient.  Class targets are 1-based, the reference's Torch convention.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Criterion", "ClassNLLCriterion", "CrossEntropyCriterion"]


class Criterion(nn.Module):
    """Base criterion: ``forward(input, target) -> scalar loss``."""

    def forward(self, input, target):
        raise NotImplementedError


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
        self.register_buffer("class_weights", None if weights is None
                             else torch.as_tensor(weights,
                                                  dtype=torch.float32))

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
