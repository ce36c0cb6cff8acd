"""Layer normalisation (counterpart of ``LayerNormalization`` in
``bigdl_tpu/nn/normalization.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device

__all__ = ["LayerNormalization"]


class LayerNormalization(nn.Module):
    """LayerNorm over the last axis: (x - mean) * rsqrt(var + eps) * w + b,
    with the population variance and eps 1e-6."""

    def __init__(self, hidden_size: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=dev))
        self.bias = nn.Parameter(torch.zeros(hidden_size, device=dev))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias,
                            self.eps)
