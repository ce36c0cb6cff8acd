"""The MNIST autoencoder (counterpart of ``bigdl_tpu/models/autoencoder.py``;
the reference's models/autoencoder/Autoencoder.scala): flatten to 784 →
Linear(784, class_num) → ReLU → Linear(class_num, 784) → Sigmoid.
Weights are drawn from the caller's ``torch.Generator`` on the CPU and
moved to ``device`` (default ``cuda``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Module

__all__ = ["Autoencoder", "autoencoder"]

ROW_N = COL_N = 28
FEATURE_SIZE = ROW_N * COL_N


class Autoencoder(Module):
    def __init__(self, class_num: int = 32, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        gen = dict(generator=generator, device=device)
        self.encoder = nn.Linear(FEATURE_SIZE, class_num, **gen)
        self.decoder = nn.Linear(class_num, FEATURE_SIZE, **gen)

    def forward(self, x):
        y = torch.relu(self.encoder(x.reshape(x.shape[0], -1)))
        return torch.sigmoid(self.decoder(y))


def autoencoder(class_num: int = 32, *, generator: torch.Generator,
                device=None) -> Autoencoder:
    return Autoencoder(class_num, generator=generator, device=device)
