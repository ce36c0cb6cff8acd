"""LeNet-5 (counterpart of ``bigdl_tpu/models/lenet.py``; the reference's
models/lenet/LeNet5.scala): conv5x5x6 → tanh → pool → conv5x5x12 → tanh
→ pool → fc100 → tanh → fc{classes} → logsoftmax over NHWC
[batch, 28, 28, 1] input.  The weights are drawn from the caller's
``torch.Generator`` on the CPU and moved to ``device`` (default
``cuda``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn

__all__ = ["LeNet5", "lenet5_graph"]


def _layers(class_num: int, generator: torch.Generator, device):
    kw = dict(generator=generator, device=device)
    return [
        nn.Reshape((28, 28, 1), batch_mode=True),
        nn.SpatialConvolution(1, 6, 5, 5, **kw).set_name("conv1_5x5"),
        nn.Tanh(),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        nn.SpatialConvolution(6, 12, 5, 5, **kw).set_name("conv2_5x5"),
        nn.Tanh(),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        nn.Flatten(),
        nn.Linear(12 * 4 * 4, 100, **kw).set_name("fc1"),
        nn.Tanh(),
        nn.Linear(100, class_num, **kw).set_name("fc2"),
        nn.LogSoftMax(),
    ]


def LeNet5(class_num: int = 10, *, generator: torch.Generator,
           device=None) -> nn.Sequential:
    """Sequential LeNet-5 (LeNet5.scala:26); the convolutions and linear
    layers are named as the reference names them."""
    return nn.Sequential(*_layers(class_num, generator, device))


def lenet5_graph(class_num: int = 10, *, generator: torch.Generator,
                 device=None) -> nn.Graph:
    """The Graph-container variant (LeNet5.scala:42), its modules in the
    reference's order (the reference leaves them unnamed)."""
    x = inp = nn.Input()
    for layer in _layers(class_num, generator, device):
        x = layer.set_name(type(layer).__name__)(x)
    return nn.Graph(inp, x)
