"""The forward context, the layers' base class and the Graph DSL's
nodes (counterpart of ``forward_context``/``next_rng_key``,
``Module.set_name`` and the regularizer slots in
``bigdl_tpu/core/module.py``, and of ``Node``/``Input``/``node_of`` in
``bigdl_tpu/nn/containers.py``, kept here so that ``Module.__call__``
tells a node from a tensor without an import).

The reference carries a JAX key through ``forward`` calls without
changing their signatures and raises "No RNG in scope" when a
training-mode stochastic layer finds none.  The port carries a
``torch.Generator`` the same way: train-mode dropout draws its mask from
:func:`next_generator`, never from torch's global RNG, so a run's
randomness is a function of the generator its caller seeded.  The
generator must live on the device of the tensors it draws for.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List, Optional

import torch
from torch import nn

__all__ = ["forward_context", "next_generator", "has_generator", "dropout",
           "Module", "Node", "Input", "node_of"]


class _ForwardContext(threading.local):
    def __init__(self):
        self.generator: Optional[torch.Generator] = None


_ctx = _ForwardContext()


@contextmanager
def forward_context(generator: Optional[torch.Generator] = None):
    """Provide ``generator`` to the stochastic layers of the enclosed
    ``forward`` calls (nested contexts restore the outer one)."""
    prev = _ctx.generator
    _ctx.generator = generator
    try:
        yield
    finally:
        _ctx.generator = prev


def next_generator() -> torch.Generator:
    """The generator in scope; raises without one, as the reference's
    ``next_rng_key`` does."""
    if _ctx.generator is None:
        raise RuntimeError(
            "No RNG in scope: wrap the forward call in "
            "`with forward_context(generator=torch.Generator(...)):` "
            "(training mode stochastic layers need randomness).")
    return _ctx.generator


def has_generator() -> bool:
    """Whether a generator is in scope (the reference's ``has_rng``)."""
    return _ctx.generator is not None


def dropout(x, p: float):
    """Inverted dropout with a keep mask ~ Bernoulli(1 - p) drawn from
    the generator in scope: ``where(keep, x / (1 - p), 0)``, the
    reference's arithmetic."""
    keep = torch.rand(x.shape, generator=next_generator(),
                      device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


_KEEP = ("__keep__",)


class Node:
    """A graph node wrapping a module (``None`` for an input); calling a
    port module on nodes builds edges."""

    _counter = [0]

    def __init__(self, module: Optional[nn.Module]):
        self.module = module
        self.prev: List["Node"] = []
        Node._counter[0] += 1
        self.id = Node._counter[0]

    def __repr__(self):
        m = getattr(self.module, "name", None) if self.module else "Input"
        return f"Node[{self.id}]({m})"


def Input() -> Node:
    """A placeholder input node."""
    return Node(None)


def node_of(module: nn.Module, *inputs: Node) -> Node:
    n = Node(module)
    n.prev = list(inputs)
    return n


class Module(nn.Module):
    """Base of the port's layers: ``torch.nn.Module`` with the
    reference's ``name`` (the class name until :meth:`set_name`), the
    per-layer regularizer and gradient-scale slots the ``Optimizer``
    reads (``optim/regularizer.py``'s ``leaf_reg_specs``), and the Graph
    DSL: a module called on :class:`Node` objects returns a new node
    instead of running ``forward``."""

    def __init__(self):
        super().__init__()
        self.name = type(self).__name__

    def __call__(self, *inputs, **kwargs):
        if (inputs and type(inputs[0]) is Node and not kwargs
                and all(isinstance(i, Node) for i in inputs)):
            return node_of(self, *inputs)
        return super().__call__(*inputs, **kwargs)

    def set_name(self, name: str) -> "Module":
        self.name = name
        return self

    def get_name(self) -> str:
        return self.name

    def set_regularizers(self, w_regularizer=_KEEP,
                         b_regularizer=_KEEP) -> "Module":
        """Attach regularizers to this module's own parameters:
        ``w_regularizer`` to those whose name does not contain "bias",
        ``b_regularizer`` to the rest.  Only the arguments passed change;
        ``None`` clears one."""
        if w_regularizer is not _KEEP:
            self.w_regularizer = w_regularizer
        if b_regularizer is not _KEEP:
            self.b_regularizer = b_regularizer
        return self

    def set_scale_w(self, scale: float) -> "Module":
        """Gradient scale of the weight-like parameters, set on every
        submodule (the reference's ``setScaleW``)."""
        for m in self.modules():
            m._scale_w = float(scale)
        return self

    def set_scale_b(self, scale: float) -> "Module":
        """Gradient scale of the bias parameters, set on every submodule
        (the reference's ``setScaleB``)."""
        for m in self.modules():
            m._scale_b = float(scale)
        return self
