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

:func:`recompute` is the reference's ``jax.checkpoint`` of a block: the
block's activations are recomputed in the backward, and its dropout
masks are drawn again from the stream they were drawn from in the
forward (``jax.checkpoint`` replays the same key).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List, Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

__all__ = ["forward_context", "next_generator", "has_generator", "dropout",
           "ReplayStreams", "recompute", "Module", "Node", "Input",
           "node_of"]


class _ForwardContext(threading.local):
    def __init__(self):
        self.generator: Optional[torch.Generator] = None
        self.streams: Optional["ReplayStreams"] = None


_ctx = _ForwardContext()


@contextmanager
def forward_context(generator: Optional[torch.Generator] = None,
                    streams: Optional["ReplayStreams"] = None):
    """Provide ``generator`` to the stochastic layers of the enclosed
    ``forward`` calls (nested contexts restore the outer one).
    ``streams`` keeps the twins that the forward's :func:`recompute`
    calls replay from, counted from the context's start (a CUDA graph
    capture of the step needs them: see :class:`ReplayStreams`)."""
    prev = _ctx.generator, _ctx.streams
    _ctx.generator, _ctx.streams = generator, streams
    if streams is not None:
        streams.rewind()
    try:
        yield
    finally:
        _ctx.generator, _ctx.streams = prev


class ReplayStreams:
    """The twin generators from which a step's :func:`recompute` calls
    draw again, one per call in the order of the forward, for a CUDA
    graph of the step.  A captured graph can neither read a generator's
    state nor set it, so each twin is registered with the graph before
    the capture and, before every replay, seeded as the generator in
    scope stood at its call: the step's seed and ``offsets[i]``, the
    philox offset that call saw in the eager step before the capture
    (:meth:`seed`).  Outside a capture a call replays from a fresh
    generator set to the state in scope, and on the card records the
    offset."""

    def __init__(self):
        self.twins: List[torch.Generator] = []
        self.offsets: List[int] = []
        self._next = 0

    def rewind(self):
        self._next = 0

    def twin(self, generator: torch.Generator) -> torch.Generator:
        """The generator that the next recompute call replays from."""
        i = self._next
        self._next += 1
        if generator.device.type != "cuda":
            return _fresh_twin(generator)
        if torch.cuda.is_current_stream_capturing():
            if i >= len(self.twins):
                raise RuntimeError(
                    "recompute under CUDA graph capture: no twin "
                    f"generator for call {i}; run the step eagerly "
                    "before capturing it")
            return self.twins[i]
        if i == len(self.twins):
            self.twins.append(torch.Generator(device=generator.device))
            self.offsets.append(0)
        self.offsets[i] = generator.get_offset()
        return _fresh_twin(generator)

    def seed(self, seed: int, offsets: List[int]):
        """Seed each twin as the generator stood at its call, after
        ``manual_seed(seed)`` and ``offsets[i]`` of draws (before a
        replay of the graph whose eager step recorded ``offsets``)."""
        for twin, offset in zip(self.twins, offsets):
            twin.manual_seed(seed)
            twin.set_offset(offset)


def _fresh_twin(generator: torch.Generator) -> torch.Generator:
    """A new generator in the state of ``generator``."""
    twin = torch.Generator(device=generator.device)
    twin.set_state(generator.get_state())
    return twin


def _replay_generator(generator: torch.Generator) -> torch.Generator:
    """The generator a recompute of the call starting now draws from: the
    stream of ``generator`` as it stands, kept apart from it."""
    if _ctx.streams is not None:
        return _ctx.streams.twin(generator)
    return _fresh_twin(generator)


def recompute(module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` with its activations recomputed in the
    backward instead of kept (``torch.utils.checkpoint``, non-reentrant;
    torch's own RNG states are not saved: the port never draws from
    them).  The recompute draws its dropout masks again from the stream
    the forward drew them from (a twin of the generator in scope, see
    :func:`_replay_generator`), with no generator in scope needed in the
    backward, and binds the module's tensors as the forward saw them (the
    compute-dtype casts of ``functional_call``)."""
    generator = _ctx.generator
    twin = None if generator is None else _replay_generator(generator)
    tensors = {**dict(module.named_parameters()),
               **dict(module.named_buffers())}
    calls = [0]

    def run(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:
            return module(*a, **kw)
        with forward_context(generator=twin):
            return functional_call(module, tensors, a, kw)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


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
