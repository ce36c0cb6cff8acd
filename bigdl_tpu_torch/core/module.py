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

The rest of the reference's Module core works on any ``torch.nn.Module``
(the port's ``TransformerLM`` and ``ResNet`` subclass ``nn.Module``, not
:class:`Module`) as free functions over ``{dotted path: tensor}`` dicts:
:func:`clone`, :func:`freeze` / :func:`unfreeze` / :func:`is_frozen`
(``requires_grad=False``, PyTorch's idiom for the reference's frozen
flag), :func:`param_paths`, :func:`partition` / :func:`combine`,
:func:`cast_floating` and :func:`tree_map_params`.  :class:`Module`
carries them as methods, with the modes, ``backward``, the flat
``get_parameters`` view, the nested-dict views and the inference entry
points.
"""

from __future__ import annotations

import copy as _copy
import re
import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

__all__ = ["forward_context", "next_generator", "has_generator", "dropout",
           "ReplayStreams", "recompute", "Module", "Node", "Input",
           "node_of", "clone", "freeze", "unfreeze", "is_frozen",
           "param_paths", "partition", "combine", "cast_floating",
           "tree_map_params"]


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


# ---------------------------------------------------------------------------
# clone, freeze, partition / combine: free functions on any nn.Module
# ---------------------------------------------------------------------------

# a module's settings of these types are copied by clone(); its other
# settings (numbers, strings, tuples, meshes, regularizers, init methods)
# are shared by reference
_COPIED = (torch.Tensor, nn.Module, list, dict, set, bytearray)


def _share_settings(module: nn.Module, memo: dict, recurse: bool = True):
    """Enter ``module``'s static settings into a deepcopy ``memo`` as
    themselves: the reference shares its ``_static`` values by reference
    (some hold a mesh whose device handles cannot be copied)."""
    for m in (module.modules() if recurse else (module,)):
        for value in vars(m).values():
            if not isinstance(value, _COPIED):
                memo[id(value)] = value


def clone(module: nn.Module, memo: Optional[dict] = None) -> nn.Module:
    """A deep copy of ``module`` (counterpart of ``Module.clone``): its
    parameters and buffers are copied on their device, its static
    settings (a ``set_sequence_parallel`` mesh among them) shared by
    reference, as the reference's ``__deepcopy__`` shares ``_static``."""
    memo = {} if memo is None else memo
    _share_settings(module, memo)
    return _copy.deepcopy(module, memo)


def _module_name(m: nn.Module) -> str:
    return getattr(m, "name", type(m).__name__)


_LIST_KEY = re.compile(r"\[(\d+)\]")


def freeze(module: nn.Module, *names: str) -> nn.Module:
    """Exclude ``module``'s parameters (or those of its descendants named
    ``names``, by ``name`` or dotted path; the reference's ``layers[0]``
    reads as ``layers.0``) from training: ``requires_grad=False``, which
    the ``Optimizer`` and :func:`partition` read.  Returns ``module``."""
    if not names:
        module.requires_grad_(False)
        return module
    wanted = {_LIST_KEY.sub(r".\1", n) for n in names}
    for path, m in module.named_modules():
        if path in wanted or _module_name(m) in wanted:
            m.requires_grad_(False)
    return module


def unfreeze(module: nn.Module) -> nn.Module:
    """Make every parameter of ``module`` trainable again."""
    return module.requires_grad_(True)


def is_frozen(module: nn.Module) -> bool:
    """True when ``module`` has parameters and none of them trains (a
    module without parameters has nothing to freeze)."""
    params = list(module.parameters())
    return bool(params) and not any(p.requires_grad for p in params)


def param_paths(module: nn.Module) -> List[str]:
    """Dotted paths of the trainable parameters, in ``named_parameters``
    order: the reference's order (a module's own parameters, then its
    submodules'), frozen ones left out."""
    return [n for n, p in module.named_parameters() if p.requires_grad]


class _Half(dict):
    """One half of :func:`partition`: ``{dotted path: tensor}`` and the
    module it came from, which :func:`combine` rebuilds."""

    __slots__ = ("module",)

    def __init__(self, items, module: nn.Module):
        super().__init__(items)
        self.module = module


def partition(module: nn.Module) -> Tuple[Dict[str, torch.Tensor],
                                          Dict[str, torch.Tensor]]:
    """Split ``module`` into ``(params, rest)``: the trainable parameters
    by dotted path, and the rest (frozen parameters and buffers), as the
    reference's ``_param_flags`` puts a frozen module's parameters in the
    remainder.  The dicts hold the module's own tensors;
    :func:`combine` restores a module from them."""
    params, rest = {}, {}
    for name, p in module.named_parameters():
        (params if p.requires_grad else rest)[name] = p
    rest.update(module.named_buffers())
    return _Half(params, module), _Half(rest, module)


def _rebuilt(template: nn.Module, values: Dict[str, torch.Tensor]) \
        -> nn.Module:
    """A clone of ``template`` that holds ``values`` (by dotted path, no
    copy) in place of its parameters and buffers of those names; a
    parameter keeps its ``requires_grad``."""
    memo: dict = {}
    for name, t in [*template.named_parameters(),
                    *template.named_buffers()]:
        if name not in values:
            continue
        v = values[name]
        if isinstance(t, nn.Parameter):
            v = nn.Parameter(v.detach(), requires_grad=t.requires_grad)
        memo[id(t)] = v
    return clone(template, memo)


def combine(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
            module: Optional[nn.Module] = None) -> nn.Module:
    """A new module holding the tensors of ``a`` and ``b`` (``a`` wins
    where both name one; ``None`` entries are skipped): a clone of
    ``module``, by default the module that :func:`partition` split.
    The tensors are held, not copied.  (The reference's ``combine``
    merges two pytrees and is differentiated through; here
    ``torch.func.functional_call(module, {**a, **b}, x)`` is the
    differentiable form.)"""
    template = module
    for half in (a, b):
        template = template or getattr(half, "module", None)
    if template is None:
        raise TypeError("combine needs the module: pass the dicts that "
                        "partition() returned, or module=")
    values = {k: v for k, v in b.items() if v is not None}
    values.update((k, v) for k, v in a.items() if v is not None)
    return _rebuilt(template, values)


def cast_floating(value, dtype):
    """Cast every floating-point tensor to ``dtype``: a tensor, a tuple,
    list or dict of them, or a module (a new module whose floating
    parameters and buffers are cast; the reference's pytree cast)."""
    if isinstance(value, nn.Module):
        return _rebuilt(value, {
            n: t.to(dtype) for n, t in [*value.named_parameters(),
                                        *value.named_buffers()]
            if t.is_floating_point()})
    if isinstance(value, dict):
        return {k: cast_floating(v, dtype) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(cast_floating(v, dtype) for v in value)
    if torch.is_tensor(value) and value.is_floating_point():
        return value.to(dtype)
    return value


def tree_map_params(fn: Callable, module: nn.Module) -> nn.Module:
    """A new module with ``fn`` applied to every trainable parameter."""
    params, rest = partition(module)
    return combine({k: fn(v) for k, v in params.items()}, rest,
                   module=module)


def _nested(flat: Dict[str, object]) -> Dict:
    """{dotted path: value} → the reference's nested dict (``blocks.0``
    becomes the key ``blocks[0]``)."""
    from bigdl_tpu_torch.interop.jax_params import nest_jax_parameters
    return nest_jax_parameters(flat)


def _flat(tree, prefix: str = "") -> Dict[str, object]:
    """The reference's nested dict → {dotted path: value}, values as
    they are."""
    out: Dict[str, object] = {}
    for key, value in tree.items():
        name = prefix + _LIST_KEY.sub(r".\1", str(key))
        if isinstance(value, dict):
            out.update(_flat(value, name + "."))
        else:
            out[name] = value
    return out


def _sorted_leaves(tree) -> List:
    """The leaves of a nested dict in ``ravel_pytree``'s order: keys
    sorted at every level."""
    out: List = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(_sorted_leaves(value) if isinstance(value, dict)
                   else [value])
    return out


@torch.no_grad()
def _load_tree(own: Dict[str, torch.Tensor], tree) -> None:
    for name, value in _flat(tree).items():
        if name in own:
            t = own[name]
            if not torch.is_tensor(value):
                value = torch.tensor(value)   # a copy: arrays may be read-only
            t.copy_(value.to(dtype=t.dtype, device=t.device))


_SERIALIZER = ("is not ported yet (ROADMAP.md queue 1, item 13: "
               "utils/serializer.py)")


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

    # ---- modes -------------------------------------------------------------

    def train_mode(self, flag: bool = True) -> "Module":
        """Training mode, recursively (the reference's ``training()``)."""
        return self.train(flag)

    def eval_mode(self) -> "Module":
        """Evaluation mode, recursively (the reference's ``evaluate()``)."""
        return self.train(False)

    def is_training(self) -> bool:
        return self.training

    # ---- backward ----------------------------------------------------------

    def backward(self, input, grad_output):
        """grad_input of ``forward(input)`` for the cotangent
        ``grad_output`` (the reference's ``backward``, a ``jax.vjp``).
        Runs on a functional copy, as the reference's does: the
        parameters detached and the buffers cloned, so the live module's
        ``.grad``s and buffers are untouched.  ``input`` is a tensor or a
        tuple of tensors; so is the result."""
        tensors = {n: p.detach() for n, p in self.named_parameters()}
        tensors.update((n, b.clone()) for n, b in self.named_buffers())
        single = not isinstance(input, (tuple, list))
        xs = tuple(x.detach().requires_grad_()
                   for x in ((input,) if single else input))
        with torch.enable_grad():
            y = functional_call(self, tensors, (xs[0] if single else xs,))
            grads = torch.autograd.grad(y, xs, grad_output,
                                        allow_unused=True)
        return grads[0] if single else grads

    # ---- copies and freezing -------------------------------------------------

    def __deepcopy__(self, memo):
        """The reference's rule: static settings shared by reference,
        everything else (parameters, buffers, submodules) copied."""
        _share_settings(self, memo, recurse=False)
        cls = type(self)
        new = cls.__new__(cls)
        memo[id(self)] = new
        for key, value in self.__dict__.items():
            new.__dict__[key] = _copy.deepcopy(value, memo)
        return new

    def clone(self) -> "Module":
        return clone(self)

    def freeze(self, *names: str) -> "Module":
        """See :func:`freeze`."""
        return freeze(self, *names)

    def unfreeze(self) -> "Module":
        return unfreeze(self)

    def is_frozen(self) -> bool:
        return is_frozen(self)

    # ---- parameter views -----------------------------------------------------

    def get_parameters(self):
        """``(flat, unravel)``: every parameter (frozen ones too, as the
        reference's ``parameters()`` holds them) in one 1-D tensor, in
        the reference's ``ravel_pytree`` order (the nested dict's keys
        sorted at every level, not ``named_parameters`` order), and
        ``unravel(flat)`` → the nested dict of :meth:`parameter_tree`
        (the reference's ``getParameters``)."""
        named = dict(self.named_parameters())
        order = _sorted_leaves(_nested({n: n for n in named}))
        flat = torch.cat([named[n].detach().reshape(-1) for n in order]) \
            if order else torch.zeros(0)

        def unravel(vector):
            out, offset = {}, 0
            for n in order:
                size = named[n].numel()
                out[n] = vector[offset:offset + size].reshape(
                    named[n].shape)
                offset += size
            return _nested({n: out[n] for n in named})
        return flat, unravel

    def n_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def parameter_tree(self) -> Dict:
        """The parameters as the reference's nested dict (its
        ``parameters()``; ``nn.Module.parameters`` stays the iterator
        that the Optimizer and PyTorch read), the live tensors."""
        return _nested(dict(self.named_parameters()))

    def buffer_tree(self) -> Dict:
        """The persistent buffers as the reference's nested dict (its
        ``buffers()``)."""
        from bigdl_tpu_torch.interop.jax_params import state_buffers
        return _nested(state_buffers(self))

    def load_parameters(self, tree) -> "Module":
        """Copy the parameters named in ``tree`` (a nested dict as
        :meth:`parameter_tree` gives) in place; other names are left as
        they are (the reference's ``load_parameters``)."""
        _load_tree(dict(self.named_parameters()), tree)
        return self

    def load_buffers(self, tree) -> "Module":
        """Copy the buffers named in ``tree`` in place (the reference's
        ``load_buffers``)."""
        _load_tree(dict(self.named_buffers()), tree)
        return self

    # ---- inference ----------------------------------------------------------

    def predict(self, data, batch_size: int = 32, device=None):
        from bigdl_tpu_torch.optim.predictor import Predictor
        return Predictor(self, batch_size, device=device).predict(data)

    def predict_class(self, data, batch_size: int = 32, device=None):
        from bigdl_tpu_torch.optim.predictor import Predictor
        return Predictor(self, batch_size, device=device).predict_class(
            data)

    def evaluate(self, data, methods, batch_size: int = 32, device=None):
        from bigdl_tpu_torch.optim.predictor import Evaluator
        return Evaluator(self, batch_size, device=device).evaluate(
            data, methods)

    def quantize(self) -> nn.Module:
        """An int8 inference copy (reference AbstractModule.quantize):
        :meth:`Quantizer.quantize <bigdl_tpu_torch.nn.quantized.Quantizer
        .quantize>`."""
        from bigdl_tpu_torch.nn.quantized import Quantizer
        return Quantizer.quantize(self)

    # ---- not ported yet -------------------------------------------------------

    def save(self, path: str):
        raise NotImplementedError(f"Module.save {_SERIALIZER}")

    @staticmethod
    def load(path: str):
        raise NotImplementedError(f"Module.load {_SERIALIZER}")

    def save_weights(self, path: str):
        raise NotImplementedError(f"Module.save_weights {_SERIALIZER}")

    def load_weights(self, path: str, strict: bool = True):
        raise NotImplementedError(f"Module.load_weights {_SERIALIZER}")
