"""Carry weights and buffers from a ``bigdl_tpu`` model into its port.

``bigdl_tpu``'s ``Module.parameters()`` and ``Module.buffers()`` return
nested dicts whose leaves are arrays and whose list entries are keyed
``name[i]`` (``blocks[0]``).  The port's modules keep the reference's
names and layouts (``Linear.weight`` is (out, in) in both, a conv weight
HWIO in both), so the only change is the list key: ``blocks[i]`` becomes
torch's ``blocks.<i>``.  A container's children load the same way: the
reference's ``layers[i]`` (``Sequential``, ``Concat``, ``ConcatTable``
...) and ``graph_modules[i]`` (``Graph``, in its topological order) are
the port's ``layers.<i>`` and ``graph_modules.<i>``, nested lists
(``a[i][j]``) become ``a.<i>.<j>``.  This module reads numpy arrays only;
it imports nothing of JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["flatten_jax_parameters", "load_jax_parameters",
           "load_jax_buffers"]

_LIST_KEY = re.compile(r"\[(\d+)\]")


def flatten_jax_parameters(params: Mapping, prefix: str = "") \
        -> Dict[str, np.ndarray]:
    """Nested reference parameter dict → {torch parameter name: array}."""
    out: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        name = prefix + _LIST_KEY.sub(r".\1", str(key))
        if isinstance(value, Mapping):
            out.update(flatten_jax_parameters(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


@torch.no_grad()
def _load(own: Dict[str, torch.Tensor], tree: Mapping, what: str):
    """Copy the nested ``tree`` into the named tensors ``own`` in place,
    after checking every name and shape."""
    flat = flatten_jax_parameters(tree)
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"{what} names differ: missing {missing}, "
                       f"extra {extra}")
    for name, t in own.items():
        if tuple(flat[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(flat[name].shape)} "
                             f"does not match {tuple(t.shape)}")
    for name, t in own.items():
        t.copy_(torch.tensor(flat[name], dtype=t.dtype))


def load_jax_parameters(model: torch.nn.Module, params: Mapping) \
        -> torch.nn.Module:
    """Copy ``params`` (the reference's ``parameters()`` dict, leaves
    convertible with ``np.asarray``) into ``model`` in place.  Raises
    KeyError on a missing or an extra name and ValueError on a shape
    mismatch; nothing is copied unless every name and shape matches."""
    _load(dict(model.named_parameters()), params, "parameter")
    return model


def load_jax_buffers(model: torch.nn.Module, buffers: Mapping) \
        -> torch.nn.Module:
    """Copy ``buffers`` (the reference's ``buffers()`` dict: BatchNorm's
    ``running_mean`` and ``running_var``) into ``model``'s buffers in
    place, under the rules of :func:`load_jax_parameters`."""
    _load(dict(model.named_buffers()), buffers, "buffer")
    return model
