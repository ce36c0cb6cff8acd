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
(``a[i][j]``) become ``a.<i>.<j>``; :func:`nest_jax_parameters` goes
back, as a checkpoint in the reference's format stores them.  A bare
parameter keeps its name: the ``Transformer``'s ``embedding`` [vocab,
H] loads as it is, beside ``encoder_layers[i]``, ``encoder_norm``,
``decoder_layers[i].cross_attn`` and the rest, for either topology.
The recurrent cells' ``w_input``, ``w_hidden``, ``bias``,
``w_candidate`` and peepholes load as they are (``cells[i]`` of a
``MultiRNNCell`` as ``cells.<i>``), and so do the zoo models' names
(``stem.layers.<i>``, ``blocks.<i>``, ``lm.`` of the perf CLI's flat
LM), and the detectors' (SSD's ``base.<i>``, ``fc6``, ``loc_layers.<i>``,
``conv4_3_norm``; Mask R-CNN's ``backbone.stages.<i>.<j>``,
``backbone.fpn``, ``rpn``, ``box_head``, ``mask_head``), and the
tree-LSTM's (``leaf_w``, ``leaf_b``, ``comp_w``, ``comp_b``), and the
wide-and-deep recommender's (its four tables ``user_table``,
``item_table``, ``wide_user``, ``wide_item``, each a ``weight``, then the
tower's ``tower.layers.<i>``; a sparse layer's ``inner``).  Buffers
are the persistent ones: BatchNorm's running statistics, a penalty
layer's ``loss``, a local normalisation's ``kernel``, a connection
table's ``mask``, and an int8 layer's ``qweight`` (int8, copied as it
is), ``wscale`` and ``bias`` (a non-persistent buffer, such as the LM's
position table, is derived and the reference has none).  This module
reads numpy arrays only; it imports nothing of JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["flatten_jax_parameters", "nest_jax_parameters",
           "state_buffers", "load_jax_parameters", "load_jax_buffers"]

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


def nest_jax_parameters(flat: Mapping[str, object]) -> Dict:
    """{torch name: value} → the reference's nested dict, keys in the
    order given: a numeric name component is a list index of the
    component before it (``blocks.0.attn.wq`` → ``{"blocks[0]": {"attn":
    {"wq": ...}}}``).  The inverse of :func:`flatten_jax_parameters`."""
    out: Dict = {}
    for name, value in flat.items():
        keys: list = []
        for part in name.split("."):
            if part.isdigit() and keys:
                keys[-1] += f"[{part}]"
            else:
                keys.append(part)
        node = out
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return out


def state_buffers(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's persistent buffers by name (those of its
    ``state_dict``), in ``named_buffers`` order."""
    keys = model.state_dict(keep_vars=True).keys()
    return {n: b for n, b in model.named_buffers() if n in keys}


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
    ``running_mean`` and ``running_var``) into ``model``'s persistent
    buffers in place, under the rules of :func:`load_jax_parameters`."""
    _load(state_buffers(model), buffers, "buffer")
    return model
