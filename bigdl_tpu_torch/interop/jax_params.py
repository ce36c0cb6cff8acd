"""Carry weights from a ``bigdl_tpu`` model into its port.

``bigdl_tpu``'s ``Module.parameters()`` returns a nested dict whose
leaves are arrays and whose list entries are keyed ``name[i]``
(``blocks[0]``).  The port's modules keep the reference's names and
layouts (``Linear.weight`` is (out, in) in both), so the only change is
the list key: ``blocks[i]`` becomes torch's ``blocks.<i>``.  This module
reads numpy arrays only; it imports nothing of JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["flatten_jax_parameters", "load_jax_parameters"]

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
def load_jax_parameters(model: torch.nn.Module, params: Mapping) \
        -> torch.nn.Module:
    """Copy ``params`` (the reference's ``parameters()`` dict, leaves
    convertible with ``np.asarray``) into ``model`` in place.  Raises
    KeyError on a missing or an extra name and ValueError on a shape
    mismatch; nothing is copied unless every name and shape matches."""
    flat = flatten_jax_parameters(params)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")
    for name, p in own.items():
        if tuple(flat[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(flat[name].shape)} "
                             f"does not match {tuple(p.shape)}")
    for name, p in own.items():
        p.copy_(torch.tensor(flat[name], dtype=p.dtype))
    return model
