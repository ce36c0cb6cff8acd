"""Per-layer L1/L2/L1L2 regularizers and gradient scaling (counterpart
of ``bigdl_tpu/optim/regularizer.py``).

A layer's ``w_regularizer`` covers its parameters whose name does not
contain "bias", its ``b_regularizer`` the rest; ``set_scale_w`` and
``set_scale_b`` set the gradient scales.  The ``Optimizer``'s step turns
each parameter's gradient into

    g_eff = scale · (g + l1·sign(p) + l2·p)

before clipping, as the reference's step does (the reference's
``accRegularization`` algebra, optim/Regularizer.scala).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

__all__ = ["Regularizer", "L1L2Regularizer", "L1Regularizer",
           "L2Regularizer", "leaf_reg_specs"]


@dataclass(frozen=True)
class L1L2Regularizer:
    """Adds ``l1·sign(p) + l2·p`` to the gradient."""
    l1: float = 0.0
    l2: float = 0.0


Regularizer = L1L2Regularizer  # the reference's base trait, one impl


def L1Regularizer(l1: float) -> L1L2Regularizer:
    return L1L2Regularizer(l1=l1)


def L2Regularizer(l2: float) -> L1L2Regularizer:
    return L1L2Regularizer(l2=l2)


def leaf_reg_specs(model: torch.nn.Module) \
        -> List[Tuple[float, float, float]]:
    """(l1, l2, scale) of each trainable parameter, in the order of
    ``model.parameters()`` (a shared parameter once, with the spec of
    the first module that holds it)."""
    spec_of = {}
    for mod in model.modules():
        wreg = getattr(mod, "w_regularizer", None)
        breg = getattr(mod, "b_regularizer", None)
        sw = float(getattr(mod, "_scale_w", 1.0))
        sb = float(getattr(mod, "_scale_b", 1.0))
        for name, p in mod.named_parameters(recurse=False):
            is_bias = "bias" in name
            reg = breg if is_bias else wreg
            spec_of.setdefault(id(p), (
                float(getattr(reg, "l1", 0.0) or 0.0),
                float(getattr(reg, "l2", 0.0) or 0.0),
                sb if is_bias else sw))
    return [spec_of[id(p)] for p in model.parameters() if p.requires_grad]
