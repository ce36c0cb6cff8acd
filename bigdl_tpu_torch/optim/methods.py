"""Optimization methods (counterpart of ``LearningRateSchedule``,
``Default``, ``OptimMethod`` and ``SGD`` in ``bigdl_tpu/optim/methods.py``).

The reference's methods are pure ``update(grads, params, state) ->
(params, state)`` transforms compiled into the step.  The port updates
the parameters and the momentum buffers IN PLACE under ``no_grad`` (no
second copy of either) and returns the same list and state dict, so the
reference's calling convention still reads the same.  The step counter
``state["t"]`` is a host int; the learning rate is computed in float32
as the reference computes it on the device.

``update`` is ``current_lr`` (the host's float32 learning rate of the
step), ``apply`` (the arithmetic, under ``no_grad``) and the counter's
increment.  ``apply`` takes the learning rate as a float or as a 0-dim
float32 tensor: the ``Optimizer``'s captured CUDA graph reads it from a
static tensor that the host writes before each replay, so neither the
rate nor the counter is baked into the graph, and the tensor gives the
float's bits (a float32 product either way).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["LearningRateSchedule", "Default", "OptimMethod", "SGD"]


class LearningRateSchedule:
    """lr(base_lr, step, epoch) -> scalar; pure function of progress."""

    def __call__(self, base_lr, step, epoch):
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + step*decay), in float32 (the reference's SGD.Default)."""

    def __init__(self, learning_rate_decay: float = 0.0):
        self.decay = learning_rate_decay

    def __call__(self, base_lr, step, epoch):
        f = np.float32
        return float(f(base_lr) / (f(1.0) + f(step) * f(self.decay)))


class OptimMethod:
    """Base update rule: ``init_state(params)`` then ``update(grads,
    params, state, epoch) -> (params, state)``, which is
    ``apply(grads, params, state, current_lr(state, epoch))`` and one
    step of ``state["t"]``."""

    def init_state(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {"t": 0}

    def current_lr(self, state, epoch=0) -> float:
        """The learning rate of the step ``state["t"]``, on the host."""
        raise NotImplementedError

    def apply(self, grads, params, state, lr):
        """Update ``params`` and the tensors of ``state`` in place with
        learning rate ``lr`` (a float or a 0-dim float32 tensor)."""
        raise NotImplementedError

    def update(self, grads, params, state, epoch=0):
        self.apply(grads, params, state, self.current_lr(state, epoch))
        state["t"] += 1
        return params, state


class SGD(OptimMethod):
    """SGD with momentum, dampening, nesterov, weight decay and the
    ``Default`` decay schedule (the reference's ``SGD``).  Other schedules
    are not ported yet (ROADMAP.md queue 1, item 9: the rest of
    ``optim/methods.py``)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0,
                 momentum: float = 0.0,
                 dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        if learning_rate_schedule is not None and not isinstance(
                learning_rate_schedule, Default):
            raise NotImplementedError(
                f"{type(learning_rate_schedule).__name__} is not ported "
                "yet (ROADMAP.md queue 1, item 9: the rest of "
                "optim/methods.py); only Default is")
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "Nesterov momentum requires momentum > 0 and dampening = 0")

    def init_state(self, params):
        s: Dict[str, Any] = {"t": 0}
        if self.momentum > 0:
            s["velocity"] = [torch.zeros_like(p) for p in params]
        return s

    def current_lr(self, state, epoch=0) -> float:
        return self.schedule(self.learning_rate, state["t"], epoch)

    @torch.no_grad()
    def apply(self, grads, params, state, lr):
        for i, (g, p) in enumerate(zip(grads, params)):
            if self.weight_decay > 0:
                g = g + self.weight_decay * p
            if self.momentum > 0:
                vel = state["velocity"][i]
                vel.mul_(self.momentum).add_((1 - self.dampening) * g)
                g = g + self.momentum * vel if self.nesterov else vel
            p.sub_(lr * g)
