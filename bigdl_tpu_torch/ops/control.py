"""Control-flow modules (counterpart of ``bigdl_tpu/ops/control.py``):
branches and loops over modules, differentiable through the branch or the
steps taken.

The reference compiles these into the step as ``lax.cond`` /
``lax.while_loop`` / ``lax.scan``, with the predicate on the device.  Here
they are Python control flow: :class:`Cond` and :class:`WhileLoop` read a
tensor predicate on the host (a Python bool is taken as it is), and
:class:`Scan` and :class:`TensorArrayScan` are loops over the time axis.
A host read cannot be captured in a CUDA graph (the ``Optimizer``'s
dispatch windows): under a capture a tensor predicate raises rather than
replay the branch the capture took.  The scans read nothing on the host
and capture as they are.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from bigdl_tpu_torch.core.module import Module

__all__ = ["Cond", "WhileLoop", "Scan", "TensorArrayScan"]


def capturing() -> bool:
    """Is a CUDA graph capture running on the current stream?"""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _host_bool(pred, what: str) -> bool:
    """``pred`` (a bool, or a one-element tensor or array) as a Python
    bool; a tensor raises under a CUDA graph capture."""
    if torch.is_tensor(pred):
        if capturing():
            raise RuntimeError(
                f"{what} reads its predicate on the host, which a CUDA "
                "graph capture cannot record (the replay would take the "
                "captured branch whatever the predicate): run the step "
                "eagerly (set_iterations_per_dispatch(1)) or give the "
                "predicate as a Python bool")
        return bool(pred.reshape(()))
    return bool(torch.as_tensor(pred).reshape(()))


class Cond(Module):
    """``forward((pred, x))`` → ``true_branch(x)`` if pred else
    ``false_branch(x)``; only the branch taken runs (reference
    nn/tf/ControlOps.scala's Switch/Merge pair)."""

    def __init__(self, true_branch: Module, false_branch: Module):
        super().__init__()
        self.true_branch = true_branch
        self.false_branch = false_branch

    def forward(self, inputs):
        pred, x = inputs
        branch = self.true_branch if _host_bool(pred, "Cond") \
            else self.false_branch
        return branch(x)


class WhileLoop(Module):
    """``forward(state)`` applies ``body`` while ``cond_fn(state)`` holds
    (reference ControlOps' Enter/NextIteration/Exit frames).  With
    ``max_iterations`` the loop also stops after that many steps, the
    reference's loop guard."""

    def __init__(self, cond_fn: Callable, body: Module,
                 max_iterations: Optional[int] = None):
        super().__init__()
        self.cond_fn = cond_fn
        self.body = body
        self.max_iterations = max_iterations

    def forward(self, state):
        i = 0
        while ((self.max_iterations is None or i < self.max_iterations)
               and _host_bool(self.cond_fn(state), "WhileLoop")):
            state = self.body(state)
            i += 1
        return state


class Scan(Module):
    """``forward((state0, xs))`` → ``(stateN, ys)``, where ``body((state,
    x_t))`` → ``(state', y_t)`` over the ``time_axis`` of ``xs`` and the
    ``y_t`` are stacked along it."""

    def __init__(self, body: Module, time_axis: int = 1):
        super().__init__()
        self.body = body
        self.time_axis = time_axis

    def forward(self, inputs):
        state, xs = inputs
        ys = []
        for x_t in torch.unbind(xs, self.time_axis):
            state, y = self.body((state, x_t))
            ys.append(y)
        return state, torch.stack(ys, self.time_axis)


class TensorArrayScan(Module):
    """``body`` on each step of ``xs``'s ``time_axis``, the results
    stacked along it (reference nn/tf/DataFlowOps.scala's TensorArray:
    write inside a loop, stack at the exit)."""

    def __init__(self, body: Module, time_axis: int = 1):
        super().__init__()
        self.body = body
        self.time_axis = time_axis

    def forward(self, xs):
        return torch.stack([self.body(x_t) for x_t in
                            torch.unbind(xs, self.time_axis)],
                           self.time_axis)
