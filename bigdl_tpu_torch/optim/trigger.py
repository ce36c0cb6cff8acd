"""Composable triggers for stop/validation/checkpoint conditions: the
port's own copy of ``bigdl_tpu/optim/trigger.py`` (which imports no JAX,
but the port imports nothing of ``bigdl_tpu``).

Reference: optim/Trigger.scala (maxEpoch, maxIteration, everyEpoch,
severalIteration, maxScore, minLoss, and/or combinators).

A trigger is called with the driver state dict (host-side python scalars:
``epoch``, ``neval`` (iteration), ``loss``, ``score``, ``is_epoch_end``).
"""

from __future__ import annotations

from typing import Dict

__all__ = ["Trigger"]


class Trigger:
    def __init__(self, fn, name="trigger", needs_loss=False):
        self._fn = fn
        self.name = name
        # True when the trigger reads state["loss"]: tells the Optimizer
        # it must fetch the loss every iteration (otherwise readback is
        # batched asynchronously to keep the device queue full)
        self.needs_loss = needs_loss

    def __call__(self, state: Dict) -> bool:
        return bool(self._fn(state))

    # ---- factories (reference Trigger.scala object methods) ----

    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        return Trigger(lambda s: s.get("epoch", 0) > n, f"maxEpoch({n})")

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s.get("neval", 0) > n, f"maxIteration({n})")

    @staticmethod
    def every_epoch() -> "Trigger":
        return Trigger(lambda s: s.get("is_epoch_end", False), "everyEpoch")

    @staticmethod
    def several_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s.get("neval", 0) % n == 0,
                       f"severalIteration({n})")

    @staticmethod
    def max_score(threshold: float) -> "Trigger":
        return Trigger(lambda s: s.get("score", float("-inf")) > threshold,
                       f"maxScore({threshold})")

    @staticmethod
    def min_loss(threshold: float) -> "Trigger":
        return Trigger(lambda s: s.get("loss", float("inf")) < threshold,
                       f"minLoss({threshold})", needs_loss=True)

    @staticmethod
    def and_(*triggers: "Trigger") -> "Trigger":
        # getattr: plain callables are accepted wherever Triggers are
        return Trigger(lambda s: all(t(s) for t in triggers), "and",
                       needs_loss=any(getattr(t, "needs_loss", False)
                                      for t in triggers))

    @staticmethod
    def or_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: any(t(s) for t in triggers), "or",
                       needs_loss=any(getattr(t, "needs_loss", False)
                                      for t in triggers))
