"""The request-reliability types the generation engine names
(counterpart of part of ``bigdl_tpu/serving/reliability.py``).

The port's engine does not enforce deadlines yet: a request that carries
a :class:`Deadline` is refused with NotImplementedError, never served
with the deadline ignored.
"""

from __future__ import annotations

import time
from typing import Optional

__all__ = ["Deadline", "RequestCancelledError", "ReplicaDeadError"]


class RequestCancelledError(RuntimeError):
    """The caller abandoned the request (client-side timeout or an
    explicit cancel) and the engine freed its slot mid-flight."""


class ReplicaDeadError(RuntimeError):
    """The replica died hard mid-flight: every resident request failed
    without draining."""


class Deadline:
    """One request's end-to-end budget, minted at admission, against
    ``time.perf_counter()``; every check takes an optional ``now``."""

    __slots__ = ("budget_s", "t_start")

    def __init__(self, budget_s: float, now: Optional[float] = None):
        self.budget_s = float(budget_s)
        if self.budget_s <= 0:
            raise ValueError(
                f"deadline budget must be > 0, got {budget_s}")
        self.t_start = time.perf_counter() if now is None else float(now)

    def elapsed(self, now: Optional[float] = None) -> float:
        return (time.perf_counter() if now is None else now) \
            - self.t_start

    def remaining(self, now: Optional[float] = None) -> float:
        return self.budget_s - self.elapsed(now)

    def expired(self, now: Optional[float] = None) -> bool:
        return self.remaining(now) <= 0.0
