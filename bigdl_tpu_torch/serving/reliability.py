"""The request-reliability types the generation engine names
(counterpart of part of ``bigdl_tpu/serving/reliability.py``).

A :class:`Deadline` rides a request through queue wait, prefill and
decode; whoever notices it expired fails the request with the typed,
stage-stamped :class:`DeadlineExceededError`.  The circuit breaker and
the retry and hedge policies belong to the serving fabric (ROADMAP
queue 1, item 12); the deadline counter belongs to telemetry (item 10).
"""

from __future__ import annotations

import time
from typing import Optional

__all__ = ["Deadline", "DeadlineExceededError", "RequestCancelledError",
           "ReplicaDeadError", "deadline_error"]


class DeadlineExceededError(RuntimeError):
    """The request's end-to-end budget ran out at ``stage`` (one of
    ``queue`` / ``prefill`` / ``decode``): a typed rejection, so the
    caller can tell "the system said no in time" from "the system
    failed"."""

    def __init__(self, msg: str, stage: str = "queue",
                 trace_id: Optional[str] = None):
        super().__init__(msg)
        self.stage = stage
        self.trace_id = trace_id


class RequestCancelledError(RuntimeError):
    """The caller abandoned the request (client-side timeout or an
    explicit cancel) and the engine freed its slot mid-flight."""


class ReplicaDeadError(RuntimeError):
    """The replica died hard mid-flight: every resident request failed
    without draining."""


def deadline_error(stage: str, budget_s: float, elapsed_s: float,
                   trace_id: Optional[str] = None) \
        -> DeadlineExceededError:
    """The typed error for a budget that ran out at ``stage``."""
    return DeadlineExceededError(
        f"deadline exceeded at {stage}: {elapsed_s:.3f}s elapsed of a "
        f"{budget_s:.3f}s budget", stage=stage, trace_id=trace_id)


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

    def error(self, stage: str, now: Optional[float] = None,
              trace_id: Optional[str] = None) -> DeadlineExceededError:
        return deadline_error(stage, self.budget_s, self.elapsed(now),
                              trace_id=trace_id)

    def __repr__(self) -> str:
        return (f"Deadline(budget_s={self.budget_s}, "
                f"remaining={self.remaining():.3f})")
