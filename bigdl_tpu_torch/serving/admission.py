"""Admission control: a bounded request queue with an overload policy
(counterpart of ``bigdl_tpu/serving/admission.py``).

* ``block``       — backpressure: ``put`` waits for queue space;
* ``reject``      — fail fast with :class:`QueueFullError`;
* ``shed_oldest`` — admit the new request and fail the oldest queued one
                    with :class:`RequestSheddedError`.

Queued items are duck-typed: anything with a ``future`` (a
``concurrent.futures.Future``) and a ``t_enqueue`` stamp.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Deque, List, Optional

__all__ = ["QueueFullError", "RequestSheddedError", "ServerClosedError",
           "BoundedRequestQueue", "POLICIES"]

POLICIES = ("block", "reject", "shed_oldest")


class QueueFullError(RuntimeError):
    """Raised to the submitter under the ``reject`` policy."""


class RequestSheddedError(RuntimeError):
    """Set on a queued request's future under ``shed_oldest``."""


class ServerClosedError(RuntimeError):
    """Submit after shutdown, or shutdown discarded the queued request."""


def _fail_future(fut: Future, exc: Exception) -> None:
    """Fail a queued future unless the caller already cancelled it (a
    cancelled future raises InvalidStateError on set_exception)."""
    if fut.set_running_or_notify_cancel():
        fut.set_exception(exc)


class BoundedRequestQueue:
    """FIFO queue with a hard capacity and a configurable full-queue
    policy.  All methods are thread-safe."""

    def __init__(self, capacity: int, policy: str = "block",
                 on_shed=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy not in POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r}; pick from {POLICIES}")
        self.capacity = capacity
        self.policy = policy
        self._on_shed = on_shed
        self._q: Deque = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    # ---- producer side ---------------------------------------------------

    def put(self, req, timeout: Optional[float] = None) -> None:
        """Admit ``req`` under the configured policy.  ``timeout`` only
        applies to ``block`` (None = wait forever)."""
        shed = None
        with self._lock:
            if self._closed:
                raise ServerClosedError("server is shut down")
            if len(self._q) >= self.capacity:
                if self.policy == "reject":
                    raise QueueFullError(
                        f"request queue at capacity ({self.capacity})")
                if self.policy == "shed_oldest":
                    shed = self._q.popleft()
                else:  # block
                    deadline = (None if timeout is None
                                else time.perf_counter() + timeout)
                    while len(self._q) >= self.capacity and not self._closed:
                        remaining = (None if deadline is None
                                     else deadline - time.perf_counter())
                        if remaining is not None and remaining <= 0:
                            raise QueueFullError(
                                f"request queue still at capacity "
                                f"({self.capacity}) after {timeout}s")
                        self._not_full.wait(remaining)
                    if self._closed:
                        raise ServerClosedError("server is shut down")
            self._q.append(req)
            self._not_empty.notify()
        if shed is not None:
            # complete the victim outside the lock: its waiter may run
            # callbacks inline on set_exception
            _fail_future(shed.future, RequestSheddedError(
                "request shed by a newer arrival under shed_oldest"))
            if self._on_shed is not None:
                self._on_shed()

    # ---- consumer side (the scheduler thread) ----------------------------

    def get(self, timeout: Optional[float] = None):
        """Pop the oldest request, waiting up to ``timeout``.  Returns
        None on timeout or when closed and drained."""
        with self._lock:
            deadline = (None if timeout is None
                        else time.perf_counter() + timeout)
            while not self._q:
                if self._closed:
                    return None
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    return None
                self._not_empty.wait(remaining)
            req = self._q.popleft()
            self._not_full.notify()
            return req

    def get_nowait_up_to(self, n: int) -> List:
        """Drain up to ``n`` queued requests without blocking."""
        out: List = []
        with self._lock:
            while self._q and len(out) < n:
                out.append(self._q.popleft())
            if out:
                self._not_full.notify_all()
        return out

    # ---- shutdown --------------------------------------------------------

    def close(self, discard: bool = False) -> List:
        """Stop admitting.  With ``discard`` the queued requests are
        returned after failing their futures; otherwise they stay queued
        for the scheduler to drain."""
        with self._lock:
            self._closed = True
            dropped = list(self._q) if discard else []
            if discard:
                self._q.clear()
            self._not_empty.notify_all()
            self._not_full.notify_all()
        for req in dropped:
            _fail_future(req.future, ServerClosedError(
                "server shut down before this request was served"))
        return dropped

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed
