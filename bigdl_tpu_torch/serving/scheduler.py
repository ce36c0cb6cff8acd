"""Batch scheduler: max-wait deadline and FIFO fairness (counterpart of
``bigdl_tpu/serving/scheduler.py``).

One daemon thread owns dispatch.  It blocks for the oldest queued
request, then admits arrivals into the forming batch until the batch
holds ``max_batch`` or ``batch_timeout_ms`` has passed since it opened:
a lone request never waits more than the deadline, and a burst fills a
bucket and shares one forward.  FIFO fairness follows from the queue:
requests are popped in arrival order and a batch is closed before the
next one opens, so no request is overtaken by a later one
(``shed_oldest`` admission fails the oldest queued request; it never
reorders).

The reference's request-path spans (enqueue, batch, execute, reply) are
left out: its tracing is not ported (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional, Sequence

from bigdl_tpu_torch.serving.admission import BoundedRequestQueue, Request
from bigdl_tpu_torch.serving.batching import (
    pick_bucket, split_outputs, stack_requests,
)
from bigdl_tpu_torch.serving.metrics import MetricsRegistry

__all__ = ["BatchScheduler"]

logger = logging.getLogger(__name__)


class BatchScheduler:
    """Drains a :class:`BoundedRequestQueue` into bucketed runs of
    ``execute_fn(batched_input) -> batched_output`` (the input's leading
    axis already padded to the bucket)."""

    def __init__(self, queue: BoundedRequestQueue,
                 execute_fn: Callable,
                 buckets: Sequence[int],
                 batch_timeout_ms: float,
                 metrics: Optional[MetricsRegistry] = None):
        self._queue = queue
        self._execute = execute_fn
        self._buckets = tuple(buckets)
        self._max_batch = self._buckets[-1]
        self._timeout_s = max(batch_timeout_ms, 0.0) / 1e3
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "BatchScheduler":
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._thread = threading.Thread(
            target=self._run, name="bigdl-serving-scheduler", daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the dispatch thread to exit (it exits once the queue
        is closed AND drained; closing is the caller's job)."""
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ---- the dispatch loop ----------------------------------------------

    def _gather(self, first: Request) -> List[Request]:
        """One batch: the opener plus arrivals until full or the max-wait
        deadline expires."""
        batch = [first]
        deadline = time.perf_counter() + self._timeout_s
        while len(batch) < self._max_batch:
            batch.extend(self._queue.get_nowait_up_to(
                self._max_batch - len(batch)))
            if len(batch) >= self._max_batch:
                break
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            nxt = self._queue.get(timeout=remaining)
            if nxt is None:       # deadline hit (or queue closed and empty)
                break
            batch.append(nxt)
        return batch

    def _dispatch(self, batch: List[Request]) -> None:
        # PENDING -> RUNNING: a future cancelled while queued drops out
        # here, and cannot be cancelled afterwards, so set_result below
        # never races a cancel (InvalidStateError would kill this thread)
        batch = [r for r in batch
                 if r.future.set_running_or_notify_cancel()]
        if not batch:
            return
        n = len(batch)
        bucket = pick_bucket(n, self._buckets)
        depth = len(self._queue)
        try:
            x = stack_requests([r.sample for r in batch], bucket)
            rows = split_outputs(self._execute(x), n)
        except Exception as e:
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            logger.exception("serving batch of %d failed", n)
            return
        done = time.perf_counter()
        lats = []
        for r, row in zip(batch, rows):
            lats.append(done - r.t_enqueue)
            r.future.set_result(row)
        self.metrics.record_batch(n_real=n, bucket=bucket,
                                  queue_depth=depth, latencies_s=lats)

    def _run(self) -> None:
        while True:
            first = self._queue.get(timeout=None)
            if first is None:     # closed and fully drained
                return
            self._dispatch(self._gather(first))
