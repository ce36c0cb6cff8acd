"""Concurrent pipeline stages: background prefetch and a thread-pool map
(counterpart of ``bigdl_tpu/dataset/prefetch.py``, without its telemetry
gauges: ROADMAP.md queue 1, item 10).

Host threads overlap decoding and augmenting on the host with the step
on the device; the heavy per-sample work (an image decode, a numpy
resize) releases the interpreter lock.  Usage::

    ds = (DataSet.array(paths)
          .transform(ParallelMap(decode_and_augment, workers=8))
          .transform(SampleToMiniBatch(bs))
          .transform(Prefetch(n_ahead=2)))

``Prefetch`` goes LAST, so that ready minibatches queue up while the
step runs.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = ["Prefetch", "ParallelMap"]

_STOP = object()


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetch(Transformer):
    """Run the upstream iterator in a daemon thread, handing items over a
    bounded queue.  ``n_ahead`` bounds the items buffered beyond the one
    being consumed.  An upstream exception re-raises at the consumer's
    next ``__next__``; dropping the iterator early stops the producer
    (it sees the stop flag between its timed puts)."""

    def __init__(self, n_ahead: int = 2):
        if n_ahead < 1:
            raise ValueError("Prefetch needs n_ahead >= 1")
        self.n_ahead = n_ahead

    def apply(self, it: Iterator) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.n_ahead)
        stop = threading.Event()

        def put_checked(item) -> bool:
            """A blocking put that gives up once the consumer is gone;
            True if the item was enqueued."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in it:
                    if not put_checked(item):
                        return
                put_checked(_STOP)
            except BaseException as e:  # noqa: BLE001 (relayed)
                put_checked(_Failure(e))

        def consume():
            # the producer starts inside the generator: a generator never
            # advanced never runs its finally, so a thread started eagerly
            # could never be told to stop
            threading.Thread(target=produce, daemon=True).start()
            try:
                while True:
                    item = q.get()
                    if item is _STOP:
                        return
                    if isinstance(item, _Failure):
                        raise item.exc
                    yield item
            finally:
                stop.set()

        return consume()


class ParallelMap(Transformer):
    """Order-preserving thread-pool map of ``fn`` over the stream (the
    reference's multithreaded ``MT*`` transformers): ``fn`` runs on
    ``workers`` threads, results come in input order, and at most
    ``workers * (1 + queue_factor)`` items are in flight."""

    def __init__(self, fn: Callable, workers: int = 4,
                 queue_factor: int = 2):
        if workers < 1:
            raise ValueError("ParallelMap needs workers >= 1")
        self.fn = fn
        self.workers = workers
        self.in_flight = workers * (1 + queue_factor)

    def apply(self, it: Iterator) -> Iterator:
        from concurrent.futures import ThreadPoolExecutor

        def run():
            pending: "queue.SimpleQueue" = queue.SimpleQueue()
            pool = ThreadPoolExecutor(self.workers)
            try:
                n = 0
                for item in it:
                    pending.put(pool.submit(self.fn, item))
                    n += 1
                    if n >= self.in_flight:
                        yield pending.get().result()
                        n -= 1
                while n:
                    yield pending.get().result()
                    n -= 1
            finally:
                # an early close or an exception drops the queued work
                pool.shutdown(wait=False, cancel_futures=True)

        return run()
