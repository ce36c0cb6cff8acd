"""Device prefetch: the host-to-device copy of batch N+1 overlapped with
step N (counterpart of ``bigdl_tpu/data/device_prefetch.py``).

Without it the Optimizer copies each host batch to the card between
steps (``.to(device)`` from pageable memory), and that copy waits behind
the queued step: the card idles while the host copies, then launches
again.  ``DevicePrefetch`` is a terminal pipeline stage whose producer
thread copies ahead of the loop: each host tensor is pinned (PyTorch's
caching host allocator hands a pinned block back only after the copies
that read it are done, so the blocks are reused, not pinned afresh) and
copied with ``non_blocking=True`` on a copy stream of the producer's own,
followed by an event.  The consumer makes its current stream wait on
that event and records the stream on every tensor it takes, so the
caching allocator does not hand a batch's block back to the copy stream
while the step still reads it.  Tensors already on the device pass
through, as the Optimizer's own staging lets them (a
``DeviceCachedDataSet`` is not copied again).

Off by default: ``Optimizer.set_device_prefetch(n_ahead)`` wraps each
epoch's iterator in one, on the model's device.  ``n_ahead`` batches sit
on the device ahead of the one the step reads.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List

import torch

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.dataset.dataset import MiniBatch
from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = ["DevicePrefetch"]

_STOP = object()


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _staged(value, device, copied: List[torch.Tensor]):
    """``value`` (an array, a tensor or a tuple or list of them) on
    ``device``; host tensors are pinned and copied without blocking and
    appended to ``copied``."""
    if value is None:
        return None
    if isinstance(value, (tuple, list)):
        return type(value)(_staged(v, device, copied) for v in value)
    t = torch.as_tensor(value)
    if t.device.type == device.type:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory().to(device, non_blocking=True)
        copied.append(t)
        return t
    return t.to(device)


class _DevicePrefetchIter:
    """The running prefetcher: a daemon producer staging upstream items
    onto the device over a bounded queue.  ``staged_total`` and
    ``occupancy()`` show that batch N+1 is on the device while the
    consumer still holds batch N."""

    def __init__(self, it: Iterator, device: torch.device, n_ahead: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(n_ahead), 1))
        self._stop = threading.Event()
        self._done = False
        # the producer's copy stream (None on the CPU)
        self.copy_stream = None
        if device.type == "cuda" and device.index is None:
            # the producer's current device is set from this thread's
            device = torch.device("cuda", torch.cuda.current_device())
        self._device = device
        self.staged_total = 0

        def produce():
            stream = None
            if device.type == "cuda":
                # the current device is the thread's own
                torch.cuda.set_device(device)
                stream = self.copy_stream = torch.cuda.Stream(device)
            try:
                for item in it:
                    copied: List[torch.Tensor] = []
                    if stream is None:
                        staged = self._stage(item, copied)
                        event = None
                    else:
                        with torch.cuda.stream(stream):
                            staged = self._stage(item, copied)
                            event = torch.cuda.Event()
                            event.record(stream)
                    self.staged_total += 1
                    if not self._put((staged, event, copied)):
                        return
                self._put(_STOP)
            except BaseException as e:  # noqa: BLE001 (relayed)
                self._put(_Failure(e))

        self._thread = threading.Thread(
            target=produce, daemon=True, name="bigdl-device-prefetch")
        self._thread.start()

    def _stage(self, item, copied):
        if isinstance(item, MiniBatch):
            return MiniBatch(_staged(item.get_input(), self._device, copied),
                             _staged(item.get_target(), self._device,
                                     copied))
        return _staged(item, self._device, copied)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def occupancy(self) -> int:
        """Batches on the device buffered ahead of the consumer."""
        return self._q.qsize()

    def close(self) -> None:
        """Stop the producer and wait for it, 10 s at most (blocked on
        the queue, it sees the flag within 0.1 s)."""
        self._stop.set()
        self._thread.join(10.0)

    def __iter__(self) -> "_DevicePrefetchIter":
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _STOP:
            self._done = True
            self._stop.set()
            raise StopIteration
        if isinstance(item, _Failure):
            self._done = True
            self._stop.set()
            raise item.exc
        staged, event, copied = item
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in copied:
                t.record_stream(current)
        return staged


class DevicePrefetch(Transformer):
    """A terminal stage that stages batches onto ``device`` ahead of
    their consumption (see the module's docstring); ``device`` defaults
    to the card."""

    def __init__(self, n_ahead: int = 1, device=None):
        if n_ahead < 1:
            raise ValueError("DevicePrefetch needs n_ahead >= 1")
        self.n_ahead = int(n_ahead)
        self.device = resolve_device(device)

    def apply(self, it: Iterator) -> _DevicePrefetchIter:
        return _DevicePrefetchIter(iter(it), self.device, self.n_ahead)
