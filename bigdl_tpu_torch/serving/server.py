"""ModelServer: the serving front end (counterpart of
``bigdl_tpu/serving/server.py``).

Two planes behind one object, either or both:

* one-shot inference, ``backend=``: admission control, then the batch
  scheduler coalescing single-sample requests into padded buckets, then
  the backend; with bucket warmup, metrics and drain on shutdown.  A
  backend is anything that runs a padded batch: a ``torch.nn.Module``
  (cloned to eval mode on the server's device through
  ``optim.predictor.jit_forward``, the output read back to the host), a
  :class:`~bigdl_tpu_torch.optim.predictor.PredictionService` (its
  ticketed ``predict``) or any callable ``f(batched_input) ->
  batched_output``;
* generation, ``generator=``: a TransformerLM or a pre-built
  :class:`GenerationScheduler` behind the continuous-batching engine.

A module or a generation scheduler on another device than the server's
is refused, not moved.  A backend's error fails the requests of its
batch; the server never carries on through another path.
"""

from __future__ import annotations

import logging
import operator
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device, same_device
from bigdl_tpu_torch.serving.admission import (
    BoundedRequestQueue, QueueFullError, Request, ServerClosedError,
)
from bigdl_tpu_torch.serving.batching import bucket_sizes
from bigdl_tpu_torch.serving.metrics import MetricsRegistry
from bigdl_tpu_torch.serving.scheduler import BatchScheduler

__all__ = ["ModelServer", "install_shutdown_signals"]

logger = logging.getLogger(__name__)


def install_shutdown_signals(server: "ModelServer",
                             signals: Optional[Sequence[int]] = None):
    """SIGTERM/SIGINT → a graceful drain: the handler raises
    KeyboardInterrupt in the main thread, so blocking loops unwind into
    the caller's ``shutdown(drain=True)`` and every admitted request is
    still served.  The handler does not mark the server shut down itself
    (that would turn the caller's drain into a no-op).  Returns a
    ``restore()`` that puts the previous handlers back; off the main
    thread, where ``signal.signal`` is illegal, a no-op."""
    import signal as _signal
    if threading.current_thread() is not threading.main_thread():
        return lambda: None
    sigs = tuple(signals) if signals is not None \
        else (_signal.SIGTERM, _signal.SIGINT)
    prev = {}

    def handler(signum, frame):
        # no queue peek: taking the queue's lock in signal context could
        # deadlock against an interrupted put() holding it
        logger.info("signal %s: unwinding to drain queued requests "
                    "before exit", signum)
        raise KeyboardInterrupt

    for s in sigs:
        try:
            prev[s] = _signal.signal(s, handler)
        except (ValueError, OSError):  # pragma: no cover - exotic host
            continue

    def restore():
        for s, h in prev.items():
            try:
                _signal.signal(s, h)
            except (ValueError, OSError):  # pragma: no cover
                pass
    return restore


def _module_backend(model: nn.Module, device) -> Callable:
    """The shared eval-mode forward (``jit_forward``) with serving's own
    host conversion: tuple outputs, and a blocking readback, so that a
    request's latency covers the device's work."""
    from bigdl_tpu_torch.optim.predictor import _to_host, jit_forward
    model, fn = jit_forward(model, device)

    def run(x):
        return _to_host(fn(model, x))
    return run


def _resolve_backend(backend, device) -> Callable:
    from bigdl_tpu_torch.optim.predictor import PredictionService
    if isinstance(backend, nn.Module):
        return _module_backend(backend, device)
    if isinstance(backend, PredictionService):
        if not same_device(backend.device, device):
            raise ValueError(f"the prediction service runs on "
                             f"{backend.device}, the server on {device}")
        return backend.predict
    if callable(backend):
        return backend
    raise TypeError(f"cannot serve a {type(backend).__name__}: expected a "
                    "torch.nn.Module, PredictionService, or callable")


class ModelServer:
    """Dynamic-batching inference server and continuous-batching
    generation server.

    >>> server = ModelServer(model, max_batch=16, batch_timeout_ms=3.0)
    >>> server.warmup(np.zeros((784,), np.float32))
    >>> y = server.submit(x)                  # blocking, single sample
    >>> ys = server.submit_many(list_of_x)    # a burst, in order
    >>> server.shutdown()                     # drains the queue
    """

    def __init__(self, backend=None, max_batch: int = 32,
                 batch_timeout_ms: float = 5.0,
                 queue_capacity: Optional[int] = None,
                 admission: str = "block",
                 metrics: Optional[MetricsRegistry] = None, *,
                 generator=None, slots: int = 8,
                 gen_queue_capacity: Optional[int] = None, device=None):
        """``backend`` serves one-shot (single-forward) requests through
        the dynamic batcher; ``generator`` serves generation requests
        through the slot pool (``slots`` wide).  Either may be omitted,
        not both.  Both run on ``device`` (default ``cuda``)."""
        if backend is None and generator is None:
            raise TypeError(
                "ModelServer needs a backend (one-shot inference), a "
                "generator (continuous-batching generation), or both")
        dev = resolve_device(device)
        self.device = dev
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # admitted one-shot requests not yet terminal; the generation
        # plane keeps its own count, and admitted_outstanding() is both
        self._outstanding_lock = threading.Lock()
        self._outstanding = 0
        self._run_batch = None
        self._scheduler = None
        self._queue = None
        self.buckets = ()
        self.max_batch = max_batch
        if backend is not None:
            self._run_batch = _resolve_backend(backend, dev)
            self.buckets = bucket_sizes(max_batch)
            cap = (queue_capacity if queue_capacity is not None
                   else 8 * max_batch)
            self._queue = BoundedRequestQueue(
                cap, policy=admission, on_shed=self.metrics.record_shed)
            self._scheduler = BatchScheduler(
                self._queue, self._run_batch, self.buckets,
                batch_timeout_ms, metrics=self.metrics)
            self._scheduler.start()
        self.generation = None
        if generator is not None:
            try:
                from bigdl_tpu_torch.serving.generation import \
                    GenerationScheduler
                if isinstance(generator, GenerationScheduler):
                    if not same_device(generator.pool.device, dev):
                        raise ValueError(
                            f"the generation scheduler runs on "
                            f"{generator.pool.device}, the server on {dev}")
                    self.generation = generator
                else:
                    self.generation = GenerationScheduler(
                        generator, slots=slots,
                        queue_capacity=gen_queue_capacity,
                        admission=admission, device=dev)
            except BaseException:
                # the one-shot scheduler thread is already running: a
                # failed generator wiring must not leak it (and its queue)
                # with no handle to shut it down
                if self._queue is not None:
                    self._queue.close(discard=True)
                if self._scheduler is not None:
                    self._scheduler.join(5.0)
                raise
        self._shutdown = False

    # ---- one-shot submission ---------------------------------------------

    def submit_async(self, sample,
                     timeout: Optional[float] = None) -> Future:
        """Admit one sample (an array, or a tuple of arrays, WITHOUT a
        batch axis); returns a Future of its output row.  Raises
        QueueFullError / ServerClosedError per the admission policy;
        ``timeout`` bounds the admission wait under ``block``."""
        if self._shutdown:
            raise ServerClosedError("server is shut down")
        if self._queue is None:
            raise RuntimeError(
                "this server has no one-shot backend (generation-only); "
                "use submit_generate / submit_generate_async")
        req = Request(sample)
        with self._outstanding_lock:
            self._outstanding += 1
        try:
            self._queue.put(req, timeout=timeout)
        except QueueFullError:
            with self._outstanding_lock:
                self._outstanding -= 1
            self.metrics.record_rejected()
            raise
        except BaseException:
            with self._outstanding_lock:
                self._outstanding -= 1
            raise
        req.future.add_done_callback(self._dec_outstanding)
        return req.future

    def _dec_outstanding(self, _fut) -> None:
        with self._outstanding_lock:
            self._outstanding -= 1

    def admitted_outstanding(self) -> int:
        """Admitted requests not yet terminal on BOTH planes (one-shot
        queued or running, generation queued, prefilling or decoding); a
        drained server reaches exactly zero."""
        with self._outstanding_lock:
            n = self._outstanding
        if self.generation is not None:
            n += self.generation.admitted_outstanding()
        return n

    def submit(self, sample, timeout: Optional[float] = None):
        """Blocking single-sample inference, coalesced with concurrent
        callers into one batch; ``timeout`` covers admission AND the
        result wait."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        fut = self.submit_async(sample, timeout=timeout)
        remaining = (None if deadline is None
                     else max(deadline - time.perf_counter(), 0.0))
        return fut.result(remaining)

    def submit_many(self, samples: Sequence,
                    timeout: Optional[float] = None) -> List:
        """Submit a burst and wait for every result, in order.  All
        samples are enqueued before the first wait, so a burst from one
        caller coalesces as concurrent callers do."""
        futures = [self.submit_async(s) for s in samples]
        return self._results(futures, timeout)

    @staticmethod
    def _results(futures: List[Future], timeout: Optional[float]) -> List:
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        out = []
        for f in futures:
            remaining = (None if deadline is None
                         else max(deadline - time.perf_counter(), 0.0))
            out.append(f.result(remaining))
        return out

    # ---- generation (continuous batching) --------------------------------

    def _gen(self):
        if self.generation is None:
            raise RuntimeError(
                "this server has no generation backend; construct with "
                "generator=<TransformerLM or GenerationScheduler>")
        if self._shutdown:
            raise ServerClosedError("server is shut down")
        return self.generation

    def submit_generate_async(self, prompt, max_new_tokens: int,
                              eos_id=None, on_token=None,
                              timeout: Optional[float] = None,
                              deadline=None, trace=None) -> Future:
        """Admit one prompt; returns a Future of the full
        ``[Tp + max_new_tokens]`` token row (greedy, equal to a solo
        ``model.generate()``).  The request holds a KV slot for many
        decode iterations, and a drain waits for its last token.
        ``deadline`` (a :class:`Deadline`) fails it typed once expired;
        ``trace`` is not ported (NotImplementedError)."""
        return self._gen().submit_async(
            prompt, max_new_tokens, eos_id=eos_id, on_token=on_token,
            timeout=timeout, deadline=deadline, trace=trace)

    def cancel_generate(self, fut: Future) -> bool:
        """Best-effort cancel of a generation future."""
        return self._gen().cancel(fut)

    cancel = cancel_generate

    def kill(self, exc: Optional[Exception] = None) -> None:
        """Kill the generation engine (no drain): slot-resident requests
        fail with ``exc`` (default ReplicaDeadError), queued ones with
        ServerClosedError."""
        if self.generation is not None:
            self.generation.kill(exc)

    def submit_generate(self, prompt, max_new_tokens: int, eos_id=None,
                        timeout: Optional[float] = None):
        """Blocking single-prompt generation; ``timeout`` covers
        admission and the full decode."""
        return self._gen().submit(prompt, max_new_tokens, eos_id=eos_id,
                                  timeout=timeout)

    def submit_generate_many(self, prompts: Sequence, max_new_tokens,
                             eos_id=None,
                             timeout: Optional[float] = None) -> List:
        """Submit a burst and wait for every row, in order.
        ``max_new_tokens`` is one int or one budget per prompt.  All
        prompts are enqueued before the first wait, so a burst fills the
        slot pool like concurrent callers."""
        try:
            max_new_tokens = [operator.index(max_new_tokens)] * len(prompts)
        except TypeError:
            max_new_tokens = list(max_new_tokens)
            if len(max_new_tokens) != len(prompts):
                raise ValueError(
                    f"{len(prompts)} prompts but {len(max_new_tokens)} "
                    f"max_new_tokens entries; pass one budget per prompt "
                    f"(or a single int)")
        futures = [self.submit_generate_async(p, m, eos_id=eos_id)
                   for p, m in zip(prompts, max_new_tokens)]
        return self._results(futures, timeout)

    def generation_queue_depth(self) -> int:
        return 0 if self.generation is None \
            else self.generation.queue_depth()

    def generation_stats(self):
        return None if self.generation is None \
            else self.generation.stats()

    # ---- lifecycle -------------------------------------------------------

    def warmup(self, example_sample) -> "ModelServer":
        """Run a zeros batch of every bucket through the backend, largest
        first (the reference compiles each shape here; the port builds
        the kernels and sets up the libraries' workspaces).  The request
        metrics are untouched."""
        if self._run_batch is None:
            raise RuntimeError("warmup needs a one-shot backend; the "
                               "generation engine warms per bucket on "
                               "first use")
        ex = example_sample
        tuple_input = isinstance(ex, (tuple, list))
        parts = (tuple(np.asarray(a) for a in ex) if tuple_input
                 else (np.asarray(ex),))
        t0 = time.perf_counter()
        for b in reversed(self.buckets):
            zeros = tuple(np.zeros((b,) + p.shape, p.dtype) for p in parts)
            self._run_batch(zeros if tuple_input else zeros[0])
        logger.info("warmup: ran %d bucket shapes %s in %.2fs",
                    len(self.buckets), list(self.buckets),
                    time.perf_counter() - t0)
        return self

    def queue_depth(self) -> int:
        return 0 if self._queue is None else len(self._queue)

    def publish_metrics(self, summary, step: int = 0) -> None:
        """Export the metrics snapshot through a visualization summary
        (not ported: :meth:`MetricsRegistry.publish` raises)."""
        self.metrics.publish(summary, step)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 30.0) -> None:
        """Stop admitting.  With ``drain`` (default) every queued one-shot
        request is still served before the dispatch thread exits, and
        every admitted generation request is generated to its last
        token; otherwise queued requests fail with ServerClosedError
        (slot-resident generations always finish)."""
        if self._shutdown:
            return
        self._shutdown = True
        if self._queue is not None:
            self._queue.close(discard=not drain)
        if self.generation is not None:
            self.generation.shutdown(drain=drain, timeout=timeout)
        if self._scheduler is not None:
            self._scheduler.join(timeout)
            if self._scheduler.alive:
                logger.warning(
                    "serving scheduler did not drain within %ss", timeout)

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
