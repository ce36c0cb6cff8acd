"""Prefill/decode disaggregation (counterpart of ``DisaggregatedEngine``
in ``bigdl_tpu/serving/replica.py``).

Two engines share one :class:`PrefixKVCache`: a prefill-role engine
publishes each prompt's K/V through it, and a decode engine admits the
request only once the prompt's granularity-aligned region is resident,
so its admission match copies the whole chain and goes straight to
decode.  Both engines issue their device work on the default stream, so
the decode engine's copy of a chunk is queued after the prefill
engine's extract of it.  The replicas, their registry and the router
belong to the serving fabric (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np

from bigdl_tpu_torch.serving.admission import ServerClosedError
from bigdl_tpu_torch.serving.generation import GenerationScheduler
from bigdl_tpu_torch.serving.prefix_cache import PrefixKVCache
from bigdl_tpu_torch.serving.reliability import Deadline

__all__ = ["DisaggregatedEngine"]


class DisaggregatedEngine:
    """Prefill/decode disaggregation over two engines and one shared
    prefix cache.  ``submit_generate_async`` sends the prompt to the
    PREFILL-role engine first, and once the full granularity-aligned
    prefix is cache-resident hands it to the DECODE engine, whose
    admission match copies the whole chain: decode slots only ever host
    decode-ready work.

    The decode engine prefills whatever is not resident at its admit
    (sub-granule tails always, evicted chunks under LRU pressure), so
    greedy rows equal the single-engine path and solo ``generate()``
    whatever the cache holds.  A chunk evicted between publish and admit
    is sent through the prefill engine again, ``max_prefill_retries``
    times, before the request goes to decode as it is."""

    def __init__(self, model, decode_slots: int = 8,
                 prefill_slots: int = 4,
                 prefix_cache_bytes: int = 1 << 26,
                 prefix_granularity: int = 32,
                 prefill_chunk: int = 64,
                 queue_capacity: Optional[int] = None,
                 eos_id=None, dtype=None,
                 max_prefill_retries: int = 2, device=None):
        self.cache = PrefixKVCache(int(prefix_cache_bytes),
                                   int(prefix_granularity))
        self.prefill = GenerationScheduler(
            model, slots=prefill_slots, role="prefill",
            prefix_cache=self.cache, prefill_chunk=prefill_chunk,
            queue_capacity=queue_capacity, eos_id=eos_id, dtype=dtype,
            device=device)
        try:
            self.decode = GenerationScheduler(
                model, slots=decode_slots, prefix_cache=self.cache,
                prefill_chunk=prefill_chunk,
                queue_capacity=queue_capacity, eos_id=eos_id, dtype=dtype,
                device=device)
        except BaseException:
            self.prefill.shutdown()
            raise
        self.max_prefill_retries = int(max_prefill_retries)
        self._lock = threading.Lock()
        self._outstanding = 0
        self._handoffs = 0
        self._prefill_retries = 0
        self._shutdown = False
        # outer future -> the decode engine's future, so cancel() reaches
        # the slot-owning engine after the handoff
        self._decode_futs: Dict[Future, Future] = {}

    # ---- submission ------------------------------------------------------

    def submit_generate_async(self, prompt, max_new_tokens: int,
                              eos_id=None, on_token=None,
                              timeout: Optional[float] = None,
                              deadline: Optional[Deadline] = None,
                              trace=None) -> Future:
        with self._lock:
            if self._shutdown:
                raise ServerClosedError("engine is shut down")
            self._outstanding += 1
        outer: Future = Future()
        outer.add_done_callback(self._dec_outstanding)
        p = np.asarray(prompt, np.int32).reshape(-1)
        try:
            if max(len(p) - 1, 0) < self.cache.granularity:
                # nothing the prefill tier could publish: the decode
                # engine's own sub-granule prefill is the whole cost
                self._to_decode(outer, p, max_new_tokens, eos_id,
                                on_token, timeout, deadline, trace)
            else:
                pf = self.prefill.submit_async(p, 0, timeout=timeout,
                                               deadline=deadline,
                                               trace=trace)
                pf.add_done_callback(
                    lambda f: self._after_prefill(
                        f, outer, p, max_new_tokens, eos_id, on_token,
                        self.max_prefill_retries, deadline))
        except BaseException:
            # the done-callback never fires for a future never resolved
            if not outer.done():
                with self._lock:
                    self._outstanding -= 1
            raise
        return outer

    submit_async = submit_generate_async

    def submit_generate(self, prompt, max_new_tokens: int, eos_id=None,
                        timeout: Optional[float] = None):
        return self.submit_generate_async(
            prompt, max_new_tokens, eos_id=eos_id,
            timeout=timeout).result(timeout)

    def _dec_outstanding(self, _fut) -> None:
        with self._lock:
            self._outstanding -= 1

    def _after_prefill(self, pf: Future, outer: Future, prompt,
                       max_new_tokens, eos_id, on_token, retries: int,
                       deadline: Optional[Deadline]) -> None:
        if outer.cancelled():
            return
        region = prompt[:len(prompt) - 1]
        exc = None if pf.cancelled() else pf.exception()
        if exc is None and self.cache.missing_boundaries(region) \
                and retries > 0:
            # evicted between the publish and this admit (LRU pressure):
            # one more pass through the prefill tier
            with self._lock:
                self._prefill_retries += 1
            try:
                # timeout=0: this callback runs ON the prefill engine's
                # thread, the only consumer of its queue; a blocking put
                # against a full queue would deadlock it
                nf = self.prefill.submit_async(prompt, 0, timeout=0,
                                               deadline=deadline)
                nf.add_done_callback(
                    lambda f: self._after_prefill(
                        f, outer, prompt, max_new_tokens, eos_id,
                        on_token, retries - 1, deadline))
                return
            except Exception:  # noqa: BLE001 - fall through to decode
                pass
        # prefill failed, retries exhausted, or the prefix is resident:
        # decode serves it either way (it prefills anything missing)
        self._to_decode(outer, prompt, max_new_tokens, eos_id, on_token,
                        0, deadline, None)

    def _to_decode(self, outer: Future, prompt, max_new_tokens, eos_id,
                   on_token, timeout, deadline: Optional[Deadline],
                   trace) -> None:
        """Hand one request to the decode engine.  ``timeout`` is the
        submitter's on the direct (sub-granule) path; the prefill
        completion passes 0, since it runs on the prefill engine's
        thread: a saturated decode tier then answers with the typed
        QueueFullError instead of stalling the prefill tier."""
        with self._lock:
            self._handoffs += 1
        try:
            df = self.decode.submit_async(
                prompt, max_new_tokens, eos_id=eos_id, on_token=on_token,
                timeout=timeout, deadline=deadline, trace=trace)
        except Exception as e:  # noqa: BLE001 - typed admission errors
            # (queue full, closed) land on the caller's future
            if outer.set_running_or_notify_cancel():
                outer.set_exception(e)
            return
        with self._lock:
            self._decode_futs[outer] = df
        df.add_done_callback(lambda f: self._chain(f, outer))

    def _chain(self, inner: Future, outer: Future) -> None:
        with self._lock:
            self._decode_futs.pop(outer, None)
        if not outer.set_running_or_notify_cancel():
            return      # the caller cancelled the outer future
        try:
            outer.set_result(inner.result())
        except BaseException as e:  # noqa: BLE001 - the inner exception
            # or CancelledError: the outer future carries it either way
            outer.set_exception(e)

    def cancel(self, fut: Future) -> bool:
        """Cancel an outer future: through to the decode engine's
        slot-freeing cancel once handed over; a request still in the
        prefill hop cancels at the outer future."""
        with self._lock:
            inner = self._decode_futs.get(fut)
        if inner is not None:
            return self.decode.cancel(inner)
        if fut.cancel():
            return True
        return not fut.done()

    def kill(self, exc: Optional[Exception] = None) -> None:
        """Kill both tiers (no drain): see
        :meth:`GenerationScheduler.kill`."""
        with self._lock:
            self._shutdown = True
        self.prefill.kill(exc)
        self.decode.kill(exc)

    # ---- observability / lifecycle ---------------------------------------

    def queue_depth(self) -> int:
        return self.prefill.queue_depth() + self.decode.queue_depth()

    def admitted_outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def stats(self) -> Dict[str, Any]:
        out = dict(self.decode.stats())
        with self._lock:
            out.update({
                "disaggregated": True,
                "handoffs": self._handoffs,
                "prefill_engine_retries": self._prefill_retries,
                "admitted_outstanding": self._outstanding,
            })
        out["prefill_engine"] = self.prefill.stats()
        return out

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 30.0) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        # prefill first: its completions hand work to decode, which must
        # still be admitting while they land
        self.prefill.shutdown(drain=drain, timeout=timeout)
        self.decode.shutdown(drain=drain, timeout=timeout)
