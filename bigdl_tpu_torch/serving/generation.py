"""Continuous batching for generation: iteration-level scheduling over a
fixed-shape KV slot pool, with chunked prefill (counterpart of
``bigdl_tpu/serving/generation.py``).

* a **slot pool** of S fixed KV-cache rows, one ``max_len`` row per slot;
* one **pooled decode step** advances every active slot by one token per
  iteration, each slot at its OWN position.  The reference vmaps
  ``decode_step`` over the slots; the port writes the batch dimension
  out (``decode_step`` with a per-row position tensor).  Every lane
  writes its position's K/V, so an inactive lane writes at ``max_len-1``,
  which no prefill query attends and every occupant rewrites before
  reading.  The pool's caches are written IN PLACE where the reference
  donates them through each jitted update;
* **prefill** is batched by power-of-two prompt-length buckets at a fixed
  prefill batch width, and the compact per-layer K/V rows are written
  into free slots; longer prompts are prefilled in fixed-width chunks
  (``TransformerLM.prefill_chunk``), at most ``prefill_chunk_budget``
  chunk calls between decode steps, so a long prompt does not freeze the
  token cadence of co-resident streams.  The final partial chunk is
  suffix-aligned, so it writes only real tokens.

Decode readback is **pipelined**: the per-slot token/position/active
feed lives on the device and the step advances it there, so the engine
dispatches step N+1 before reading step N's tokens.  Reading a step's
tokens (``.cpu()``) is the only host sync of the decode loop.

Greedy rows equal a solo ``model.generate()`` of the same prompt: a slot
position is always written before it is read, bucket padding and stale
cache slots are masked exactly (a masked key adds 0.0 to every sum), and
the attention kernel's fixed tiles make a row's attention independent of
the rows that share its launch.  On the card the projections go to
``torch.matmul``, whose kernels may vary with the number of rows, so
there the equality can break at a near-tie.

Not ported yet: the prefix KV cache and prefill dedup, ``role="prefill"``,
deadlines, ``kill`` and telemetry.  The constructor and the request
raise NotImplementedError for them rather than ignoring them.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.serving.admission import BoundedRequestQueue
from bigdl_tpu_torch.serving.batching import bucket_sizes, pick_bucket
from bigdl_tpu_torch.serving.reliability import RequestCancelledError

__all__ = ["GenerationRequest", "SlotPool", "GenerationScheduler",
           "run_mixed_workload"]

logger = logging.getLogger(__name__)


class GenerationRequest:
    """One generation request: prompt, decode budget and its completion
    future.  Duck-types the admission queue's item (``future``,
    ``t_enqueue``)."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "on_token",
                 "future", "t_enqueue")

    def __init__(self, prompt, max_new_tokens: int, eos_id=None,
                 on_token: Optional[Callable[[int], None]] = None,
                 deadline=None):
        if deadline is not None:
            raise NotImplementedError(
                "request deadlines are not ported yet")
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.on_token = on_token
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()


class SlotPool:
    """S fixed KV-cache slots and the operations that advance them.
    Host-side per-slot decode state (current token, position, active
    flag) is MIRRORED here as numpy arrays; the authoritative copy lives
    on the device so decode steps chain without a host round-trip, and
    the mirrors are pushed only when needed (``_dirty``)."""

    def __init__(self, model, slots: int, prefill_batch: int = 4,
                 device=None):
        if getattr(model, "seq_parallel", False):
            raise ValueError(
                "sequence-parallel models cannot serve from a slot pool "
                "(the ring path has no decode cache); build a dense copy")
        for attr in ("init_cache", "decode_step", "prefill_kv",
                     "prefill_chunk", "max_len", "_mask_untrained_logit"):
            if not hasattr(model, attr):
                raise TypeError(
                    f"slot-pool generation needs a model with the "
                    f"incremental-decode API (init_cache/decode_step/"
                    f"prefill_kv/prefill_chunk): "
                    f"{type(model).__name__} lacks {attr!r}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.device = resolve_device(device)
        # private eval-mode copy: serving must not flip the caller's
        # training flags, and dropout in decode would break greedy
        # equivalence with generate() on an eval'd model
        self.model = copy.deepcopy(model).eval().to(self.device)
        self.model.requires_grad_(False)
        self.slots = int(slots)
        self.prefill_batch = max(1, int(prefill_batch))
        self.max_len = int(model.max_len)
        self.caches = self.model.init_cache(self.slots)
        self.tok = np.zeros((self.slots,), np.int32)
        self.index = np.zeros((self.slots,), np.int32)
        self.active = np.zeros((self.slots,), bool)
        # device-carried decode feed (tok, index, active); rebuilt from
        # the mirrors whenever _dirty
        self._dev: Optional[Tuple[torch.Tensor, ...]] = None
        self._dirty = True
        # per-dispatch credit epoch: a step's emit folds into the host
        # mirrors (and is credited to occupants) ONLY for slots that
        # were active at ITS dispatch and not re-seeded since — else a
        # predecessor's trailing token would be credited to a fresh
        # occupant.  The still-unread step's epoch is frozen into its
        # handle at the next dispatch.
        self._emit_active = self.active.copy()
        self._touched = np.zeros((self.slots,), bool)
        self._open_handle: Optional[_StepHandle] = None

    # -- pool operations ----------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i in range(self.slots) if not self.active[i]]

    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def dirty(self) -> bool:
        """True when the host mirrors diverged from the device feed."""
        return self._dirty

    def _seed_slot(self, slot: int, tok: int, index: int,
                   active: bool) -> None:
        """Re-seed one slot's decode feed: the host mirrors always, and
        the device copy in place when it exists (stream-ordered after
        the steps already queued, so no pipeline drain)."""
        self.tok[slot] = tok
        self.index[slot] = index
        self.active[slot] = active
        self._touched[slot] = True
        if self._dev is None:
            self._dirty = True
            return
        tok_d, idx_d, act_d = self._dev
        tok_d[slot] = tok
        idx_d[slot] = index
        act_d[slot] = active

    def activate(self, slot: int, tok: int, index: int) -> None:
        """Mark ``slot`` decode-ready: feed ``tok`` at ``index`` on the
        next step (the request's last prompt token at its position)."""
        self._seed_slot(slot, tok, index, True)

    def release(self, slot: int) -> None:
        self._seed_slot(slot, 0, 0, False)

    def invalidate_feed(self) -> None:
        """Drop the device feed (e.g. after a failed dispatch); the next
        dispatch rebuilds it from the host mirrors."""
        self._dev = None
        self._dirty = True

    def prefill_into(self, prompts: Sequence[np.ndarray],
                     slot_ids: Sequence[int], bucket: int) -> None:
        """Batched prefill of ``prompts`` (true lengths <= bucket) into
        ``slot_ids``, at the fixed prefill batch width.  Single-token
        buckets skip the dense prefill (the first decode step writes
        position 0), matching ``generate()``'s Tp == 1 path."""
        n = len(prompts)
        if n != len(slot_ids) or not 0 < n <= self.prefill_batch:
            raise ValueError(f"{n} prompts for {len(slot_ids)} slots "
                             f"(prefill batch {self.prefill_batch})")
        if bucket > 1:
            padded = np.zeros((self.prefill_batch, bucket), np.int64)
            for i, p in enumerate(prompts):
                padded[i, :len(p)] = p
            # dead lanes repeat row 0 (any valid prompt)
            padded[n:] = padded[0]
            layers_kv, pads = self.model.prefill_kv(padded[:, :-1])
            t = bucket - 1
            # only the n real lanes are written: the reference marks the
            # dead lanes with slot id S and drops them in the scatter;
            # torch indexing would fail on (or write) such a lane
            ids = torch.as_tensor(list(slot_ids), device=self.device)
            for kv, cache in zip(layers_kv, self.caches["layers"]):
                cache["self"]["k"][ids, :, :t] = kv["k"][:n]
                cache["self"]["v"][ids, :, :t] = kv["v"][:n]
            self.caches["pad"][ids, :t] = pads[:n]
        for p, s in zip(prompts, slot_ids):
            # decode resumes from the last REAL prompt token at its true
            # position — bucket padding never shifts a request
            self.activate(s, int(p[len(p) - 1]), len(p) - 1)

    def chunk_prefill_into(self, toks: np.ndarray, slot: int,
                           index: int) -> None:
        """One KV-carry-in prefill chunk: write K/V and pad flags for
        ``toks`` at positions ``[index, index+len(toks))`` of ``slot``'s
        cache row, attending to everything already written below
        ``index``."""
        self.model.prefill_chunk(np.asarray(toks, np.int64)[None],
                                 int(index), self.caches, slot=int(slot))

    # -- decode (pipelined dispatch/readback) -------------------------------

    def _decode(self, tok, index, active):
        # an INACTIVE lane writes at max_len-1: beyond every prefill
        # query's mask and always rewritten by an occupant's own decode
        # before it is attended
        safe_index = torch.where(active, index, self.max_len - 1)
        logits, _ = self.model.decode_step(tok[:, None], safe_index,
                                           self.caches)
        nxt = self.model._mask_untrained_logit(logits).argmax(-1) + 1
        # the feed advances on the device so step N+1 can be dispatched
        # before step N's emit is read; inactive lanes emit 0 (an active
        # slot emits argmax+1 >= 1)
        return (torch.where(active, nxt, tok),
                torch.where(active, index + 1, index),
                torch.where(active, nxt, 0))

    def decode_dispatch(self) -> "_StepHandle":
        """Dispatch one pooled decode step and return its handle WITHOUT
        reading it back.  Finalises the credit epoch of the
        still-outstanding previous step first."""
        if self._open_handle is not None \
                and self._open_handle.mask is None:
            self._open_handle.mask = self._emit_active & ~self._touched
        if self._dirty or self._dev is None:
            dev = self.device
            self._dev = (
                torch.as_tensor(self.tok, device=dev).long(),
                torch.as_tensor(self.index, device=dev).long(),
                torch.as_tensor(self.active, device=dev))
            self._dirty = False
        tok_d, idx_d, act_d = self._dev
        new_tok, new_idx, emit = self._decode(tok_d, idx_d, act_d)
        self._dev = (new_tok, new_idx, act_d)
        self._emit_active = self.active.copy()
        self._touched[:] = False
        handle = _StepHandle(emit)
        self._open_handle = handle
        return handle

    def read_emit_masked(self, handle: "_StepHandle") \
            -> Tuple[np.ndarray, np.ndarray]:
        """Wait for one step's tokens and fold them into the host mirrors
        for the slots in the step's credit epoch.  Returns ``(tokens [S],
        credit [S] bool)``."""
        was = handle.mask
        if was is None:
            was = self._emit_active & ~self._touched
        if self._open_handle is handle:
            self._open_handle = None
        out = handle.emit.cpu().numpy()     # the decode loop's sync point
        feed = out.astype(np.int32)
        self.tok = np.where(was, feed, self.tok).astype(np.int32)
        self.index = np.where(was, self.index + 1,
                              self.index).astype(np.int32)
        return out, was

    def read_emit(self, handle: "_StepHandle") -> np.ndarray:
        return self.read_emit_masked(handle)[0]

    def decode(self) -> np.ndarray:
        """Synchronous decode step (dispatch + readback)."""
        return self.read_emit(self.decode_dispatch())


class _StepHandle:
    """One dispatched decode step: its unread emit plus the credit epoch
    (finalised at the NEXT dispatch)."""

    __slots__ = ("emit", "mask")

    def __init__(self, emit):
        self.emit = emit
        self.mask: Optional[np.ndarray] = None


class _ActiveSlot:
    """Host bookkeeping for one occupied slot (prefilling or decoding)."""

    __slots__ = ("req", "emitted", "t_first", "t_last", "eos_id", "slot",
                 "phase", "next_pos", "end_pos")

    def __init__(self, req: GenerationRequest, eos_id, slot: int):
        self.req = req
        self.emitted: List[int] = []
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.eos_id = eos_id
        self.slot = slot
        self.phase = "prefill"
        self.next_pos = 0                            # next prefill position
        self.end_pos = max(len(req.prompt) - 1, 0)   # prefill covers [0, end)


class _Reservoir:
    """Bounded uniform sample for host-side latency quantiles."""

    __slots__ = ("cap", "vals", "seen", "_rng")

    def __init__(self, cap: int = 8192, seed: int = 0):
        self.cap = cap
        self.vals: List[float] = []
        self.seen = 0
        self._rng = np.random.default_rng(seed)

    def add(self, v: float) -> None:
        self.seen += 1
        if len(self.vals) < self.cap:
            self.vals.append(float(v))
        else:
            j = int(self._rng.integers(self.seen))
            if j < self.cap:
                self.vals[j] = float(v)

    def quantiles(self, qs=(0.5, 0.99)) -> Dict[str, float]:
        if not self.vals:
            return {f"p{int(q * 100)}": 0.0 for q in qs}
        out = np.quantile(np.asarray(self.vals), list(qs))
        return {f"p{int(q * 100)}": float(v) for q, v in zip(qs, out)}


class GenerationScheduler:
    """Continuous-batching decode engine.  One daemon thread owns the
    admit -> prefill -> decode -> emit loop; submitters talk to it
    through a :class:`BoundedRequestQueue` (block / reject / shed_oldest).

    Prompts whose whole prefill fits one chunk (``len(prompt) <=
    prefill_chunk``) go through the bucketed batch prefill; longer ones
    are prefilled in ``prefill_chunk``-wide chunks.  While any slot is
    decoding, at most ``prefill_chunk_budget`` prefill calls run per
    engine iteration; with nothing decoding, prefill drains at full
    speed.

    >>> engine = GenerationScheduler(lm, slots=8)
    >>> fut = engine.submit_async([5, 9, 2], max_new_tokens=16)
    >>> fut.result()        # [Tp + 16] tokens, == lm.generate() solo
    >>> engine.shutdown()   # drains admitted requests to completion
    """

    def __init__(self, model, slots: int = 8, *,
                 queue_capacity: Optional[int] = None,
                 admission: str = "block",
                 prefill_batch: int = 4,
                 eos_id=None, start: bool = True,
                 prefill_chunk: int = 64,
                 prefill_chunk_budget: int = 1,
                 prefix_cache_bytes: Optional[int] = None,
                 prefix_cache=None,
                 role: str = "mixed",
                 device=None):
        if prefix_cache_bytes or prefix_cache is not None:
            raise NotImplementedError(
                "the prefix KV cache is not ported yet")
        if role == "prefill":
            raise NotImplementedError(
                "prefill-role engines are not ported yet")
        if role != "mixed":
            raise ValueError(f"role must be 'mixed', got {role!r}")
        if prefill_chunk < 2:
            raise ValueError(
                f"prefill_chunk must be >= 2, got {prefill_chunk}")
        if prefill_chunk_budget < 1:
            raise ValueError(
                f"prefill_chunk_budget must be >= 1, got "
                f"{prefill_chunk_budget}")
        self.pool = SlotPool(model, slots, prefill_batch=prefill_batch,
                             device=device)
        self.default_eos_id = eos_id
        self.prefill_chunk = min(int(prefill_chunk), self.pool.max_len)
        self.prefill_chunk_budget = int(prefill_chunk_budget)
        self._chunk_buckets = bucket_sizes(self.prefill_chunk)
        cap = queue_capacity if queue_capacity is not None else 8 * slots
        self._queue = BoundedRequestQueue(
            cap, policy=admission, on_shed=self._record_shed)
        self._prompt_buckets = bucket_sizes(self.pool.max_len)
        self._slot_state: List[Optional[_ActiveSlot]] = [None] * slots
        self._prefill_work: Deque[Tuple] = deque()
        self._pending: Optional[Tuple] = None   # (handle, n_active, t0)
        self._lock = threading.Lock()
        self._outstanding = 0
        self._requests_done = 0
        self._tokens_emitted = 0
        self._decode_steps = 0
        self._prefill_calls = 0
        self._decode_s = 0.0
        self._prefill_s = 0.0
        self._occupancy_sum = 0
        self._ttft_sum = 0.0
        self._ttft_n = 0
        self._ttft_res = _Reservoir(seed=1)
        self._itl_res = _Reservoir(seed=2)
        self._shed = 0
        self._shutdown = False
        # caller-side cancels land here (lock-guarded); the engine sweep
        # consumes them
        self._cancel_requests: set = set()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "GenerationScheduler":
        if self._thread is not None:
            raise RuntimeError("generation scheduler already started")
        self._thread = threading.Thread(
            target=self._run, name="bigdl-torch-serving-generation",
            daemon=True)
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 30.0) -> None:
        """Stop admitting.  With ``drain`` (default) every queued request
        is still generated to completion; otherwise queued requests fail
        with ServerClosedError.  Requests already IN a slot always
        finish."""
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        self._queue.close(discard=not drain)
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                logger.warning(
                    "generation scheduler did not drain within %ss",
                    timeout)

    # -- submission ---------------------------------------------------------

    def submit_async(self, prompt, max_new_tokens: int, eos_id=None,
                     on_token: Optional[Callable[[int], None]] = None,
                     timeout: Optional[float] = None,
                     deadline=None) -> Future:
        """Admit one prompt (1-D int tokens) and return a Future of the
        full ``[Tp + max_new_tokens]`` int32 row, equal to
        ``model.generate(prompt[None], max_new_tokens, eos_id)[0]``.
        ``on_token`` streams each emitted token from the engine thread.
        ``deadline`` is not supported yet (NotImplementedError)."""
        req = GenerationRequest(prompt, max_new_tokens, eos_id=eos_id,
                                on_token=on_token, deadline=deadline)
        err = self._validate(req)
        if err is not None:
            raise err
        # count BEFORE the put: the engine may resolve the future before
        # this thread returns
        with self._lock:
            self._outstanding += 1
        try:
            self._queue.put(req, timeout=timeout)
        except BaseException:
            with self._lock:
                self._outstanding -= 1
            raise
        req.future.add_done_callback(self._dec_outstanding)
        return req.future

    def _dec_outstanding(self, _fut) -> None:
        with self._lock:
            self._outstanding -= 1

    def admitted_outstanding(self) -> int:
        """Admitted requests not yet terminal (queued, prefilling or
        decoding)."""
        with self._lock:
            return self._outstanding

    def submit(self, prompt, max_new_tokens: int, eos_id=None,
               timeout: Optional[float] = None) -> np.ndarray:
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        fut = self.submit_async(prompt, max_new_tokens, eos_id=eos_id,
                                timeout=timeout)
        remaining = (None if deadline is None
                     else max(deadline - time.perf_counter(), 0.0))
        try:
            return fut.result(remaining)
        except FuturesTimeout:
            # the caller is walking away: free its slot
            self.cancel(fut)
            raise

    def cancel(self, fut: Future) -> bool:
        """Best-effort cancel.  Still queued → ``Future.cancel``;
        slot-resident → the engine sweep frees the slot within one loop
        iteration and fails the future with RequestCancelledError.
        Returns False only for a future that already completed."""
        if fut.cancel():
            return True
        if fut.done():
            return False
        with self._lock:
            self._cancel_requests.add(fut)
        return True

    def _validate(self, req: GenerationRequest) -> Optional[Exception]:
        tp = len(req.prompt)
        if tp < 1:
            return ValueError("empty prompt")
        if req.max_new_tokens < 1:
            return ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        if tp + req.max_new_tokens > self.pool.max_len:
            return ValueError(
                f"prompt {tp} + {req.max_new_tokens} new tokens exceeds "
                f"max_len={self.pool.max_len}")
        return None

    # -- observability ------------------------------------------------------

    def queue_depth(self) -> int:
        return len(self._queue)

    def _record_shed(self) -> None:
        with self._lock:
            self._shed += 1

    def stats(self) -> Dict[str, object]:
        """One lock-coherent snapshot of the engine counters.  The
        seconds are host time around the dispatches (the device runs
        asynchronously; the decode seconds end at each step's readback)."""
        with self._lock:
            steps = self._decode_steps
            ttft_q = self._ttft_res.quantiles()
            itl_q = self._itl_res.quantiles()
            return {
                "requests_done": self._requests_done,
                "tokens_emitted": self._tokens_emitted,
                "decode_steps": steps,
                "prefill_calls": self._prefill_calls,
                "decode_seconds": self._decode_s,
                "prefill_seconds": self._prefill_s,
                "slot_occupancy_mean": (self._occupancy_sum / steps
                                        if steps else 0.0),
                "queue_to_first_token_s_mean": (
                    self._ttft_sum / self._ttft_n if self._ttft_n
                    else 0.0),
                "queue_to_first_token_s_p50": ttft_q["p50"],
                "queue_to_first_token_s_p99": ttft_q["p99"],
                "inter_token_s_p50": itl_q["p50"],
                "inter_token_s_p99": itl_q["p99"],
                "prefill_chunk": self.prefill_chunk,
                "prefill_chunk_budget": self.prefill_chunk_budget,
                "admitted_outstanding": self._outstanding,
                "shed": self._shed,
                "slots": self.pool.slots,
                "tokens_per_second": (self._tokens_emitted / self._decode_s
                                      if self._decode_s else 0.0),
            }

    # -- the engine loop ----------------------------------------------------

    def _run(self) -> None:
        pool = self.pool
        while True:
            self._sweep_cancels()
            occupied = sum(1 for st in self._slot_state if st is not None)
            arrivals: List[GenerationRequest] = []
            if occupied == 0 and self._pending is None \
                    and not self._prefill_work:
                first = self._queue.get(timeout=None)
                if first is None:
                    return          # closed + drained, nothing in flight
                arrivals.append(first)
            free = pool.slots - occupied - len(arrivals)
            if free > 0:
                arrivals.extend(self._queue.get_nowait_up_to(free))
            try:
                if arrivals or self._prefill_work:
                    # admits and prefill only write cache rows of slots
                    # that are not decoding: safe with a decode step in
                    # flight, so prefill keeps the readback overlap
                    if arrivals:
                        self._admit(arrivals)
                    self._run_prefill()
                if pool.n_active():
                    self._dispatch_decode()
                else:
                    self._drain_pending()
            except Exception as e:  # noqa: BLE001 - engine must survive
                # a failing iteration fails the affected futures and the
                # loop continues; it never strands RUNNING futures
                logger.exception("generation engine iteration failed")
                self._fail_in_flight(e)

    def _fail_in_flight(self, exc: Exception) -> None:
        """Fail every slot-resident request with ``exc`` and free its
        slot; the engine keeps serving later arrivals (positions are
        written before they are read, so a poisoned cache cannot leak
        into a new occupant)."""
        self._pending = None
        self._prefill_work.clear()
        self.pool.invalidate_feed()
        for slot in range(self.pool.slots):
            st = self._slot_state[slot]
            if st is None:
                continue
            if not st.req.future.done():
                st.req.future.set_exception(exc)
            self._slot_state[slot] = None
            self.pool.release(slot)

    def _sweep_cancels(self) -> None:
        """Free the slots of requests the caller cancelled.  A late
        in-flight emit for a re-seeded slot is discarded by the credit
        epoch."""
        with self._lock:
            if not self._cancel_requests:
                return
            cancels = self._cancel_requests
            self._cancel_requests = set()
        for slot in range(self.pool.slots):
            st = self._slot_state[slot]
            if st is None or st.req.future not in cancels:
                continue
            self._purge_prefill_work(st)
            if not st.req.future.done():
                st.req.future.set_exception(RequestCancelledError(
                    "caller abandoned the request (client-side timeout "
                    "or explicit cancel)"))
            self._slot_state[slot] = None
            self.pool.release(slot)

    def _purge_prefill_work(self, st: _ActiveSlot) -> None:
        """Drop every pending prefill item that references ``st``, so an
        evicted request is never prefilled into a slot it lost."""
        kept: Deque[Tuple] = deque()
        for item in self._prefill_work:
            if item[0] == "chunk" and item[1] is st:
                continue
            if item[0] == "legacy":
                sts = [s for s in item[2] if s is not st]
                if not sts:
                    continue
                item = ("legacy", item[1], sts)
            kept.append(item)
        self._prefill_work = kept

    # -- admit + prefill ----------------------------------------------------

    def _admit(self, arrivals: List[GenerationRequest]) -> None:
        pool = self.pool
        ready: List[GenerationRequest] = []
        for req in arrivals:
            err = self._validate(req)
            if err is not None:
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(err)
                continue
            # PENDING -> RUNNING: a future cancelled while queued drops
            # out without a slot, and cancel() can no longer race the
            # final set_result
            if req.future.set_running_or_notify_cancel():
                ready.append(req)
        free = [i for i in range(pool.slots)
                if self._slot_state[i] is None]
        legacy: Dict[int, List[_ActiveSlot]] = {}
        for req in ready:
            slot = free.pop(0)
            eos = (req.eos_id if req.eos_id is not None
                   else self.default_eos_id)
            st = _ActiveSlot(req, eos, slot)
            self._slot_state[slot] = st
            if st.end_pos == 0:
                # a 1-token prompt has nothing to prefill
                pool.activate(slot, int(req.prompt[-1]), 0)
                st.phase = "decode"
            elif len(req.prompt) <= self.prefill_chunk:
                b = pick_bucket(len(req.prompt), self._prompt_buckets)
                legacy.setdefault(b, []).append(st)
            else:
                self._prefill_work.append(("chunk", st))
        for bucket in sorted(legacy):
            sts = legacy[bucket]
            for lo in range(0, len(sts), pool.prefill_batch):
                self._prefill_work.append(
                    ("legacy", bucket, sts[lo:lo + pool.prefill_batch]))

    def _run_prefill(self) -> None:
        """Run pending prefill work: at most ``prefill_chunk_budget``
        calls while any slot is decoding, unbounded otherwise."""
        limit = (self.prefill_chunk_budget if self.pool.n_active()
                 else None)
        done = 0
        while self._prefill_work and (limit is None or done < limit):
            item = self._prefill_work[0]
            if item[0] == "legacy":
                self._prefill_work.popleft()
                self._legacy_prefill(item[1], item[2])
            else:
                st = item[1]
                self._chunk_prefill_step(st)
                if st.phase == "decode" \
                        or self._slot_state[st.slot] is not st:
                    self._prefill_work.popleft()
            done += 1

    def _fail_prefill(self, sts: List[_ActiveSlot], exc: Exception) -> None:
        for st in sts:
            if not st.req.future.done():
                st.req.future.set_exception(exc)
            self._slot_state[st.slot] = None
            self.pool.release(st.slot)

    def _legacy_prefill(self, bucket: int, sts: List[_ActiveSlot]) -> None:
        """Batched bucket prefill (whole prompt, one call, up to
        ``prefill_batch`` requests)."""
        t0 = time.perf_counter()
        try:
            self.pool.prefill_into([st.req.prompt for st in sts],
                                   [st.slot for st in sts], bucket)
        except Exception as e:  # noqa: BLE001 - fail these requests only
            logger.exception("prefill of bucket %d failed", bucket)
            self._fail_prefill(sts, e)
            return
        t1 = time.perf_counter()
        for st in sts:
            st.next_pos = st.end_pos
            st.phase = "decode"
        with self._lock:
            self._prefill_calls += 1
            self._prefill_s += t1 - t0

    def _chunk_prefill_step(self, st: _ActiveSlot) -> None:
        """One fixed-width prefill chunk for ``st``.  Full chunks run at
        ``prefill_chunk``; the final partial chunk takes the smallest
        bucket covering the remainder and is SUFFIX-ALIGNED (recomputing
        a little overlap, which rewrites identical K/V) so it never
        writes past the prefill region."""
        p = st.req.prompt
        end = st.end_pos
        r = end - st.next_pos
        if r >= self.prefill_chunk:
            w, s = self.prefill_chunk, st.next_pos
            toks = p[s:s + w]
        else:
            w = pick_bucket(r, self._chunk_buckets)
            s = max(end - w, 0)
            toks = p[s:min(s + w, end)]
            if len(toks) < w:
                # only a first-and-only chunk can be short (s == 0): pad
                # the tail; decode rewrites those positions before they
                # are ever attended
                toks = np.concatenate(
                    [toks, np.zeros(w - len(toks), np.int32)])
        t0 = time.perf_counter()
        try:
            self.pool.chunk_prefill_into(toks, st.slot, s)
        except Exception as e:  # noqa: BLE001 - fail this request only
            logger.exception("chunked prefill failed for slot %d",
                             st.slot)
            self._fail_prefill([st], e)
            return
        t1 = time.perf_counter()
        st.next_pos = end if s + w >= end else s + w
        with self._lock:
            self._prefill_calls += 1
            self._prefill_s += t1 - t0
        if st.next_pos >= end:
            self.pool.activate(st.slot, int(p[-1]), end)
            st.phase = "decode"

    # -- decode (pipelined) -------------------------------------------------

    def _drain_pending(self) -> None:
        prev, self._pending = self._pending, None
        if prev is not None:
            self._emit_step(prev)

    def _dispatch_decode(self) -> None:
        pool = self.pool
        prev = self._pending
        if prev is not None and pool.dirty:
            # the feed must be rebuilt from the mirrors: fold the
            # outstanding step's emit into them first
            self._pending = None
            self._emit_step(prev)
            prev = None
            if pool.n_active() == 0:
                return
        n_active = pool.n_active()
        t0 = time.perf_counter()
        try:
            handle = pool.decode_dispatch()
        except Exception as e:  # noqa: BLE001 - fail the residents,
            # keep the engine thread alive for later arrivals
            logger.exception("pooled decode step failed")
            self._fail_in_flight(e)
            return
        self._pending = (handle, n_active, t0)
        if prev is not None:
            # step N's host work (readback, callbacks, EOS checks) runs
            # while step N+1 executes on the device
            self._emit_step(prev)

    def _emit_step(self, pending: Tuple) -> None:
        pool = self.pool
        handle, n_active, t0 = pending
        out, credit = pool.read_emit_masked(handle)
        now = time.perf_counter()
        emitted = 0
        gaps: List[float] = []
        finished: List[int] = []
        for slot in range(pool.slots):
            st = self._slot_state[slot]
            if st is None or st.phase != "decode" or not credit[slot]:
                continue
            tok = int(out[slot])
            if tok == 0:
                continue    # slot was not active at this dispatch
            st.emitted.append(tok)
            emitted += 1
            if st.t_first is None:
                st.t_first = now
            else:
                gaps.append(now - st.t_last)
            st.t_last = now
            if st.req.on_token is not None:
                try:
                    st.req.on_token(tok)
                except Exception:   # noqa: BLE001 - user callback
                    logger.exception("on_token callback failed")
            if (st.eos_id is not None and tok == st.eos_id) \
                    or len(st.emitted) >= st.req.max_new_tokens:
                finished.append(slot)
        # counters BEFORE any future resolves: a waiter may read stats()
        # the moment its result() returns
        with self._lock:
            self._decode_steps += 1
            self._tokens_emitted += emitted
            self._decode_s += now - t0
            self._occupancy_sum += n_active
            for g in gaps:
                self._itl_res.add(g)
        for slot in finished:
            self._finish(self._slot_state[slot], now)
            self._slot_state[slot] = None
            pool.release(slot)

    def _finish(self, st: _ActiveSlot, now: float) -> None:
        req = st.req
        row = np.zeros((len(req.prompt) + req.max_new_tokens,), np.int32)
        row[:len(req.prompt)] = req.prompt
        row[len(req.prompt):len(req.prompt) + len(st.emitted)] = st.emitted
        ttft = ((st.t_first if st.t_first is not None else now)
                - req.t_enqueue)
        with self._lock:
            self._requests_done += 1
            self._ttft_sum += ttft
            self._ttft_n += 1
            self._ttft_res.add(ttft)
        # positions after EOS stay 0, exactly generate()'s padding
        req.future.set_result(row)


# ---------------------------------------------------------------------------
# Acceptance harness
# ---------------------------------------------------------------------------

def run_mixed_workload(model, prompts: Sequence[np.ndarray],
                       max_news: Sequence[int], slots: int = 8,
                       eos_id=None, compare_sequential: bool = True,
                       prefill_batch: int = 4,
                       sequential_sample: Optional[int] = None,
                       prefill_chunk: int = 64,
                       prefill_chunk_budget: int = 1,
                       device=None) -> Dict[str, object]:
    """Drive a mixed-length workload through the continuous-batching
    engine, optionally race the sequential ``generate()`` baseline on the
    engine's own copy of the weights, and check greedy equality per
    request.  Tokens/s counts only NEW tokens.  ``sequential_sample``
    caps the baseline at the first K requests."""
    engine = GenerationScheduler(model, slots=slots, eos_id=eos_id,
                                 prefill_batch=prefill_batch,
                                 queue_capacity=max(len(prompts), 1),
                                 prefill_chunk=prefill_chunk,
                                 prefill_chunk_budget=prefill_chunk_budget,
                                 device=device)
    try:
        t0 = time.perf_counter()
        futs = [engine.submit_async(p, m)
                for p, m in zip(prompts, max_news)]
        rows = [f.result(timeout=600) for f in futs]
        cont_s = time.perf_counter() - t0
        stats = engine.stats()
    finally:
        engine.shutdown()
    total_new = int(stats["tokens_emitted"])
    out: Dict[str, object] = {
        "requests": len(prompts),
        "slots": slots,
        "total_new_tokens": total_new,
        "continuous_seconds": cont_s,
        "continuous_tokens_per_sec": total_new / cont_s,
        "slot_occupancy_mean": float(stats["slot_occupancy_mean"]),
        "queue_to_first_token_s_mean": float(
            stats["queue_to_first_token_s_mean"]),
        "queue_to_first_token_s_p50": float(
            stats["queue_to_first_token_s_p50"]),
        "queue_to_first_token_s_p99": float(
            stats["queue_to_first_token_s_p99"]),
        "inter_token_s_p50": float(stats["inter_token_s_p50"]),
        "inter_token_s_p99": float(stats["inter_token_s_p99"]),
        "prefill_seconds": float(stats["prefill_seconds"]),
        "decode_seconds": float(stats["decode_seconds"]),
    }
    if compare_sequential:
        k = (len(prompts) if sequential_sample is None
             else min(int(sequential_sample), len(prompts)))
        solo = engine.pool.model
        seq_rows = []
        t0 = time.perf_counter()
        for p, m in zip(prompts[:k], max_news[:k]):
            seq_rows.append(solo.generate(
                np.asarray(p)[None], m, eos_id=eos_id)[0].cpu().numpy())
        seq_s = time.perf_counter() - t0
        # count the baseline's emitted tokens, not its budget: post-EOS
        # positions are 0
        seq_new = sum(int(np.count_nonzero(r[len(p):]))
                      for p, r in zip(prompts[:k], seq_rows))
        out.update({
            "sequential_requests": k,
            "sequential_seconds": seq_s,
            "sequential_tokens_per_sec": seq_new / seq_s,
            "speedup_vs_sequential": (total_new / cont_s) / (seq_new / seq_s),
            "greedy_equal_checked": all(
                np.array_equal(a, b) for a, b in zip(rows[:k], seq_rows)),
            "greedy_checked_requests": k,
        })
    return out
