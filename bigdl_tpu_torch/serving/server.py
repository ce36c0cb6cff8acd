"""ModelServer: the serving front end (counterpart of the generation
path of ``bigdl_tpu/serving/server.py``).

This slice serves generation only: ``generator=`` (a TransformerLM or a
pre-built :class:`GenerationScheduler`) behind the continuous-batching
engine.  One-shot ``backend=`` serving belongs to a later slice and
raises NotImplementedError.
"""

from __future__ import annotations

import operator
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.serving.admission import ServerClosedError
from bigdl_tpu_torch.serving.generation import GenerationScheduler

__all__ = ["ModelServer"]


class ModelServer:
    """Continuous-batching generation server.

    >>> server = ModelServer(generator=lm, slots=16)
    >>> row = server.submit_generate(prompt, max_new_tokens=32)
    >>> server.shutdown()                     # drains admitted requests
    """

    def __init__(self, backend=None, *, generator=None, slots: int = 8,
                 gen_queue_capacity: Optional[int] = None,
                 admission: str = "block", device=None):
        if backend is not None:
            raise NotImplementedError(
                "one-shot backend serving is not ported yet; serve a "
                "generator")
        if generator is None:
            raise TypeError("ModelServer needs a generator (a TransformerLM "
                            "or a GenerationScheduler)")
        dev = resolve_device(device)
        if isinstance(generator, GenerationScheduler):
            if generator.pool.device != dev:
                raise ValueError(
                    f"the generation scheduler runs on "
                    f"{generator.pool.device}, the server on {dev}")
            self.generation = generator
        else:
            self.generation = GenerationScheduler(
                generator, slots=slots, queue_capacity=gen_queue_capacity,
                admission=admission, device=dev)
        self._shutdown = False

    def _gen(self) -> GenerationScheduler:
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
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        out = []
        for f in futures:
            remaining = (None if deadline is None
                         else max(deadline - time.perf_counter(), 0.0))
            out.append(f.result(remaining))
        return out

    def admitted_outstanding(self) -> int:
        return self.generation.admitted_outstanding()

    def generation_queue_depth(self) -> int:
        return self.generation.queue_depth()

    def generation_stats(self):
        return self.generation.stats()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 30.0) -> None:
        """Stop admitting.  With ``drain`` every admitted request is
        generated to its last token; otherwise still-queued requests fail
        with ServerClosedError (slot-resident ones always finish)."""
        if self._shutdown:
            return
        self._shutdown = True
        self.generation.shutdown(drain=drain, timeout=timeout)

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
