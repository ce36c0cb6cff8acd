"""Embedding-aware serving (counterpart of
``bigdl_tpu/embedding/serving.py``): the shard affinity key and a scoring
target over the one-shot ``ModelServer``.

* :func:`shard_affinity_key`: a router ``session`` key naming the
  embedding shard that owns a request's user id (the contiguous-block
  layout of ``ShardedEmbeddingTable.owner_of``), so that every request
  touching one shard's rows goes to one home replica.
* :class:`RecommenderScorer`: a one-shot scoring ``ModelServer`` (the
  dynamic batcher, admission and metrics, unchanged) behind the
  ``submit_generate_async`` protocol a replica speaks; ``prompt`` is the
  [2] (user, item) id row or a [1 + neg, 2] slate, and the "generation"
  is its score.  ``Replica`` and the router are ROADMAP.md queue 1, item
  12.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["shard_affinity_key", "RecommenderScorer"]


def shard_affinity_key(user_id: int, n_rows: int, n_shards: int,
                       model: str = "default",
                       table: str = "user") -> str:
    """Router session key for the shard owning ``user_id`` (1-based)
    under the contiguous row-block layout: every session touching one
    shard hashes to one home replica."""
    n_shards = max(1, int(n_shards))
    rows_per_shard = max(1, int(n_rows) // n_shards)
    idx0 = min(max(int(user_id) - 1, 0), int(n_rows) - 1)
    shard = min(idx0 // rows_per_shard, n_shards - 1)
    return f"emb-{model}-{table}-s{shard}"


class RecommenderScorer:
    """Replica-target adapter over a one-shot scoring ``ModelServer`` on
    ``device`` (default ``cuda``; the model must lie there).

    >>> scorer = RecommenderScorer(model).warmup(np.zeros(2, np.int32))
    >>> score = scorer.submit_generate_async(
    ...     np.asarray([user, item], np.int32)).result()
    """

    def __init__(self, model, max_batch: int = 32, **server_kwargs):
        from bigdl_tpu_torch.serving.server import ModelServer
        # the server scores an eval-mode clone (jit_forward), on the dense
        # lookup: a port table has no mesh to clear (set_mesh raises)
        self._server = ModelServer(backend=model, max_batch=max_batch,
                                   **server_kwargs)

    def warmup(self, example_sample) -> "RecommenderScorer":
        self._server.warmup(example_sample)
        return self

    # ---- the Replica target protocol -----------------------------------

    def submit_generate_async(self, prompt, max_new_tokens: int = 0,
                              eos_id=None, on_token=None,
                              timeout: Optional[float] = None):
        """A scored request is one forward: the Future of the id row's
        score (``max_new_tokens``, ``eos_id`` and ``on_token`` are
        ignored)."""
        return self._server.submit_async(
            np.asarray(prompt, np.int32), timeout=timeout)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        self._server.shutdown(drain=drain, timeout=timeout)

    # ---- health/stats delegation (router drain + load accounting) ------

    def admitted_outstanding(self) -> int:
        return self._server.admitted_outstanding()

    def queue_depth(self) -> int:
        return self._server.queue_depth()

    def stats(self):
        return {"slots": self._server.max_batch,
                "queue_depth": self._server.queue_depth()}
