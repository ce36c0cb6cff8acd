"""Streaming, resumable recommender evaluation (counterpart of
``bigdl_tpu/embedding/eval.py``).

HitRatio@K / NDCG@K over the 1-positive + N-negatives protocol
(``optim.validation``: scores [batch, 1 + neg], the positive in column 0),
consumed one minibatch at a time: each method's ``(numerator,
denominator)`` is folded into running sums on the host, so a sweep over
a 100M-user table never holds the score matrix and can stop and resume at
any batch boundary.

The snapshot carries a ``PipelineState`` (seed, epoch, batches consumed;
``data/pipeline.py``) beside the partial sums, a plain JSON-able dict.
Resuming replays the epoch's iterator from the same seed and skips the
consumed batches, so an interrupted and resumed sweep equals the one-shot
sweep.  A mixing sampler's configuration is checked where the dataset
has one (``data/mixing.py`` is not ported: ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.data.pipeline import (
    PipelineState, dataset_seed, epoch_iter, skip_batches,
)
from bigdl_tpu_torch.optim.validation import HitRatio, NDCG, ValidationMethod

__all__ = ["StreamingRecEval", "EVAL_STATE_VERSION"]

EVAL_STATE_VERSION = 1


class StreamingRecEval:
    """Streaming HitRatio/NDCG evaluator over minibatches of [1 + neg, 2]
    id rows (user, item; positive first), scored by an eval-mode clone of
    ``model`` on ``device`` (default ``cuda``; the model must lie there).

    >>> ev = StreamingRecEval(model)
    >>> _, state = ev.evaluate(ds, max_batches=2)   # interrupted
    >>> results, _ = StreamingRecEval(model).evaluate(ds, state=state)
    """

    def __init__(self, model,
                 methods: Optional[Sequence[ValidationMethod]] = None,
                 batch_size: int = 32, *, device=None):
        from bigdl_tpu_torch.optim.predictor import jit_forward
        self.methods = list(methods) if methods is not None \
            else [HitRatio(10), NDCG(10)]
        self.batch_size = int(batch_size)
        self._model, self._fn = jit_forward(model, device)

    # -- scoring -----------------------------------------------------------

    def _score(self, feats):
        out = self._fn(self._model, feats)
        if out.dim() and out.shape[-1] == 1:
            out = out[..., 0]
        return out

    def _wrap(self, dataset):
        """A DataSet of minibatches as it is; a raw [U, 1 + neg, 2] array
        as a deterministic batched one."""
        # a CALLABLE .data: np.ndarray.data is a memoryview
        if callable(getattr(dataset, "data", None)):
            return dataset
        from bigdl_tpu_torch.dataset import DataSet, Sample, \
            SampleToMiniBatch
        rows = np.asarray(dataset)
        samples = [Sample(rows[i].astype(np.int32), 1)
                   for i in range(rows.shape[0])]
        return (DataSet.array(samples, shuffle=False)
                .transform(SampleToMiniBatch(self.batch_size)))

    # -- the stream --------------------------------------------------------

    def evaluate(self, dataset, state: Optional[Dict] = None,
                 max_batches: Optional[int] = None):
        """Consume (the rest of) one eval epoch.  Returns ``(results,
        snapshot)``: ``results`` is None when ``max_batches`` stopped the
        sweep, and ``snapshot`` resumes it."""
        dataset = self._wrap(dataset)
        sampler = (dataset.sampler_state()
                   if hasattr(dataset, "sampler_state") else None)
        if state is not None:
            if state.get("version") != EVAL_STATE_VERSION:
                raise ValueError(
                    f"unsupported eval-state version "
                    f"{state.get('version')!r} "
                    f"(supported: {EVAL_STATE_VERSION})")
            fmts = [m.fmt for m in self.methods]
            if state.get("methods") != fmts:
                raise ValueError(
                    f"eval state was written for {state.get('methods')} "
                    f"but this evaluator computes {fmts}; resume with "
                    f"the same method list")
            ps = PipelineState.restore(state["pipeline"])
            if ps.sampler is not None and sampler is not None \
                    and ps.sampler != sampler:
                raise ValueError(
                    "eval state was written against a different mixing "
                    "configuration; resume over the same MixedDataSet "
                    "(weights/seed/children) it snapshotted")
            partials: List[Tuple[float, float]] = [
                (float(n), float(d)) for n, d in state["partials"]]
        else:
            ps = PipelineState(seed=dataset_seed(dataset), epoch=1,
                               offset=0, sampler=sampler)
            partials = [(0.0, 0.0) for _ in self.methods]

        it = epoch_iter(dataset, ps.epoch, train=False)
        if ps.offset:
            skipped = skip_batches(it, ps.offset)
            if skipped < ps.offset:
                raise ValueError(
                    f"eval state recorded {ps.offset} consumed batches "
                    f"but the epoch only has {skipped}; the dataset "
                    f"shrank since the snapshot — restart the sweep")
        consumed = 0
        for batch in it:
            scores = self._score(batch.get_input())
            partials = [
                (n + float(num), d + float(den))
                for (n, d), (num, den) in zip(
                    partials,
                    (m.batch_stats(scores) for m in self.methods))]
            ps.offset += 1
            consumed += 1
            if max_batches is not None and consumed >= max_batches:
                return None, self._snapshot(ps, partials)
        results = [m.to_result(n, d)
                   for m, (n, d) in zip(self.methods, partials)]
        return results, self._snapshot(ps, partials)

    def _snapshot(self, ps: PipelineState,
                  partials: List[Tuple[float, float]]) -> Dict:
        return {"version": EVAL_STATE_VERSION,
                "pipeline": ps.snapshot(),
                "partials": [[n, d] for n, d in partials],
                "methods": [m.fmt for m in self.methods]}
