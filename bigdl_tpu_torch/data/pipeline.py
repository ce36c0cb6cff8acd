"""Checkpointable input-pipeline state: sample-accurate resume
(counterpart of ``bigdl_tpu/data/pipeline.py``).

The datasets' determinism contract (``dataset/dataset.py``: epoch E's
order is a pure function of ``(seed, E)``) makes an iterator's position
three integers instead of an opaque generator state.
:class:`PipelineState` holds that position (``seed``, ``epoch``, the
batches consumed in it) and the ``CheckpointManager`` writes it beside
the payload, CRC'd in the same manifest.  On resume the Optimizer
rebuilds epoch E's iterator and skips the consumed batches, so training
goes on at the exact next batch: no sample replayed, none skipped.  The
cost is regenerating the skipped batches on the host.

The topology-portable fields (``global_offset``, ``process_count``,
``global_batch``) are written as the reference writes them; the port
restores onto the same topology only (one process), and a snapshot from
another replays its epoch from the start (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Iterator, Optional

__all__ = ["PIPELINE_STATE_VERSION", "PipelineState", "epoch_iter",
           "skip_batches", "skip_samples", "supports_epoch",
           "dataset_seed"]

PIPELINE_STATE_VERSION = 1


class PipelineState:
    """An input pipeline's position: ``seed`` (the permutation seed of
    the epoch orders), ``epoch`` (the epoch being consumed), ``offset``
    (batches consumed in it by the writing process), ``global_offset`` /
    ``process_count`` / ``global_batch`` (samples consumed in the epoch
    by all processes, their number and the global batch) and ``sampler``
    (a mixing sampler's configuration, where the dataset has one).
    ``snapshot()`` and ``restore()`` go through a plain JSON-able dict,
    the sidecar's format."""

    __slots__ = ("seed", "epoch", "offset", "sampler", "global_offset",
                 "process_count", "global_batch")

    def __init__(self, seed: int, epoch: int = 1, offset: int = 0,
                 sampler: Optional[Dict] = None,
                 global_offset: Optional[int] = None,
                 process_count: Optional[int] = None,
                 global_batch: Optional[int] = None):
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.offset = int(offset)
        self.sampler = sampler
        self.global_offset = (None if global_offset is None
                              else int(global_offset))
        self.process_count = (None if process_count is None
                              else int(process_count))
        self.global_batch = (None if global_batch is None
                             else int(global_batch))

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"version": PIPELINE_STATE_VERSION,
                               "seed": self.seed, "epoch": self.epoch,
                               "offset": self.offset}
        for key in ("global_offset", "process_count", "global_batch",
                    "sampler"):
            if getattr(self, key) is not None:
                out[key] = getattr(self, key)
        return out

    @classmethod
    def restore(cls, snapshot: Dict[str, Any]) -> "PipelineState":
        v = snapshot.get("version")
        if v != PIPELINE_STATE_VERSION:
            raise ValueError(
                f"unsupported pipeline-state version {v!r} "
                f"(supported: {PIPELINE_STATE_VERSION})")
        return cls(seed=snapshot["seed"], epoch=snapshot["epoch"],
                   offset=snapshot.get("offset", 0),
                   sampler=snapshot.get("sampler"),
                   global_offset=snapshot.get("global_offset"),
                   process_count=snapshot.get("process_count"),
                   global_batch=snapshot.get("global_batch"))

    def __repr__(self) -> str:
        return (f"PipelineState(seed={self.seed}, epoch={self.epoch}, "
                f"offset={self.offset}, "
                f"global_offset={self.global_offset})")


def dataset_seed(dataset) -> int:
    """The permutation seed a dataset iterates under: its own ``seed()``
    where it has one, else 0 (the port has no process-wide seed)."""
    seed = getattr(dataset, "seed", None)
    if callable(seed):
        try:
            return int(seed())
        except (TypeError, ValueError):
            pass
    return 0


def supports_epoch(dataset) -> bool:
    """Does ``dataset.data`` take the ``epoch`` keyword, that is, is its
    order replayable after a restart?"""
    try:
        params = inspect.signature(dataset.data).parameters
    except (TypeError, ValueError):
        return False
    return "epoch" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def epoch_iter(dataset, epoch: int, train: bool = True) -> Iterator:
    """Epoch ``epoch``'s iterator, passing the epoch where ``data()``
    takes it (a wrapper without the keyword is iterated as it is: not
    replayable after a restart, so a resume replays its epoch)."""
    if supports_epoch(dataset):
        return dataset.data(train=train, epoch=int(epoch))
    return dataset.data(train=train)


def skip_batches(it: Iterator, n: int) -> int:
    """Advance ``it`` past ``n`` batches; returns how many it skipped
    (fewer: the epoch is shorter than the recorded offset)."""
    skipped = 0
    for _ in range(int(n)):
        try:
            next(it)
        except StopIteration:
            break
        skipped += 1
    return skipped


def skip_samples(it: Iterator, n_samples: int) -> tuple:
    """Advance ``it`` until ``n_samples`` samples (the sum of
    ``b.size()``) are consumed; returns ``(batches, samples)`` skipped.
    More samples than asked means the point lies inside a batch, fewer
    that the epoch is shorter."""
    want = int(n_samples)
    batches = samples = 0
    while samples < want:
        try:
            b = next(it)
        except StopIteration:
            break
        batches += 1
        samples += int(b.size())
    return batches, samples
