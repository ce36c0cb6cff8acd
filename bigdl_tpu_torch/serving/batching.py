"""Bucketed dynamic batching (counterpart of
``bigdl_tpu/serving/batching.py``).

Concurrent single-sample requests are coalesced into padded batches at
a few bucket sizes, powers of two up to ``max_batch``.  The reference
keeps XLA's compile cache to ``log2(max_batch) + 1`` shapes this way;
the port keeps the same buckets, so a batch runs at the shapes warmup
ran and the two packages pad alike.  Ragged tails pad and drop exactly
like ``optim.predictor._pad_batch``: the last real sample is repeated up
to the bucket size and the padding rows are dropped on the host.  The
generation engine draws its prompt-length and chunk-width buckets from
here too.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.optim.predictor import _pad_batch

__all__ = ["bucket_sizes", "pick_bucket", "stack_requests", "split_outputs"]


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to and including ``max_batch``.  A non-power-of-
    two ``max_batch`` is kept as the terminal bucket so the configured
    capacity is always reachable (e.g. 24 → (1, 2, 4, 8, 16, 24))."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes: List[int] = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n``."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {buckets[-1]}")


def stack_requests(samples: Sequence, bucket: int):
    """Stack per-sample arrays (or tuples of arrays) along a new leading
    axis and pad to ``bucket`` rows by repeating the last sample.  N
    tuple-samples of k arrays become a k-tuple of ``[bucket, ...]``
    arrays, the layout a multi-input forward takes."""
    if not samples:
        raise ValueError("cannot stack an empty request list")
    first = samples[0]
    if isinstance(first, (tuple, list)):
        cols = tuple(np.stack([np.asarray(s[i]) for s in samples])
                     for i in range(len(first)))
        return _pad_batch(cols, bucket)
    return _pad_batch(np.stack([np.asarray(s) for s in samples]), bucket)


def split_outputs(y, n: int) -> List:
    """Drop the padding rows and split a batched output into per-request
    rows; a tuple output (a multi-head model) splits into per-request
    tuples."""
    if isinstance(y, (tuple, list)):
        cols = [np.asarray(a) for a in y]
        return [tuple(c[i] for c in cols) for i in range(n)]
    arr = np.asarray(y)
    return [arr[i] for i in range(n)]
