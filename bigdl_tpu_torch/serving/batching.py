"""Bucket sizes for padded batching (counterpart of ``bucket_sizes`` and
``pick_bucket`` in ``bigdl_tpu/serving/batching.py``).  The generation
engine draws its prompt-length and chunk-width buckets from here."""

from __future__ import annotations

from typing import List, Sequence, Tuple

__all__ = ["bucket_sizes", "pick_bucket"]


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
