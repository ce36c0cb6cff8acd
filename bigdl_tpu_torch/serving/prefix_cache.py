"""Prefix KV cache: token-id-keyed reuse of prefill K/V across requests
(counterpart of ``bigdl_tpu/serving/prefix_cache.py``).

The K/V of position ``t`` depend only on tokens ``0..t`` (causal
attention), so two prompts sharing a prefix share that prefix's K/V.
The cache stores prefill K/V at a fixed chunk **granularity** ``G`` (a
power of two), keyed by the FULL token prefix up to and including the
chunk: ``key(i) = tokens[:i*G].tobytes()`` for chunk ``i`` (1-based),
since K/V are position- and history-dependent.  A lookup walks chunk
boundaries ``G, 2G, ...`` and returns the longest contiguous chain of
cached chunks; the engine copies the chain into the admitted request's
slot row and prefills only the rest.

Entries hold device tensors (a hit is copied on the device, never
through the host), and the LRU budget is in bytes counted from tensor
metadata only, so an insert never waits on the device.  Eviction drops
only the cache's reference: a chain already matched keeps its tensors
alive.  Every engine that shares one cache issues its copies on the
same (default) stream, so a copy queued after an insert reads the
inserted values, and the caching allocator cannot hand an evicted
chunk's block to another tensor while a queued copy still reads it.

Every mutation and read takes ``self._lock``: one cache may be shared by
two engines (the disaggregated prefill/decode split), and ``stats()`` is
read from any thread.

Single-flight prefill: :meth:`claim_prefill` / :meth:`prefill_owner` /
:meth:`release_prefill` let the first request that needs an uncached
chunk claim it as the in-flight LEADER; later requests seeing an owned
key park as FOLLOWERS until the leader's insert lands (or its claim is
released on failure), then re-match and hit.  The registry is keyed by
the same full-prefix keys, so it deduplicates across engines sharing
one cache too.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["PrefixKVCache", "PrefixChunk"]


class PrefixChunk:
    """One cached chunk: per-layer K/V (``[heads, G, head_dim]`` device
    tensors) and padding flags (``[G]`` bool) for prompt positions
    ``[index, index+G)``, valid only after the exact token prefix the
    key encodes."""

    __slots__ = ("key", "index", "layers", "pad", "nbytes")

    def __init__(self, key: bytes, index: int, layers: Sequence[Dict],
                 pad) -> None:
        self.key = key
        self.index = int(index)
        self.layers = list(layers)
        self.pad = pad
        # sizes from metadata only: the tensors are usually copies still
        # queued on the device, and reading one here would block the
        # engine thread on every insert
        n = pad.numel() * pad.element_size()
        for lay in self.layers:
            for t in lay.values():
                n += t.numel() * t.element_size()
        self.nbytes = int(n)


class PrefixKVCache:
    """LRU byte-budgeted map from token-prefix keys to
    :class:`PrefixChunk` entries at fixed granularity ``G``."""

    def __init__(self, byte_budget: int, granularity: int) -> None:
        if byte_budget < 1:
            raise ValueError(
                f"byte_budget must be >= 1, got {byte_budget} (pass "
                f"prefix_cache_bytes=None to disable caching instead)")
        if granularity < 2 or granularity & (granularity - 1):
            raise ValueError(
                f"granularity must be a power of two >= 2 (a bucket "
                f"width), got {granularity}")
        self.byte_budget = int(byte_budget)
        self.granularity = int(granularity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, PrefixChunk]" = OrderedDict()
        self._inflight: Dict[bytes, object] = {}
        self._bytes = 0
        self._lookups = 0
        self._hits = 0
        self._misses = 0
        self._chunks_hit = 0
        self._bytes_reused = 0
        self._inserts = 0
        self._evictions = 0

    @staticmethod
    def _tokens(tokens) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(tokens, np.int32))

    # ---- lookup ----------------------------------------------------------

    def match(self, tokens) -> List[PrefixChunk]:
        """Longest chain of cached chunks covering a prefix of
        ``tokens`` (the prompt's prefill region).  ``[]`` on a miss; a
        chain ``c`` covers positions ``[0, len(c)*G)``.  Prompts shorter
        than one granule are uncacheable and count as neither hit nor
        miss."""
        toks = self._tokens(tokens)
        g = self.granularity
        m = len(toks) // g
        chain: List[PrefixChunk] = []
        with self._lock:
            if m < 1:
                return chain
            self._lookups += 1
            for i in range(1, m + 1):
                entry = self._entries.get(toks[:i * g].tobytes())
                if entry is None:
                    break
                self._entries.move_to_end(entry.key)
                chain.append(entry)
            if chain:
                self._hits += 1
                self._chunks_hit += len(chain)
                self._bytes_reused += sum(c.nbytes for c in chain)
            else:
                self._misses += 1
        return chain

    def missing_boundaries(self, tokens) -> List[int]:
        """Chunk indices ``i`` (1-based) whose prefix ``tokens[:i*G]`` is
        not cached yet: what the engine extracts and inserts after
        prefilling this prompt."""
        toks = self._tokens(tokens)
        g = self.granularity
        with self._lock:
            return [i for i in range(1, len(toks) // g + 1)
                    if toks[:i * g].tobytes() not in self._entries]

    def boundary_key(self, tokens, chunk_index: int) -> bytes:
        """The key of chunk ``chunk_index`` (1-based) of ``tokens``: the
        full token prefix up to and including it."""
        return self._tokens(tokens)[:chunk_index * self.granularity] \
            .tobytes()

    # ---- single-flight prefill (in-flight dedup) -------------------------

    def claim_prefill(self, keys: Sequence[bytes], owner) -> List[bytes]:
        """Register ``owner`` as the in-flight prefiller of every key in
        ``keys`` that is neither cached nor claimed; returns the keys
        claimed.  ``owner`` is an identity token, compared by ``is``."""
        claimed: List[bytes] = []
        with self._lock:
            for k in keys:
                if k in self._entries or k in self._inflight:
                    continue
                self._inflight[k] = owner
                claimed.append(k)
        return claimed

    def prefill_owner(self, key: bytes) -> Optional[object]:
        """The in-flight owner of ``key``, None when nobody prefills it."""
        with self._lock:
            return self._inflight.get(key)

    def release_prefill(self, owner) -> None:
        """Drop every in-flight claim held by ``owner`` (its insert
        landed, or its prefill failed and a follower must re-claim).
        Safe when ``owner`` holds nothing."""
        with self._lock:
            for k in [k for k, o in self._inflight.items() if o is owner]:
                del self._inflight[k]

    # ---- insertion / eviction -------------------------------------------

    def insert(self, tokens, chunk_index: int, layers: Sequence[Dict],
               pad) -> Optional[PrefixChunk]:
        """Cache the K/V of chunk ``chunk_index`` (1-based: positions
        ``[(i-1)*G, i*G)``) of ``tokens``.  A chunk larger than the whole
        budget is refused (it could never be kept)."""
        toks = self._tokens(tokens)
        g = self.granularity
        key = toks[:chunk_index * g].tobytes()
        entry = PrefixChunk(key, (chunk_index - 1) * g, layers, pad)
        if entry.nbytes > self.byte_budget:
            return None
        with self._lock:
            # resident from here on: a claim on it is moot, and
            # followers must see owner None
            self._inflight.pop(key, None)
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = entry
            self._bytes += entry.nbytes
            self._inserts += 1
            while self._bytes > self.byte_budget and self._entries:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self._evictions += 1
        return entry

    # ---- observability ---------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "granularity": self.granularity,
                "byte_budget": self.byte_budget,
                "resident_bytes": self._bytes,
                "entries": len(self._entries),
                "lookups": self._lookups,
                "hits": self._hits,
                "misses": self._misses,
                "hit_rate": (self._hits / self._lookups
                             if self._lookups else 0.0),
                "chunks_hit": self._chunks_hit,
                "bytes_reused": self._bytes_reused,
                "inserts": self._inserts,
                "evictions": self._evictions,
                "inflight_prefills": len(self._inflight),
            }
