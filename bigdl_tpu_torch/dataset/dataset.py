"""Sample, MiniBatch and the single-host datasets (counterpart of
``epoch_permutation``, ``Sample``, ``MiniBatch``, ``DataSet.array``,
``LocalDataSet`` and ``DeviceCachedDataSet`` in
``bigdl_tpu/dataset/dataset.py``).

The determinism contract is the reference's: epoch E's order is
:func:`epoch_permutation` of ``(seed, E)``, numpy only, so the port
visits batches in exactly the reference's order.  The reference falls
back to its process-wide seed; the port has none, so a shuffled dataset
takes an explicit ``seed``.  :meth:`LocalDataSet.cache_on_device` is the
counterpart of the reference's HBM cache: the batches are copied to the
card once and served from there every epoch.  ``transform`` appends a
``Transformer`` stage (``dataset/transformer.py``) to a copy of the
dataset, as the reference's ``dataset -> transformer`` does.
"""

from __future__ import annotations

import copy as _copy
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.core.device import resolve_device

__all__ = ["Sample", "MiniBatch", "DataSet", "LocalDataSet",
           "DeviceCachedDataSet", "epoch_permutation"]


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """The canonical epoch-keyed order: a permutation of ``range(n)``
    that is a pure function of ``(seed, epoch)`` (the reference's, bit
    for bit)."""
    ss = np.random.SeedSequence([int(seed) % (2 ** 63), int(epoch)])
    return np.random.default_rng(ss).permutation(int(n))


class Sample:
    """One training example: feature tensor(s) and label tensor(s)."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label=None):
        self.feature = feature
        self.label = label

    def __repr__(self):
        f = getattr(self.feature, "shape", None)
        l = getattr(self.label, "shape", None)
        return f"Sample(feature={f}, label={l})"


class MiniBatch:
    """A batch of stacked features and labels (numpy arrays or tensors)."""

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target

    def size(self) -> int:
        x = self.input[0] if isinstance(self.input, (tuple, list)) \
            else self.input
        return x.shape[0]


class DataSet:
    """Factory namespace (the reference's ``DataSet``)."""

    @staticmethod
    def array(data: Sequence, shuffle: bool = True,
              seed: Optional[int] = None) -> "LocalDataSet":
        return LocalDataSet(list(data), shuffle=shuffle, seed=seed)


class LocalDataSet:
    """Single-host dataset over an in-memory list.  Epoch ``E``'s order
    is :func:`epoch_permutation` of ``(seed, E)`` when shuffled, the list
    order otherwise."""

    def __init__(self, data: List, shuffle: bool = True,
                 seed: Optional[int] = None):
        if shuffle and seed is None:
            raise ValueError(
                "a shuffled dataset needs an explicit seed: the port has "
                "no process-wide seed to fall back on")
        self._data = data
        self._shuffle = shuffle
        self._seed = seed
        self._transformers: list = []

    def seed(self) -> int:
        """The shuffle seed this dataset derives epoch orders from (0
        when unshuffled: the order does not depend on it)."""
        return int(self._seed or 0)

    def transform(self, transformer) -> "LocalDataSet":
        """A copy of this dataset with ``transformer`` appended to its
        stages (the data list is shared, never reordered)."""
        out = _copy.copy(self)
        out._transformers = self._transformers + [transformer]
        return out

    def __rshift__(self, transformer):
        return self.transform(transformer)

    def size(self) -> int:
        return len(self._data)

    def data(self, train: bool = True, epoch: int = 0) -> Iterator:
        """Epoch ``epoch``'s pass through the stages; shuffled when
        training and ``shuffle``.  (The reference also counts epochs
        itself when none is given; every caller here passes one.)"""
        order = (epoch_permutation(len(self._data), self.seed(), epoch)
                 if train and self._shuffle else np.arange(len(self._data)))
        it = (self._data[i] for i in order)
        for t in self._transformers:
            it = t(it)
        return it

    def cache_on_device(self, device=None) -> "DeviceCachedDataSet":
        """Serve the batches from device memory (default ``cuda``): each
        array is copied to the device once, on first use."""
        return DeviceCachedDataSet(self, device=device)


class DeviceCachedDataSet:
    """Device-resident MiniBatches, copied from the wrapped dataset on the
    first epoch, deduplicated by identity (a buffer shared by many
    batches is copied once); epoch orders re-permute the cached list.
    Cached per mode (train/eval), as the reference caches them."""

    def __init__(self, inner: LocalDataSet, device=None):
        self._inner = inner
        self._device = resolve_device(device)
        self._cache: dict = {}

    def size(self) -> int:
        return self._inner.size()

    def seed(self) -> int:
        return self._inner.seed()

    def _put(self, memo, value):
        if value is None:
            return None
        if isinstance(value, (tuple, list)):
            return type(value)(self._put(memo, v) for v in value)
        # memo keeps the source alive: a freed array's id() is recycled
        key = id(value)
        if key not in memo:
            memo[key] = (value, torch.as_tensor(value).to(self._device))
        return memo[key][1]

    def data(self, train: bool = True, epoch: int = 0) -> Iterator:
        key = bool(train)
        cache = self._cache.get(key)
        if cache is None:
            memo: dict = {}
            cache = self._cache[key] = [
                MiniBatch(self._put(memo, b.get_input()),
                          self._put(memo, b.get_target()))
                for b in self._inner.data(train=train, epoch=0)]
        order = np.arange(len(cache))
        if train and self._inner._shuffle:
            order = epoch_permutation(len(cache), self.seed(), int(epoch))
        return (cache[i] for i in order)
