"""Transformer pipeline stages (counterpart of ``Transformer``,
``Identity``, ``FeatureLabelTransformer`` and ``SampleToMiniBatch`` in
``bigdl_tpu/dataset/transformer.py``): iterator-to-iterator stages on
the host, chained with ``a >> b`` (the reference's ``a -> b``)."""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np

from bigdl_tpu_torch.dataset.dataset import MiniBatch, Sample

__all__ = ["Transformer", "Identity", "SampleToMiniBatch",
           "FeatureLabelTransformer"]


class Transformer:
    """Iterator -> iterator stage."""

    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterator) -> Iterator:
        return self.apply(it)

    def __rshift__(self, other: "Transformer") -> "Transformer":
        return _Chained(self, other)


class _Chained(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def apply(self, it):
        return self.second(self.first(it))


class Identity(Transformer):
    def apply(self, it):
        return it


class FeatureLabelTransformer(Transformer):
    """Map a function over each Sample's feature (and label)."""

    def __init__(self, feature_fn: Optional[Callable] = None,
                 label_fn: Optional[Callable] = None):
        self.feature_fn = feature_fn
        self.label_fn = label_fn

    def apply(self, it):
        for s in it:
            f = self.feature_fn(s.feature) if self.feature_fn else s.feature
            l = self.label_fn(s.label) if self.label_fn else s.label
            yield Sample(f, l)


def _pad_to(arr: np.ndarray, shape, value):
    return np.pad(arr, [(0, t - s) for s, t in zip(arr.shape, shape)],
                  constant_values=value)


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches of numpy arrays.  With
    ``padding_value``, variable-length features (and labels) are
    right-padded to the batch's largest; ``drop_last`` (the reference's
    default, True) drops a ragged tail."""

    def __init__(self, batch_size: int,
                 padding_value: Optional[float] = None,
                 drop_last: bool = True):
        self.batch_size = batch_size
        self.padding_value = padding_value
        self.drop_last = drop_last

    def apply(self, it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._collate(buf)

    def _collate(self, samples):
        feats = [np.asarray(s.feature) for s in samples]
        if self.padding_value is not None:
            shape = tuple(max(f.shape[i] for f in feats)
                          for i in range(feats[0].ndim))
            feats = [_pad_to(f, shape, self.padding_value) for f in feats]
        y = None
        if samples[0].label is not None:
            labels = [np.asarray(s.label) for s in samples]
            if self.padding_value is not None and labels[0].ndim > 0:
                shape = tuple(max(l.shape[i] for l in labels)
                              for i in range(labels[0].ndim))
                labels = [_pad_to(l, shape, self.padding_value)
                          for l in labels]
            y = np.stack(labels)
        return MiniBatch(np.stack(feats), y)
