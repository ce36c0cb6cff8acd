"""Feature-column preprocessing ops (counterpart of
``bigdl_tpu/ops/feature_columns.py``): the wide-and-deep input path.

Reference: nn/ops/{CategoricalColHashBucket, CategoricalColVocaList,
CrossCol, IndicatorCol, MkString, Kv2Tensor}.scala, the TF
feature-column ops BigDL runs on the host over String tensors.  They are
host ops here too: inputs are numpy object/str arrays of shape [batch] or
[batch, 1], multi-value features delimiter-joined strings; sparse outputs
are the port's :class:`~bigdl_tpu_torch.nn.sparse.SparseTensor` (CPU
tensors), dense ones numpy arrays, as the reference returns them.

Hashing is Java's ``String.hashCode`` (``s[0]*31^(n-1) + ...`` wrapped to
a signed 32-bit int), a copy of the reference's: Python's ``hash`` is
salted per process, which would make crossing irreproducible.

Ids are 1-BASED (1..n, 0 = padding), as the reference's, since the
fixed-capacity SparseTensor and LookupTableSparse take 0 as the padding
sentinel.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.nn.sparse import SparseTensor

__all__ = [
    "CategoricalColHashBucket", "CategoricalColVocaList", "CrossCol",
    "IndicatorCol", "MkString", "Kv2Tensor", "java_string_hash",
]


def java_string_hash(s: str) -> int:
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    # interpret as signed 32-bit like the JVM
    return h - (1 << 32) if h >= (1 << 31) else h


def _rows(x) -> List[str]:
    arr = np.asarray(x, dtype=object).reshape(-1)
    return ["" if v is None else str(v) for v in arr]


def _host(t) -> np.ndarray:
    """A SparseTensor's indices or values as a host array."""
    return np.asarray(t.cpu()) if hasattr(t, "cpu") else np.asarray(t)


def _to_sparse(indices0, indices1, values, shape, dtype=np.int32):
    idx = np.stack([np.asarray(indices0, np.int32),
                    np.asarray(indices1, np.int32)], axis=1) \
        if len(indices0) else np.zeros((0, 2), np.int32)
    return SparseTensor(idx, np.asarray(values, dtype), shape)


def _categorical_forward(x, delimiter: str, value_fn, is_sparse: bool):
    """Shared split/collect scaffolding for the categorical ops:
    value_fn(feature_string) -> 1-based id."""
    rows = _rows(x)
    i0, i1, vals = [], [], []
    max_cols = 1
    for r, row in enumerate(rows):
        feats = [f for f in row.split(delimiter) if f != ""]
        max_cols = max(max_cols, len(feats))
        for c, f in enumerate(feats):
            i0.append(r)
            i1.append(c)
            vals.append(value_fn(f))
    shape = (len(rows), max_cols)
    if is_sparse:
        return _to_sparse(i0, i1, vals, shape)
    dense = np.zeros(shape, np.int32)  # 0 = padding/missing
    for r, c, v in zip(i0, i1, vals):
        dense[r, c] = v
    return dense


class CategoricalColHashBucket(Module):
    """String feature → hash-bucket ids
    (nn/ops/CategoricalColHashBucket.scala): ``id = hash(s) %
    hash_bucket_size``; multi-value features split on ``str_delimiter``;
    sparse output by default."""

    def __init__(self, hash_bucket_size: int, str_delimiter: str = ",",
                 is_sparse: bool = True):
        super().__init__()
        assert hash_bucket_size > 1
        self.hash_bucket_size = hash_bucket_size
        self.str_delimiter = str_delimiter
        self.is_sparse = is_sparse

    def _bucket(self, s: str) -> int:
        return java_string_hash(s) % self.hash_bucket_size + 1

    def forward(self, x):
        return _categorical_forward(x, self.str_delimiter, self._bucket,
                                    self.is_sparse)


class CategoricalColVocaList(Module):
    """String feature → vocabulary indices
    (nn/ops/CategoricalColVocaList.scala).  Unknown values map to
    ``len(vocab)`` when ``is_set_default`` else raise (strict)."""

    def __init__(self, vocab_list: Sequence[str], str_delimiter: str = ",",
                 is_set_default: bool = False, is_sparse: bool = True):
        super().__init__()
        self.vocab = {v: i for i, v in enumerate(vocab_list)}
        self.str_delimiter = str_delimiter
        self.is_set_default = is_set_default
        self.is_sparse = is_sparse

    def _index(self, f: str) -> int:
        if f not in self.vocab and not self.is_set_default:
            raise ValueError(
                f"value {f!r} not in the vocabulary (pass "
                f"is_set_default=True to map it to the default bucket)")
        return self.vocab.get(f, len(self.vocab)) + 1

    def forward(self, x):
        return _categorical_forward(x, self.str_delimiter, self._index,
                                    self.is_sparse)


class CrossCol(Module):
    """Cross N categorical columns into hashed ids
    (nn/ops/CrossCol.scala, ≙ tf.feature_column.crossed_column):
    the cartesian product of each row's feature sets, joined with '_',
    hashed into ``hash_bucket_size``."""

    def __init__(self, hash_bucket_size: int, str_delimiter: str = ","):
        super().__init__()
        self.hash_bucket_size = hash_bucket_size
        self.str_delimiter = str_delimiter

    def forward(self, columns):
        col_rows = [_rows(c) for c in columns]
        n = len(col_rows[0])
        assert all(len(c) == n for c in col_rows), "ragged batch"
        i0, i1, vals = [], [], []
        max_cols = 1
        for r in range(n):
            crossed = [""]
            for col in col_rows:
                feats = [f for f in col[r].split(self.str_delimiter)
                         if f != ""]
                crossed = [f"{a}_{f}" if a else f
                           for a in crossed for f in feats]
            max_cols = max(max_cols, len(crossed))
            for c, s in enumerate(crossed):
                i0.append(r)
                i1.append(c)
                vals.append(
                    java_string_hash(s) % self.hash_bucket_size + 1)
        return _to_sparse(i0, i1, vals, (n, max_cols))


class IndicatorCol(Module):
    """Sparse categorical ids → multi-hot dense (nn/ops/IndicatorCol.scala):
    output [batch, feat_len] with 1.0 at each id (counts when an id
    repeats)."""

    def __init__(self, feat_len: int, is_count: bool = True):
        super().__init__()
        self.feat_len = feat_len
        self.is_count = is_count

    def forward(self, sp: SparseTensor):
        idx = _host(sp.indices)
        vals = _host(sp.values).astype(np.int64)
        batch = int(sp.shape[0])
        out = np.zeros((batch, self.feat_len), np.float32)
        for (r, _c), v in zip(idx, vals):
            if v == 0:
                continue  # padding sentinel
            if 1 <= v <= self.feat_len:
                if self.is_count:
                    out[r, v - 1] += 1.0
                else:
                    out[r, v - 1] = 1.0
        return out


class MkString(Module):
    """Sparse rows → delimiter-joined strings (nn/ops/MkString.scala)."""

    def __init__(self, str_delimiter: str = ","):
        super().__init__()
        self.str_delimiter = str_delimiter

    def forward(self, sp: SparseTensor):
        idx = _host(sp.indices)
        vals = _host(sp.values)
        batch = int(sp.shape[0])
        rows: List[List[str]] = [[] for _ in range(batch)]
        for (r, _c), v in zip(idx, vals):
            if float(v) == 0.0:
                continue  # padding sentinel
            rows[r].append(str(int(v)) if float(v).is_integer()
                           else str(v))
        return np.asarray([self.str_delimiter.join(r) for r in rows],
                          dtype=object)


class Kv2Tensor(Module):
    """``"k:v,k:v"`` strings → dense [batch, feat_len]
    (nn/ops/Kv2Tensor.scala).  ``forward((kv_strings, feat_len))``."""

    def __init__(self, kv_delimiter: str = ",", item_delimiter: str = ":",
                 trans_type: int = 0):
        super().__init__()
        self.kv_delimiter = kv_delimiter
        self.item_delimiter = item_delimiter
        self.trans_type = trans_type

    def forward(self, inputs):
        kv, feat_len = inputs
        feat_len = int(feat_len)
        rows = _rows(kv)
        i0, i1, vals = [], [], []
        for r, row in enumerate(rows):
            for pair in row.split(self.kv_delimiter):
                if not pair:
                    continue
                k, _, v = pair.partition(self.item_delimiter)
                key = int(k)
                if not 0 <= key < feat_len:
                    raise ValueError(
                        f"Kv2Tensor: key {key} out of range "
                        f"[0, {feat_len}) in row {r} ({row!r})")
                i0.append(r)
                i1.append(key)
                vals.append(float(v))
        shape = (len(rows), feat_len)
        if self.trans_type == 1:
            return _to_sparse(i0, i1, vals, shape, np.float32)
        out = np.zeros(shape, np.float32)
        for r, c, v in zip(i0, i1, vals):
            out[r, c] += v  # duplicate keys sum, matching sparse mode
        return out
