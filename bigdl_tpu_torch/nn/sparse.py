"""Sparse-tensor layers (counterpart of ``bigdl_tpu/nn/sparse.py``, every
name): the fixed-capacity COO :class:`SparseTensor`, ``DenseToSparse``,
``SparseJoinTable``, ``SparseLinear``, ``LookupTableSparse``, and
:func:`dedup_gather`, the lookup whose backward lands one combined row per
unique id.

A :class:`SparseTensor` keeps the reference's layout: ``indices`` (nnz,
ndim) int32, ``values`` (nnz,) and the dense ``shape``; entries whose value
is 0 are padding, exact for every linear consumer here.  Sparse products
and embedding sums are a gather and a segment sum (``index_add``), as the
reference lowers them to gather and ``segment_sum``.

:func:`dedup_scatter_updates` sorts the ids stably and sums each id's rows
in sorted order.  On the CPU that sum is ``index_add_``, which adds the
rows one after another in index order, as XLA's CPU scatter does, so the
combined rows equal the reference's bit for bit.  On the card
``index_add_`` over repeated ids adds in atomic order, so the rows are
summed by a segmented scan of ceil(log2 n) rounds instead: a fixed order
(left to right for up to three occurrences, pairwise beyond), no host
read, so a CUDA graph captures it.  The final scatter into the zero table
lands one nonzero row per id and is exact in any order.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.nn.linear import Linear

__all__ = [
    "SparseTensor", "DenseToSparse", "SparseJoinTable", "SparseLinear",
    "LookupTableSparse", "dedup_gather", "dedup_scatter_updates",
]


def segment_totals(values: torch.Tensor, first: torch.Tensor) \
        -> torch.Tensor:
    """Each run's total at its first row, for rows already sorted into
    runs (``first`` marks a run's first row; the other rows get what
    ``dedup_scatter_updates`` zeroes).  The CPU sums a run's rows left to
    right (``index_add_``); the card by :func:`segment_scan`."""
    if values.device.type != "cpu":
        return segment_scan(values, first)
    seg = torch.cumsum(first, 0) - 1
    summed = torch.zeros_like(values).index_add_(0, seg, values)
    return summed[seg]


def segment_scan(values: torch.Tensor, first: torch.Tensor) \
        -> torch.Tensor:
    """A reverse segmented scan: after round r (distance d = 2^r) row i
    holds the sum of its run's rows in [i, i + 2d); ceil(log2 n) rounds
    leave each run's total at its first row.  Rounds and shapes depend on
    n only."""
    n = values.shape[0]
    run = torch.cumsum(first, 0)
    tail = (-1,) + (1,) * (values.dim() - 1)
    v = values
    d = 1
    while d < n:
        same = (run[d:] == run[:-d]).view(tail)
        v = torch.cat([torch.where(same, v[:-d] + v[d:], v[:-d]), v[-d:]])
        d *= 2
    return v


def dedup_scatter_updates(idx, grads) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine duplicate-row updates before a scatter-add.

    ``idx`` (N,) row ids with repeats, ``grads`` (N, ...) their
    per-occurrence updates.  Returns ``(rows, contrib)`` of the same
    shapes: the ids sorted (stably), each id's total update on its first
    occurrence in sorted order and exact zeros on the others, so
    ``zeros.index_add_(0, rows, contrib)`` lands one nonzero update per
    unique row."""
    idx = idx.reshape(-1)
    rows, order = torch.sort(idx, stable=True)
    sg = grads[order]
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    keep = first.view((-1,) + (1,) * (grads.dim() - 1)).to(grads.dtype)
    return rows, segment_totals(sg, first) * keep


class _DedupGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, idx):
        ctx.save_for_backward(idx)
        ctx.table = (w.shape[0], w.dtype)
        return w[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n_rows, dtype = ctx.table
        tail = tuple(g.shape[idx.dim():])
        rows, contrib = dedup_scatter_updates(idx, g.reshape((-1,) + tail))
        dw = torch.zeros((n_rows,) + tail, dtype=dtype, device=g.device)
        return dw.index_add_(0, rows, contrib.to(dtype)), None


def dedup_gather(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``w[idx]`` (0-based ``idx``, any shape) whose backward scatters ONE
    combined update per unique id (:func:`dedup_scatter_updates`) into a
    zero table of ``w``'s shape and dtype: the duplicate-heavy
    recommender batch's lookup."""
    return _DedupGather.apply(w, idx.long())


class SparseTensor:
    """Fixed-capacity n-D COO tensor (reference tensor/SparseTensor.scala):
    ``indices`` (nnz, ndim) int32, ``values`` (nnz,), ``shape`` the dense
    shape (a tuple of ints).  Zero-valued entries are padding."""

    __slots__ = ("indices", "values", "shape")

    def __init__(self, indices, values, shape: Sequence[int]):
        self.indices = torch.as_tensor(indices)
        self.values = torch.as_tensor(values)
        self.shape = tuple(int(s) for s in shape)

    def __repr__(self):
        return (f"SparseTensor(shape={self.shape}, "
                f"capacity={self.values.shape[0]})")

    def to_dense(self) -> torch.Tensor:
        """Duplicate entries add; indices past an edge are clipped to it
        (``ravel_multi_index(mode="clip")``)."""
        flat = torch.zeros(self.indices.shape[0], dtype=torch.long,
                           device=self.indices.device)
        for d, size in enumerate(self.shape):
            flat = flat * size + self.indices[:, d].long().clamp(0, size - 1)
        out = torch.zeros(math.prod(self.shape), dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add(0, flat, self.values).reshape(self.shape)

    @staticmethod
    def from_dense(x) -> "SparseTensor":
        """Capacity = full size; zero entries become padding."""
        x = torch.as_tensor(x)
        grid = torch.stack(torch.meshgrid(
            *[torch.arange(s, device=x.device) for s in x.shape],
            indexing="ij"), dim=-1).reshape(-1, x.dim()).to(torch.int32)
        return SparseTensor(grid, x.reshape(-1), x.shape)


def _segment_sum(data, ids, n: int):
    """Rows of ``data`` summed by ``ids`` into ``n`` rows (the reference's
    ``segment_sum``), differentiable in ``data``."""
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, ids.long(), data)


class DenseToSparse(Module):
    """Dense → COO (reference nn/DenseToSparse.scala), at full capacity."""

    def forward(self, x):
        return SparseTensor.from_dense(x)


class SparseJoinTable(Module):
    """Concatenate sparse tensors along ``dimension`` (1-based, reference
    nn/SparseJoinTable.scala)."""

    def __init__(self, dimension: int = 2):
        super().__init__()
        self.dimension = dimension

    def forward(self, tensors: Sequence[SparseTensor]) -> SparseTensor:
        d = self.dimension - 1
        offset = 0
        all_idx, all_val = [], []
        for t in tensors:
            idx = t.indices.clone()
            idx[:, d] += offset
            all_idx.append(idx)
            all_val.append(t.values)
            offset += t.shape[d]
        shape = list(tensors[0].shape)
        shape[d] = offset
        return SparseTensor(torch.cat(all_idx, 0), torch.cat(all_val, 0),
                            shape)


class SparseLinear(Module):
    """Linear layer over a sparse (batch, in) input (reference
    nn/SparseLinear.scala): each entry adds ``value * W[:, col]`` to its
    row.  The parameters are ``inner``'s, a :class:`Linear`."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, backward_start: int = -1,
                 backward_length: int = -1,
                 w_regularizer=None, b_regularizer=None,
                 init_weight=None, init_bias=None, *,
                 generator=None, device=None):
        super().__init__()
        self.inner = Linear(input_size, output_size, with_bias,
                            w_regularizer, b_regularizer,
                            generator=generator, device=device,
                            init_weight=init_weight, init_bias=init_bias)
        self.output_size = output_size

    @property
    def weight(self):
        return self.inner.weight

    @property
    def bias(self):
        return self.inner.bias

    def forward(self, x):
        if isinstance(x, (tuple, list)):
            raise ValueError("SparseLinear expects a single SparseTensor; "
                             "use SparseJoinTable to merge inputs first")
        rows = x.indices[:, 0]
        cols = x.indices[:, 1].long()
        contrib = x.values[:, None] * self.inner.weight.t()[cols]
        y = _segment_sum(contrib, rows, x.shape[0])
        if self.inner.with_bias:
            y = y + self.inner.bias
        return y


class LookupTableSparse(Module):
    """Embedding lookup over sparse id tensors with the ``sum`` / ``mean``
    / ``sqrtn`` combiners (reference nn/LookupTableSparse.scala, TF's
    embedding_lookup_sparse).  ``forward(ids)`` or ``forward((ids,
    weights))``: ``ids`` a SparseTensor (batch, maxlen) whose values are
    1-based ids (0 is padding), ``weights`` per-id weights in the same
    layout.  Output (batch, n_output).  ``max_norm > 0`` clips the
    gathered rows' L2 norms.  Weight ~ 0.05 N(0, 1)."""

    def __init__(self, n_index: int, n_output: int,
                 combiner: str = "sum", max_norm: float = -1.0,
                 w_regularizer=None, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(f"unknown combiner {combiner!r}: sum, mean "
                             "or sqrtn")
        self.n_index = n_index
        self.n_output = n_output
        self.combiner = combiner
        self.max_norm = max_norm
        self.w_regularizer = w_regularizer
        self.weight = nn.Parameter(
            (torch.randn((n_index, n_output), generator=generator) * 0.05)
            .to(resolve_device(device)))

    def forward(self, x):
        ids, weights = (x, None) if isinstance(x, SparseTensor) else x
        dev = self.weight.device
        rows = ids.indices[:, 0].to(dev)
        id_vals = ids.values.to(dev).to(torch.int32)
        present = (id_vals > 0).to(self.weight.dtype)
        emb = dedup_gather(self.weight,
                           (id_vals - 1).clamp(0, self.n_index - 1))
        if self.max_norm > 0:
            norms = torch.linalg.vector_norm(emb, dim=1, keepdim=True)
            emb = emb * torch.clamp(
                self.max_norm / torch.clamp(norms, min=1e-7), max=1.0)
        w = weights.values.to(dev) if weights is not None else present
        w = w * present
        batch = ids.shape[0]
        summed = _segment_sum(emb * w[:, None], rows, batch)
        if self.combiner == "sum":
            return summed
        if self.combiner == "mean":
            wsum = _segment_sum(w, rows, batch)
            return summed / torch.clamp(wsum, min=1e-7)[:, None]
        wsq = _segment_sum(w * w, rows, batch)
        return summed / torch.clamp(torch.sqrt(wsq), min=1e-7)[:, None]
