"""Table (tuple-activity) arithmetic and combination layers (counterpart
of ``bigdl_tpu/nn/table_ops.py``, every class).

A reference "Table" is a Python tuple or list here; dims are 1-based, as
the reference's, and a layer that returns a table returns a tuple.
"""

from __future__ import annotations

from functools import reduce

import torch
from torch import nn

from bigdl_tpu_torch.core.module import Module

__all__ = [
    "CAddTable", "CSubTable", "CMulTable", "CDivTable", "CMaxTable",
    "CMinTable", "CAveTable", "JoinTable", "SplitTable", "SelectTable",
    "NarrowTable", "FlattenTable", "MixtureTable", "DotProduct",
    "CosineDistance", "PairwiseDistance", "MM", "MV",
    "BifurcateSplitTable", "CrossProduct", "TableOperation",
]


class CAddTable(Module):
    """Elementwise sum of the table (reference nn/CAddTable.scala);
    ``inplace`` is accepted and changes nothing."""

    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, xs):
        return reduce(torch.add, xs)


class CSubTable(Module):
    def forward(self, xs):
        return xs[0] - xs[1]


class CMulTable(Module):
    def forward(self, xs):
        return reduce(torch.mul, xs)


class CDivTable(Module):
    def forward(self, xs):
        return xs[0] / xs[1]


class CMaxTable(Module):
    def forward(self, xs):
        return reduce(torch.maximum, xs)


class CMinTable(Module):
    def forward(self, xs):
        return reduce(torch.minimum, xs)


class CAveTable(Module):
    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, xs):
        return reduce(torch.add, xs) / len(xs)


def _dim(dimension: int, n_input_dims: int, ndim: int) -> int:
    """The 0-based dim of a 1-based ``dimension``, offset by the batch
    dims where the input has more than ``n_input_dims``."""
    d = dimension - 1
    if 0 < n_input_dims < ndim:
        d += ndim - n_input_dims
    return d


class JoinTable(Module):
    """Concatenate the table along ``dimension`` (reference
    nn/JoinTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, xs):
        return torch.cat(list(xs), dim=_dim(self.dimension,
                                            self.n_input_dims, xs[0].dim()))


class SplitTable(Module):
    """Split a tensor along ``dimension`` into a table of its slices
    (reference nn/SplitTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, x):
        d = _dim(self.dimension, self.n_input_dims, x.dim())
        return torch.unbind(x, dim=d + x.dim() if d < 0 else d)


class SelectTable(Module):
    """The ``index``-th element of the table (reference
    nn/SelectTable.scala; 1-based, negative from the end)."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, xs):
        return xs[self.index - 1 if self.index > 0 else len(xs) + self.index]


class NarrowTable(Module):
    """The sub-table of ``length`` elements from ``offset`` (reference
    nn/NarrowTable.scala; a negative length counts from the end)."""

    def __init__(self, offset: int, length: int = 1):
        super().__init__()
        self.offset, self.length = offset, length

    def forward(self, xs):
        length = self.length if self.length >= 0 \
            else len(xs) - self.offset + 2 + self.length
        return tuple(xs[self.offset - 1:self.offset - 1 + length])


class FlattenTable(Module):
    """Nested tables flattened into one, depth first (reference
    nn/FlattenTable.scala)."""

    def forward(self, xs):
        out = []

        def rec(t):
            if isinstance(t, (tuple, list)):
                for e in t:
                    rec(e)
            else:
                out.append(t)

        rec(xs)
        return tuple(out)


class MixtureTable(Module):
    """A mixture of experts (reference nn/MixtureTable.scala): (gater [b,
    n], experts as a table or a [b, n, ...] tensor) -> sum_i gater_i *
    expert_i.  ``dim`` is accepted and unused, as in the reference."""

    def __init__(self, dim: int = 2147483647):
        super().__init__()

    def forward(self, inputs):
        gater, experts = inputs
        stacked = torch.stack(list(experts), dim=1) \
            if isinstance(experts, (tuple, list)) else experts
        g = gater.reshape(gater.shape + (1,) * (stacked.dim() - gater.dim()))
        return (g * stacked).sum(dim=1)


class DotProduct(Module):
    """Row-wise dot product of two inputs (reference nn/DotProduct.scala)."""

    def forward(self, inputs):
        a, b = inputs
        return (a * b).sum(dim=-1)


class CosineDistance(Module):
    """Row-wise cosine similarity (reference nn/CosineDistance.scala)."""

    def forward(self, inputs):
        a, b = inputs
        an = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-12)
        bn = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-12)
        return (an * bn).sum(dim=-1)


class PairwiseDistance(Module):
    """Row-wise Lp distance (reference nn/PairwiseDistance.scala)."""

    def __init__(self, norm: int = 2):
        super().__init__()
        self.norm = norm

    def forward(self, inputs):
        a, b = inputs
        return torch.linalg.vector_norm(a - b, ord=self.norm, dim=-1)


class MM(Module):
    """A (batched) matrix-matrix product with optional transposes
    (reference nn/MM.scala)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False):
        super().__init__()
        self.trans_a, self.trans_b = trans_a, trans_b

    def forward(self, inputs):
        a, b = inputs
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return a @ b


class MV(Module):
    """A (batched) matrix-vector product (reference nn/MV.scala)."""

    def __init__(self, trans: bool = False):
        super().__init__()
        self.trans = trans

    def forward(self, inputs):
        m, v = inputs
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class BifurcateSplitTable(Module):
    """Split a tensor into two halves along ``dimension`` (reference
    nn/BifurcateSplitTable.scala)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        d = self.dimension - 1
        half = x.shape[d] // 2
        return (x.narrow(d, 0, half), x.narrow(d, half, x.shape[d] - half))


class CrossProduct(Module):
    """The dot products of every pair of table entries, in (i, j > i)
    order (reference nn/CrossProduct.scala); the arguments are accepted
    and unused, as in the reference."""

    def __init__(self, num_tensor: int = 0, embedding_size: int = 0):
        super().__init__()

    def forward(self, xs):
        outs = [(xs[i] * xs[j]).sum(dim=-1, keepdim=True)
                for i in range(len(xs)) for j in range(i + 1, len(xs))]
        return torch.cat(outs, dim=-1)


class TableOperation(Module):
    """A two-input table layer (``CMulTable``, ``CSubTable`` ...) applied
    after broadcasting the smaller tensor to the larger one's shape
    (reference nn/TableOperation.scala)."""

    def __init__(self, operation_layer: nn.Module):
        super().__init__()
        self.operation_layer = operation_layer

    def forward(self, inputs):
        a, b = inputs
        if a.numel() > b.numel():
            b = b.expand(a.shape)
        elif b.numel() > a.numel():
            a = a.expand(b.shape)
        return self.operation_layer((a, b))
