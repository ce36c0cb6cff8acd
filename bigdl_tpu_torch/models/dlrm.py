"""Wide-and-deep recommender (counterpart of ``bigdl_tpu/models/dlrm.py``):
four embedding tables (deep user and item vectors, and dim-1 wide
per-id biases, the memorization term of Cheng et al.'s wide component)
feeding a dense MLP tower.  Input is a ``[..., 2]`` (user, item) id-pair
tensor, 1-based like :class:`~bigdl_tpu_torch.models.ncf.NeuralCF`, so
one forward scores training pairs ``[B, 2]`` and ranking slates
``[B, 1 + neg, 2]``; output ``[..., 1]`` in (0, 1).

The tables are top-level attributes, so
:func:`~bigdl_tpu_torch.embedding.hybrid_optim_methods` gives each its own
method (``Optimizer.set_optim_methods``).  The tables draw on the
generator's device and the tower's ``Linear`` layers likewise: a CUDA
generator builds the 100M-user model on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.embedding.sharded_table import ShardedEmbeddingTable

__all__ = ["WideAndDeep", "wide_and_deep"]


class WideAndDeep(Module):
    """sigmoid(tower([user_table(u) ; item_table(i)]) + wide_user(u) +
    wide_item(i))."""

    def __init__(self, user_count: int, item_count: int,
                 embed_dim: int = 16, mlp_dims: Sequence[int] = (32, 16), *,
                 generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.user_count = int(user_count)
        self.item_count = int(item_count)
        self.user_table = ShardedEmbeddingTable(user_count, embed_dim,
                                                name="user_table", **kw)
        self.item_table = ShardedEmbeddingTable(item_count, embed_dim,
                                                name="item_table", **kw)
        self.wide_user = ShardedEmbeddingTable(user_count, 1,
                                               name="wide_user", **kw)
        self.wide_item = ShardedEmbeddingTable(item_count, 1,
                                               name="wide_item", **kw)
        layers = []
        prev = 2 * embed_dim
        for d in mlp_dims:
            layers += [nn.Linear(prev, d, **kw), nn.ReLU()]
            prev = d
        layers.append(nn.Linear(prev, 1, **kw))
        self.tower = nn.Sequential(*layers)

    def set_mesh(self, mesh, axis: str = "data") -> "WideAndDeep":
        """Shard every table over ``axis``: raises, as
        ``ShardedEmbeddingTable.set_mesh`` does (ROADMAP.md queue 1, item
        11)."""
        for t in (self.user_table, self.item_table,
                  self.wide_user, self.wide_item):
            t.set_mesh(mesh, axis)
        return self

    def forward(self, pairs):
        pairs = torch.as_tensor(pairs, device=self.user_table.weight.device)
        users, items = pairs[..., 0], pairs[..., 1]
        deep = self.tower(torch.cat(
            [self.user_table(users), self.item_table(items)], dim=-1))
        wide = self.wide_user(users) + self.wide_item(items)
        return torch.sigmoid(deep + wide)


def wide_and_deep(user_count: int = 256, item_count: int = 128,
                  embed_dim: int = 16, mlp_dims: Sequence[int] = (32, 16),
                  *, generator: torch.Generator, device=None) -> WideAndDeep:
    """Zoo builder, at the reference's defaults (they divide over the
    8-device mesh of its serving demo)."""
    return WideAndDeep(user_count, item_count, embed_dim, mlp_dims,
                       generator=generator, device=device)
