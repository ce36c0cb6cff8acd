"""Neural Collaborative Filtering, NeuMF (counterpart of
``bigdl_tpu/models/ncf.py``): a GMF branch (the elementwise product of
user and item embeddings) and an MLP branch over the concatenated
embeddings, fused by a final linear into one interaction probability.
Weights are drawn from the caller's ``torch.Generator`` on the CPU and
moved to ``device`` (default ``cuda``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Module

__all__ = ["NeuralCF"]


class NeuralCF(Module):
    """sigmoid(Linear([gmf_u * gmf_i ; MLP([mlp_u ; mlp_i])])).

    Input: int id pairs ``[..., 2]`` (user, item), 1-based like the raw
    MovieLens files and ``LookupTable``.  Output: scores ``[...]`` in
    (0, 1), so one forward scores a training batch ``[B, 2]`` and a
    HitRatio evaluation batch ``[B, 1 + neg, 2]``."""

    def __init__(self, user_count: int, item_count: int,
                 embed_dim: int = 16, mlp_dims=(32, 16, 8), *,
                 generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.gmf_user = nn.LookupTable(user_count, embed_dim, **kw)
        self.gmf_item = nn.LookupTable(item_count, embed_dim, **kw)
        self.mlp_user = nn.LookupTable(user_count, embed_dim, **kw)
        self.mlp_item = nn.LookupTable(item_count, embed_dim, **kw)
        layers = []
        nin = 2 * embed_dim
        for nout in mlp_dims:
            layers += [nn.Linear(nin, nout, **kw), nn.ReLU()]
            nin = nout
        self.mlp = nn.Sequential(*layers)
        self.head = nn.Linear(self.mlp_dims_out(mlp_dims) + embed_dim, 1,
                              **kw)

    @staticmethod
    def mlp_dims_out(mlp_dims) -> int:
        return mlp_dims[-1] if mlp_dims else 0

    def forward(self, pairs):
        users = pairs[..., 0]
        items = pairs[..., 1]
        gmf = self.gmf_user(users) * self.gmf_item(items)
        mlp = self.mlp(torch.cat([self.mlp_user(users),
                                  self.mlp_item(items)], dim=-1))
        score = self.head(torch.cat([gmf, mlp], dim=-1))
        return torch.sigmoid(score[..., 0])
