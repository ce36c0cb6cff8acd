"""Embedding tables for the recommender (counterpart of
``bigdl_tpu/embedding/sharded_table.py``), the single-device half.

Without a mesh the reference's :class:`ShardedEmbeddingTable` is the
plain dense gather, "the single-device baseline": 1-based ids clipped
into range, looked up through :func:`~bigdl_tpu_torch.nn.sparse.
dedup_gather`, so a batch's repeated ids backward into one combined row
each.  That is what this port runs.  The row-sharded lookup over a mesh
axis (ids bucketed by owning shard, two all_to_alls) is not ported:
:meth:`ShardedEmbeddingTable.set_mesh` raises naming ROADMAP.md queue 1,
item 11.  The reference's lookup telemetry (``_account_lookup``) is item
10 and left out.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.nn.sparse import dedup_gather

__all__ = ["ShardedEmbeddingTable", "LAST_LOOKUP_SHAPES"]

# the a2a lookup's per-device buffer shapes in the reference; the dense
# lookup records none
LAST_LOOKUP_SHAPES = {}

_MESH = ("is not ported yet (ROADMAP.md queue 1, item 11: parallelism "
         "across devices); without a mesh the table is the dense lookup")


class ShardedEmbeddingTable(Module):
    """Embedding lookup with 1-based ids, like :class:`LookupTable`; the
    forward is the dense gather, and its backward writes a zero table of
    the weight's shape with one combined row per unique id.  Weight ~
    N(0, 1), drawn from ``generator`` on the generator's device (a CUDA
    generator draws a 100M-row table on the card) and moved to
    ``device``."""

    def __init__(self, n_index: int, n_output: int,
                 name: Optional[str] = None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.n_index = int(n_index)
        self.n_output = int(n_output)
        if name is not None:
            self.set_name(name)
        self.weight = nn.Parameter(torch.randn(
            (self.n_index, self.n_output), generator=generator,
            device=generator.device).to(resolve_device(device)))

    # -- placement ---------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return 1

    @property
    def rows_per_shard(self) -> int:
        return self.n_index // self.n_shards

    def set_mesh(self, mesh, axis: str = "data"):
        raise NotImplementedError(
            f"ShardedEmbeddingTable {self.name!r}: the row-sharded "
            f"all_to_all lookup {_MESH}")

    def owner_of(self, ids) -> torch.Tensor:
        """The shard that owns each (1-based) id under the contiguous
        row-block layout: the serving affinity key's input."""
        idx0 = (torch.as_tensor(ids).long() - 1).clamp(0, self.n_index - 1)
        return idx0 // self.rows_per_shard

    # -- lookup ------------------------------------------------------------

    def forward(self, ids):
        ids = torch.as_tensor(ids, device=self.weight.device)
        return self._dense_lookup(ids)

    def _dense_lookup(self, ids):
        return dedup_gather(self.weight,
                            (ids.long() - 1).clamp(0, self.n_index - 1))
