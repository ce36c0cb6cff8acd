"""Per-table optim methods for the recommender (counterpart of
``bigdl_tpu/embedding/hybrid.py``), the single-device half.

:func:`hybrid_optim_methods` gives every embedding table its own copy of
one method and every other top-level child its own copy of another, for
the port's ``Optimizer.set_optim_methods``: sparse tables want another
learning rate than the dense tower, and per-table state (momentum, Adam's
moments) must never alias between tables.  It keeps every check and
message of the reference.

The sharded half raises naming ROADMAP.md queue 1, item 11:
:func:`embedding_rules` (the tables' row placement on a mesh),
:func:`resolve_hybrid` (a mesh's composition checks) and
:func:`configure_hybrid` (the one-call setup through the partition
planner).
"""

from __future__ import annotations

import copy
from typing import Dict

from torch import nn

from bigdl_tpu_torch.embedding.sharded_table import ShardedEmbeddingTable

__all__ = ["HybridPlanError", "sharded_tables", "embedding_rules",
           "resolve_hybrid", "hybrid_optim_methods", "configure_hybrid"]

_MESH = ("is not ported yet (ROADMAP.md queue 1, item 11: parallelism "
         "across devices); on one device give hybrid_optim_methods to "
         "Optimizer.set_optim_methods")


class HybridPlanError(ValueError):
    """A model composition the hybrid embedding plan cannot honor; the
    message says what to change (the reference's ``PlanError`` is a
    ValueError too)."""


def sharded_tables(model) -> Dict[str, ShardedEmbeddingTable]:
    """``{parameter-path prefix: table}`` for every ShardedEmbeddingTable
    in the tree (the root module's prefix is empty)."""
    return {prefix: mod for prefix, mod in model.named_modules()
            if isinstance(mod, ShardedEmbeddingTable)}


def embedding_rules(model, axis: str = "data"):
    raise NotImplementedError(f"embedding_rules {_MESH}")


def resolve_hybrid(model, mesh, axis: str = "data",
                   hierarchical: bool = False) -> Dict:
    raise NotImplementedError(f"resolve_hybrid {_MESH}")


def configure_hybrid(optimizer, axes=None, axis: str = "data",
                     table_method=None, dense_method=None) -> Dict:
    raise NotImplementedError(f"configure_hybrid {_MESH}")


def hybrid_optim_methods(model, table_method, dense_method) -> Dict:
    """Per-submodule OptimMethods: every table gets its own deep copy of
    ``table_method`` (per-table state never aliases) and every other
    top-level child its own copy of ``dense_method``."""
    if isinstance(model, ShardedEmbeddingTable):
        raise HybridPlanError(
            "hybrid_optim_methods: the model IS a single table; use "
            "set_optim_method directly")
    own = sorted(n for n, _ in model.named_parameters(recurse=False))
    if own:
        raise HybridPlanError(
            "hybrid_optim_methods: the model owns direct parameters "
            f"({own}); per-submodule methods cannot "
            "cover them — move them into a child module or call "
            "set_optim_methods yourself")

    def subtree_has_table(child: nn.Module) -> bool:
        return any(isinstance(m, ShardedEmbeddingTable)
                   for m in child.modules())

    methods: Dict = {}
    for name, child in model.named_children():
        if isinstance(child, ShardedEmbeddingTable):
            methods[name] = copy.deepcopy(table_method)
        elif subtree_has_table(child):
            raise HybridPlanError(
                f"hybrid_optim_methods: child {name!r} mixes a nested "
                f"sharded table with dense parameters; hoist tables to "
                f"top-level attributes (models/dlrm.py layout) or call "
                f"set_optim_methods with explicit keys")
        else:
            methods[name] = copy.deepcopy(dense_method)
    return methods
