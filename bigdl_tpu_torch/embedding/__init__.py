"""Embedding tables and the recommender workload (counterpart of
``bigdl_tpu.embedding``), the single-device half: the dense lookup of
:class:`ShardedEmbeddingTable`, per-table optim methods, streaming
resumable HitRatio/NDCG evaluation and the scoring target with its shard
affinity key.  The mesh half (the all_to_all lookup, ``embedding_rules``,
``resolve_hybrid``, ``configure_hybrid``) raises naming ROADMAP.md queue
1, item 11."""

from bigdl_tpu_torch.embedding.eval import StreamingRecEval
from bigdl_tpu_torch.embedding.hybrid import (
    HybridPlanError, configure_hybrid, embedding_rules,
    hybrid_optim_methods, resolve_hybrid, sharded_tables,
)
from bigdl_tpu_torch.embedding.serving import (
    RecommenderScorer, shard_affinity_key,
)
from bigdl_tpu_torch.embedding.sharded_table import ShardedEmbeddingTable

__all__ = [
    "ShardedEmbeddingTable", "StreamingRecEval", "HybridPlanError",
    "configure_hybrid", "embedding_rules", "hybrid_optim_methods",
    "resolve_hybrid", "sharded_tables", "RecommenderScorer",
    "shard_affinity_key",
]
