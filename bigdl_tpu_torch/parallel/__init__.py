"""Parallelism of the port (counterpart of ``bigdl_tpu.parallel``): so far
the one-axis mesh and ring attention, single-controller, with every shard
on one device.  Sharding rules, ``PartitionPlan``, the pipeline, the
hierarchical sync and rings across devices are ROADMAP.md queue 1, item
11."""

from bigdl_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh  # noqa: F401
from bigdl_tpu_torch.parallel.ring_attention import (  # noqa: F401
    RingSelfAttention, ring_attention, ring_self_attention,
)
