"""Serving of the port (counterpart of ``bigdl_tpu.serving``): admission,
bucketing, the one-shot batch scheduler and its metrics, the
continuous-batching engine with its prefix KV cache, the disaggregated
prefill/decode engine and the server."""

from bigdl_tpu_torch.serving.admission import (  # noqa: F401
    BoundedRequestQueue, QueueFullError, Request, RequestSheddedError,
    ServerClosedError,
)
from bigdl_tpu_torch.serving.batching import (  # noqa: F401
    bucket_sizes, pick_bucket, split_outputs, stack_requests,
)
from bigdl_tpu_torch.serving.generation import (  # noqa: F401
    GenerationRequest, GenerationScheduler, SlotPool, run_mixed_workload,
    run_shared_prefix_workload,
)
from bigdl_tpu_torch.serving.metrics import MetricsRegistry  # noqa: F401
from bigdl_tpu_torch.serving.prefix_cache import (  # noqa: F401
    PrefixChunk, PrefixKVCache,
)
from bigdl_tpu_torch.serving.reliability import (  # noqa: F401
    Deadline, DeadlineExceededError, ReplicaDeadError,
    RequestCancelledError, deadline_error,
)
from bigdl_tpu_torch.serving.replica import DisaggregatedEngine  # noqa: F401
from bigdl_tpu_torch.serving.scheduler import BatchScheduler  # noqa: F401
from bigdl_tpu_torch.serving.server import (  # noqa: F401
    ModelServer, install_shutdown_signals,
)
