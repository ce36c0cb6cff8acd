"""Generation serving of the port (counterpart of ``bigdl_tpu.serving``):
admission, bucketing, the continuous-batching engine and the server."""

from bigdl_tpu_torch.serving.admission import (  # noqa: F401
    BoundedRequestQueue, QueueFullError, RequestSheddedError,
    ServerClosedError,
)
from bigdl_tpu_torch.serving.batching import bucket_sizes, pick_bucket  # noqa: F401
from bigdl_tpu_torch.serving.generation import (  # noqa: F401
    GenerationRequest, GenerationScheduler, SlotPool, run_mixed_workload,
)
from bigdl_tpu_torch.serving.reliability import (  # noqa: F401
    Deadline, ReplicaDeadError, RequestCancelledError,
)
from bigdl_tpu_torch.serving.server import ModelServer  # noqa: F401
