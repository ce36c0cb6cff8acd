"""The input pipeline's service layer (counterpart of ``bigdl_tpu.data``):
the checkpointable ``PipelineState`` and ``DevicePrefetch``."""

from bigdl_tpu_torch.data.device_prefetch import DevicePrefetch  # noqa: F401
from bigdl_tpu_torch.data.pipeline import (  # noqa: F401
    PIPELINE_STATE_VERSION, PipelineState, dataset_seed, epoch_iter,
    skip_batches, skip_samples, supports_epoch,
)
