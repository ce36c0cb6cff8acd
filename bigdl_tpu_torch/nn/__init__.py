"""Layers of the port (counterpart of ``bigdl_tpu.nn``)."""

from bigdl_tpu_torch.core.module import Module  # noqa: F401
from bigdl_tpu_torch.nn.activation import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.attention import (  # noqa: F401
    Attention, FeedForwardNetwork, TransformerDecoderLayer, causal_bias,
    chunk_incremental_bias, incremental_bias, padding_bias,
    position_encoding,
)
from bigdl_tpu_torch.nn.containers import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.conv import SpatialConvolution  # noqa: F401
from bigdl_tpu_torch.nn.criterion import (  # noqa: F401
    ClassNLLCriterion, Criterion, CrossEntropyCriterion,
)
from bigdl_tpu_torch.nn.linear import Linear, LookupTable  # noqa: F401
from bigdl_tpu_torch.nn.normalization import (  # noqa: F401
    BatchNormalization, LayerNormalization, SpatialBatchNormalization,
)
from bigdl_tpu_torch.nn.pooling import (  # noqa: F401
    GlobalAveragePooling2D, SpatialAveragePooling, SpatialMaxPooling,
)
from bigdl_tpu_torch.nn.shape_ops import *  # noqa: F401,F403
