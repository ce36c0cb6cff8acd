"""Layers of the port (counterpart of ``bigdl_tpu.nn``)."""

from bigdl_tpu_torch.nn.attention import (  # noqa: F401
    Attention, FeedForwardNetwork, TransformerDecoderLayer, causal_bias,
    chunk_incremental_bias, incremental_bias, padding_bias,
    position_encoding,
)
from bigdl_tpu_torch.nn.conv import SpatialConvolution  # noqa: F401
from bigdl_tpu_torch.nn.linear import Linear, LookupTable  # noqa: F401
from bigdl_tpu_torch.nn.normalization import (  # noqa: F401
    BatchNormalization, LayerNormalization, SpatialBatchNormalization,
)
from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling  # noqa: F401
