"""Layers of the port (counterpart of ``bigdl_tpu.nn``)."""

from bigdl_tpu_torch.core.module import Module  # noqa: F401
from bigdl_tpu_torch.nn.activation import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.attention import (  # noqa: F401
    Attention, FeedForwardNetwork, SequenceBeamSearch, Transformer,
    TransformerDecoderLayer, TransformerEncoderLayer, causal_bias,
    chunk_incremental_bias, incremental_bias, padding_bias,
    position_encoding, shift_right_3d,
)
from bigdl_tpu_torch.nn.containers import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.conv import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.criterion import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.detection import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.linear import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.normalization import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.pooling import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.quantized import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.regularization import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.rnn import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.shape_ops import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.sparse import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.table_ops import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.tree import *  # noqa: F401,F403
