"""The port's ops (counterpart of ``bigdl_tpu.ops``): attention and the
fused conv+BN, each with its plain version, its CUDA kernels' wrappers
and the dispatch; the TF-style operations, the control-flow modules and
the feature-column host ops, the names ``bigdl_tpu.ops`` exports."""

from bigdl_tpu_torch.ops.attention_kernels import (  # noqa: F401
    NEG_INF, dot_product_attention, flash_attention, flash_attention_fwd,
    plain_attention,
)
from bigdl_tpu_torch.ops.conv_bn_kernels import (  # noqa: F401
    fused_block_supported, fused_conv3x3_bn, fused_conv3x3_supported,
    fused_matmul_bn,
)
from bigdl_tpu_torch.ops import operations  # noqa: F401
from bigdl_tpu_torch.ops.operations import *  # noqa: F401,F403
from bigdl_tpu_torch.ops.control import (  # noqa: F401
    Cond, Scan, TensorArrayScan, WhileLoop,
)
from bigdl_tpu_torch.ops.feature_columns import (  # noqa: F401
    CategoricalColHashBucket, CategoricalColVocaList, CrossCol,
    IndicatorCol, Kv2Tensor, MkString,
)

__all__ = ["dot_product_attention", "flash_attention",
           "Cond", "WhileLoop", "Scan", "TensorArrayScan",
           "CategoricalColHashBucket", "CategoricalColVocaList",
           "CrossCol", "IndicatorCol", "MkString", "Kv2Tensor"] \
    + list(operations.__all__)
