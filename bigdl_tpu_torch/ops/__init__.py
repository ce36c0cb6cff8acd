"""The port's ops (counterpart of ``bigdl_tpu.ops``): attention and the
fused conv+BN, each with its plain version, its CUDA kernels' wrappers
and the dispatch."""

from bigdl_tpu_torch.ops.attention_kernels import (  # noqa: F401
    NEG_INF, dot_product_attention, flash_attention, flash_attention_fwd,
    plain_attention,
)
from bigdl_tpu_torch.ops.conv_bn_kernels import (  # noqa: F401
    fused_block_supported, fused_conv3x3_bn, fused_conv3x3_supported,
    fused_matmul_bn,
)
