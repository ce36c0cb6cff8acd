"""Attention ops: the plain version, the CUDA kernel's wrapper and the
dispatch (counterpart of ``bigdl_tpu.ops``)."""

from bigdl_tpu_torch.ops.attention_kernels import (  # noqa: F401
    NEG_INF, dot_product_attention, flash_attention, flash_attention_fwd,
    plain_attention,
)
