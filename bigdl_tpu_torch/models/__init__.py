"""Models of the port (counterpart of ``bigdl_tpu.models``)."""

from bigdl_tpu_torch.models.lenet import LeNet5, lenet5_graph  # noqa: F401
from bigdl_tpu_torch.models.resnet import (  # noqa: F401
    BasicBlock, Bottleneck, ResNet, resnet50, resnet_cifar,
)
from bigdl_tpu_torch.models.transformer_lm import (  # noqa: F401
    TransformerLM, transformer_lm,
)
