"""Models of the port (counterpart of ``bigdl_tpu.models``), and the zoo:
name → builder, for entry points that take a model by name.  Every
builder takes ``generator=`` (its random inits) and ``device=`` (default
``cuda``) besides the reference's arguments, which pass through
:func:`zoo`."""

from bigdl_tpu_torch.models.autoencoder import (  # noqa: F401
    Autoencoder, autoencoder,
)
from bigdl_tpu_torch.models.dlrm import (  # noqa: F401
    WideAndDeep, wide_and_deep,
)
from bigdl_tpu_torch.models.inception import (  # noqa: F401
    Inception_v1, Inception_v2,
)
from bigdl_tpu_torch.models.lenet import LeNet5, lenet5_graph  # noqa: F401
from bigdl_tpu_torch.models.maskrcnn import (  # noqa: F401
    MaskRCNN, MaskRCNNParams, ResNetFPNBackbone,
)
from bigdl_tpu_torch.models.ncf import NeuralCF  # noqa: F401
from bigdl_tpu_torch.models.resnet import (  # noqa: F401
    BasicBlock, Bottleneck, ResNet, resnet50, resnet_cifar,
)
from bigdl_tpu_torch.models.rnn_lm import PTBModel, SimpleRNN  # noqa: F401
from bigdl_tpu_torch.models.ssd import SSDVGG16, ssd_vgg16_300  # noqa: F401
from bigdl_tpu_torch.models.transformer_lm import (  # noqa: F401
    TransformerLM, transformer_lm,
)
from bigdl_tpu_torch.models.vgg import (  # noqa: F401
    Vgg_16, Vgg_19, VggForCifar10,
)


def _transformer_lm_tiny(**kwargs):
    """The small decoder-only LM of the serving demos."""
    cfg = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
               filter_size=128, max_len=128)
    cfg.update(kwargs)
    return transformer_lm(**cfg)


_ZOO = {
    "lenet5": LeNet5,
    "lenet5_graph": lenet5_graph,
    "autoencoder": autoencoder,
    "resnet_cifar": resnet_cifar,
    "vgg_cifar10": VggForCifar10,
    "transformer_lm_tiny": _transformer_lm_tiny,
    "wide_and_deep": wide_and_deep,
}

# the per-sample (unbatched) input shape of each zoo model, for the
# serving CLI's rows and warm-up buckets
_ZOO_SAMPLE_SHAPES = {
    "lenet5": (784,),
    "lenet5_graph": (784,),
    "autoencoder": (784,),
    "resnet_cifar": (32, 32, 3),
    "vgg_cifar10": (32, 32, 3),
    # a (user, item) 1-based id pair
    "wide_and_deep": (2,),
}


def zoo(name: str, **kwargs):
    """Build a zoo model by name (``zoo("lenet5", class_num=10,
    generator=g, device="cpu")``)."""
    try:
        builder = _ZOO[name]
    except KeyError:
        raise ValueError(
            f"unknown zoo model {name!r}; available: {sorted(_ZOO)}") \
            from None
    return builder(**kwargs)


def zoo_sample_shape(name: str):
    """The per-sample input shape of a zoo model."""
    if name not in _ZOO_SAMPLE_SHAPES:
        raise ValueError(f"no registered sample shape for {name!r}; "
                         f"available: {sorted(_ZOO_SAMPLE_SHAPES)}")
    return _ZOO_SAMPLE_SHAPES[name]
