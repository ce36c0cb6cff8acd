"""Datasets (counterpart of ``bigdl_tpu.dataset``): ``Sample``,
``MiniBatch``, the single-host datasets with the reference's epoch
order, the ``Transformer`` stages and synthetic MNIST."""

from bigdl_tpu_torch.dataset.dataset import (  # noqa: F401
    DataSet, DeviceCachedDataSet, LocalDataSet, MiniBatch, Sample,
    epoch_permutation,
)
from bigdl_tpu_torch.dataset.image import (  # noqa: F401
    GreyImgNormalizer, synthetic_mnist,
)
from bigdl_tpu_torch.dataset.transformer import (  # noqa: F401
    FeatureLabelTransformer, Identity, SampleToMiniBatch, Transformer,
)
