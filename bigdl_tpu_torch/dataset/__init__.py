"""Datasets (counterpart of ``bigdl_tpu.dataset``): ``MiniBatch`` and the
single-host datasets, with the reference's epoch order."""

from bigdl_tpu_torch.dataset.dataset import (  # noqa: F401
    DataSet, DeviceCachedDataSet, LocalDataSet, MiniBatch,
    epoch_permutation,
)
