"""Training (counterpart of ``bigdl_tpu.optim``): the single-device
``Optimizer`` core, ``SGD`` and the ``Trigger`` zoo."""

from bigdl_tpu_torch.optim.methods import (  # noqa: F401
    Default, LearningRateSchedule, OptimMethod, SGD,
)
from bigdl_tpu_torch.optim.optimizer import Optimizer  # noqa: F401
from bigdl_tpu_torch.optim.trigger import Trigger  # noqa: F401
