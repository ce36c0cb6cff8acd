"""Training and inference (counterpart of ``bigdl_tpu.optim``): the
single-device ``Optimizer`` core, ``SGD``, the ``Trigger`` zoo, the
validation methods, and ``Predictor``, ``Evaluator`` and
``PredictionService``."""

from bigdl_tpu_torch.optim.methods import (  # noqa: F401
    Default, LearningRateSchedule, OptimMethod, SGD,
)
from bigdl_tpu_torch.optim.optimizer import Optimizer  # noqa: F401
from bigdl_tpu_torch.optim.predictor import (  # noqa: F401
    Evaluator, PredictionService, Predictor,
)
from bigdl_tpu_torch.optim.trigger import Trigger  # noqa: F401
from bigdl_tpu_torch.optim.validation import (  # noqa: F401
    HitRatio, Loss, MAE, MeanAveragePrecision,
    MeanAveragePrecisionObjectDetection, NDCG, PrecisionRecallAUC,
    Top1Accuracy, Top5Accuracy, TopKAccuracy, TreeNNAccuracy,
    ValidationMethod, ValidationResult,
)
