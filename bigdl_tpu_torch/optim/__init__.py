"""Training and inference (counterpart of ``bigdl_tpu.optim``): the
single-device ``Optimizer`` core, every optim method and learning-rate
schedule, the ``Trigger`` zoo, the validation methods, per-module
profiling, and ``Predictor``, ``Evaluator`` and
``PredictionService``."""

from bigdl_tpu_torch.optim.methods import (  # noqa: F401
    LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, Default, EpochDecay,
    EpochSchedule, EpochStep, Exponential, Ftrl, LarsSGD,
    LearningRateSchedule, MultiStep, NaturalExp, OptimMethod, ParallelAdam,
    Plateau, Poly, Regime, RMSprop, SequentialSchedule, Step, Warmup,
)
from bigdl_tpu_torch.optim.optimizer import Optimizer  # noqa: F401
from bigdl_tpu_torch.optim.profiling import (  # noqa: F401
    module_forward_times, profile_trace, times_by_module_type,
)
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
