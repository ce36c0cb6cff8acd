"""Utilities (counterpart of ``bigdl_tpu.utils``): checkpoint files
(``file``), fault injection (``chaos``), the process-wide generator
(``rng``) and the ``T()`` container (``table``)."""

from bigdl_tpu_torch.utils.rng import (  # noqa: F401
    RandomGenerator, get_seed, next_generator, set_seed,
)
from bigdl_tpu_torch.utils.table import T, Table  # noqa: F401
