from bigdl_tpu_torch.core.device import resolve_device  # noqa: F401
from bigdl_tpu_torch.core import init  # noqa: F401
