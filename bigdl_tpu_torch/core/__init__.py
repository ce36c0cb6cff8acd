from bigdl_tpu_torch.core.device import resolve_device  # noqa: F401
