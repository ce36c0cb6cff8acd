"""Utilities (counterpart of ``bigdl_tpu.utils``): checkpoint files
(``file``) and fault injection (``chaos``)."""
