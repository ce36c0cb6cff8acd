"""bigdl_tpu_torch — the PyTorch/CUDA port of bigdl_tpu, for one NVIDIA
H100.

It imports torch and numpy only, never JAX and nothing of ``bigdl_tpu``
(the reference it is held to in the tests).  Entry points default to
``device="cuda"`` and raise without a CUDA device unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
