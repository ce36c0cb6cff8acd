"""Device resolution for the port's entry points.

The port is built for one NVIDIA GPU.  Every entry point takes
``device=`` and defaults to ``"cuda"``; with no CUDA device it raises
instead of carrying on quietly on the CPU.  The CPU is used only when
the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``.  Raises RuntimeError when CUDA is asked for
    (or defaulted to) and absent, ValueError for device types the port
    does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on an NVIDIA "
                "GPU by default — pass device='cpu' to run on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
