"""A device mesh of named axes (counterpart of ``bigdl_tpu/parallel/mesh.py``,
only what the ring needs).

The reference lays its mesh over ``jax.devices()``; its CPU tests lay an
8-way ``seq`` axis over 8 fake devices of one CPU, and one Python process
drives every shard.  The port does the same on one card: a mesh is a list
of torch devices, one per shard, and the devices may repeat, so n shards
can sit on the one H100 (or on the CPU).  A ring across distinct GPUs,
``MeshConfig``, the ``dcn`` hybrid layout and the batch shardings are not
ported (ROADMAP.md queue 1, item 11): a mesh whose shards lie on
different devices raises.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.core.device import resolve_device, same_device

__all__ = ["AXES", "Mesh", "make_mesh", "same_device"]

logger = logging.getLogger("bigdl_tpu_torch.parallel")

# the reference's axis names, outermost first (parallel/mesh.py:77)
AXES = ("dcn", "data", "fsdp", "model", "pipe", "seq", "expert")

# what a refusal of the unported parts names
NOT_PORTED = ("is not ported yet (ROADMAP.md queue 1, item 11: parallelism "
              "across devices)")


class Mesh:
    """Named axes over torch devices.  ``devices`` is an array-like of
    devices (names or ``torch.device``) whose shape is the axes' sizes;
    ``shape[axis]`` is an axis's size, ``devices`` the flat list.  Every
    shard must lie on one device."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"a mesh of shape {grid.shape} needs "
                             f"{grid.ndim} distinct axis names, got "
                             f"{axis_names}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, grid.shape))
        self.devices = [resolve_device(d) for d in grid.reshape(-1)]
        first = self.devices[0]
        for d in self.devices[1:]:
            if not same_device(d, first):
                raise NotImplementedError(
                    f"a mesh over distinct devices ({first} and {d}) "
                    f"{NOT_PORTED}; lay every shard on one device, e.g. "
                    f"devices=['cuda'] * n")

    @property
    def device(self) -> torch.device:
        """The one device every shard lies on."""
        return self.devices[0]


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices=None) -> Mesh:
    """A one-axis mesh, e.g. ``make_mesh({"seq": 4}, ["cuda"] * 4)``.
    ``devices=None`` lays every shard on the default device (the card;
    pass devices to use the CPU).  One size may be -1 when devices are
    given: it becomes their number.  Raises NotImplementedError for more
    than one axis."""
    axes = {"data": -1} if axes is None else dict(axes)
    if len(axes) != 1:
        raise NotImplementedError(
            f"make_mesh over several axes {axes} {NOT_PORTED}")
    (name, size), = axes.items()
    if size == -1:
        if devices is None:
            raise ValueError("an axis of size -1 needs the devices")
        size = len(devices)
    if devices is None:
        devices = [resolve_device(None)] * size
    devices = list(devices)
    if size < 1 or size > len(devices):
        raise ValueError(f"mesh axes {axes} need 1 to {len(devices)} "
                         f"devices")
    if size < len(devices):
        logger.warning("mesh axes %s cover only %d of %d devices; dropping "
                       "the rest", axes, size, len(devices))
    return Mesh(devices[:size], (name,))
