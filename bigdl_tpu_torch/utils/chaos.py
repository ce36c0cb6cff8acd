"""Fault injection for the fault-tolerance path (counterpart of the hooks
of ``bigdl_tpu/utils/chaos.py`` that its fault-tolerance tests drive).

The retry and checkpoint machinery exists for failures that are awkward
to produce on demand: a crash between steps, a crash halfway through a
checkpoint write, a torn payload, a flaky filesystem.  This module
injects exactly those at fixed points, so a test can show that crash →
walk-back → resume works::

    from bigdl_tpu_torch.utils import chaos
    chaos.install(fail_at_step=7)            # raise at iteration 7
    chaos.install(truncate_checkpoint=2)     # tear the 2nd payload
    chaos.install(crash_checkpoint=2)        # die before the 2nd commit
    chaos.install(io_fail_p=0.2, seed=1)     # 20% of writes raise OSError
    chaos.reset()

The code under test calls ``on_step``, ``on_io_write`` and
``on_checkpoint_payload``; each returns at once when nothing is
installed.  The other faults (the input-pipeline stall, the fake OOM, the
serving replicas' kill, slowdown and flaky submits, the reshard) and the
environment variables that arm faults are ROADMAP.md queue 1, item 11.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from typing import List, Optional

__all__ = ["FaultInjected", "ChaosController", "install", "reset",
           "active", "on_step", "on_io_write", "on_checkpoint_payload"]

logger = logging.getLogger("bigdl_tpu_torch.chaos")


class FaultInjected(RuntimeError):
    """A deliberately injected fault.  A RuntimeError, so the Optimizer
    treats it as transient and retries, as it would the faults it stands
    for."""


class ChaosController:
    """The armed faults and their one-shot and counter state; ``events``
    records what fired."""

    def __init__(self, fail_at_step: Optional[int] = None,
                 crash_checkpoint: Optional[int] = None,
                 truncate_checkpoint: Optional[int] = None,
                 truncate_keep_bytes: int = 64,
                 io_fail_p: float = 0.0, seed: int = 0):
        self.fail_at_step = fail_at_step
        self.crash_checkpoint = crash_checkpoint
        self.truncate_checkpoint = truncate_checkpoint
        self.truncate_keep_bytes = int(truncate_keep_bytes)
        self.io_fail_p = float(io_fail_p)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.checkpoint_writes = 0
        self.events: List[str] = []

    def _fire(self, what: str) -> None:
        self.events.append(what)
        logger.warning("chaos: %s", what)

    def on_step(self, neval: int) -> None:
        """Raise once training reaches iteration ``fail_at_step``."""
        if self.fail_at_step is not None and neval >= self.fail_at_step:
            self.fail_at_step = None  # one-shot: the retry must succeed
            self._fire(f"injected failure at iteration {neval}")
            raise FaultInjected(f"chaos: injected failure at iteration "
                                f"{neval}")

    def on_io_write(self, path: str) -> None:
        if self.io_fail_p and self._rng.random() < self.io_fail_p:
            self._fire(f"injected IO failure writing {path}")
            raise OSError(f"chaos: injected IO failure writing {path}")

    def on_checkpoint_payload(self, path: str) -> None:
        """After a checkpoint payload is on disk, before its manifest:
        crash there (an uncommitted generation), or truncate the payload
        to ``truncate_keep_bytes`` (committed, then torn)."""
        with self._lock:
            self.checkpoint_writes += 1
            n = self.checkpoint_writes
        if self.crash_checkpoint is not None and n == self.crash_checkpoint:
            self._fire(f"crash before commit marker of {path}")
            raise FaultInjected(
                f"chaos: crash mid-checkpoint (payload {path} written, "
                f"commit marker not)")
        if self.truncate_checkpoint is not None \
                and n == self.truncate_checkpoint:
            keep = self.truncate_keep_bytes
            if os.path.isfile(path):
                with open(path, "r+b") as f:
                    f.truncate(keep)
            self._fire(f"truncated checkpoint payload {path} "
                       f"to {keep} bytes")


_active: Optional[ChaosController] = None


def install(**kwargs) -> ChaosController:
    """Arm a set of faults; returns the controller."""
    global _active
    _active = ChaosController(**kwargs)
    return _active


def reset() -> None:
    """Disarm every fault."""
    global _active
    _active = None


def active() -> Optional[ChaosController]:
    return _active


def on_step(neval: int) -> None:
    if _active is not None:
        _active.on_step(neval)


def on_io_write(path: str) -> None:
    if _active is not None:
        _active.on_io_write(path)


def on_checkpoint_payload(path: str) -> None:
    if _active is not None:
        _active.on_checkpoint_payload(path)
