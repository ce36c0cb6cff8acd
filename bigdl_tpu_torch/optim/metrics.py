"""Training-phase timing accumulators (counterpart of
``bigdl_tpu/optim/metrics.py``, the reference's optim/Metrics.scala):
named scalars summed with their counts, a ``time`` context and a
summary.  Thread-safe."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Tuple

__all__ = ["Metrics"]


class _Acc:
    __slots__ = ("total", "count")

    def __init__(self):
        self.total = 0.0
        self.count = 0


class Metrics:
    """Named scalar accumulators."""

    def __init__(self):
        self._lock = threading.Lock()
        self._accs: Dict[str, _Acc] = {}

    def set(self, name: str, value: float, parallelism: int = 1) -> None:
        """Reset an accumulator to one observation."""
        with self._lock:
            acc = self._accs.setdefault(name, _Acc())
            acc.total = float(value)
            acc.count = max(parallelism, 1)

    def add(self, name: str, value: float, count: int = 1) -> None:
        """Accumulate an observation standing for ``count`` events."""
        with self._lock:
            acc = self._accs.setdefault(name, _Acc())
            acc.total += float(value) * count
            acc.count += count

    @contextmanager
    def time(self, name: str):
        """Time a phase: ``with metrics.time("validation time"): ...``"""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def get(self, name: str) -> Tuple[float, int]:
        with self._lock:
            acc = self._accs.get(name)
            return (acc.total, acc.count) if acc else (0.0, 0)

    def mean(self, name: str) -> float:
        total, count = self.get(name)
        return total / count if count else 0.0

    def summary(self, unit_scale: float = 1.0) -> str:
        with self._lock:
            lines = ["========== Metrics Summary =========="]
            for name in sorted(self._accs):
                acc = self._accs[name]
                mean = acc.total / acc.count if acc.count else 0.0
                lines.append(f"{name} : {mean * unit_scale:.6g} "
                             f"(n={acc.count})")
            lines.append("=====================================")
            return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._accs.clear()
