"""One-shot serving metrics: latency quantiles, queue depth, batch
occupancy, padded waste (counterpart of ``bigdl_tpu/serving/metrics.py``).

* ``latency_ms/p50|p90|p99`` — per-request latency, enqueue to result,
  the number admission control exists to protect;
* ``queue_depth``            — backlog sampled at every dispatch;
* ``occupancy``              — histogram of real rows per batch run
  (near 1: the batcher adds latency for nothing; near ``max_batch``: it
  earns its keep);
* ``padded_waste``           — padded rows / rows run: the price of the
  buckets, work spent on rows that are dropped.

The reference mirrors this registry into its telemetry families, which
are not ported (ROADMAP.md queue 1, item 10); :meth:`publish` writes
through a visualization summary, which is not ported either (item 13).
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np

__all__ = ["MetricsRegistry"]


def _quantiles_ms(lats_s: np.ndarray) -> Dict[str, float]:
    if lats_s.size == 0:
        return {"p50": 0.0, "p90": 0.0, "p99": 0.0}
    q = np.quantile(lats_s, [0.5, 0.9, 0.99]) * 1e3
    return {"p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2])}


# at most this many per-request latencies are kept for the quantiles;
# beyond it a uniform reservoir sample, so a long-lived server's host
# memory stays bounded
_RESERVOIR = 65536


class MetricsRegistry:
    """Thread-safe accumulator of the one-shot data plane: the scheduler
    calls :meth:`record_batch`, anyone may :meth:`snapshot`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._latencies_s: List[float] = []
        self._seen = 0            # latencies offered (for the reservoir)
        self._occupancy: Dict[int, int] = {}   # real rows -> batches
        # running aggregates, not a list: host memory stays flat
        self._depth_sum = 0
        self._depth_n = 0
        self._depth_max = 0
        self._rows_real = 0
        self._rows_padded = 0
        self._batches = 0
        self._requests = 0
        self._shed = 0
        self._rejected = 0
        self._rng = np.random.default_rng(0)

    # ---- recording -------------------------------------------------------

    def record_batch(self, n_real: int, bucket: int, queue_depth: int,
                     latencies_s) -> None:
        with self._lock:
            self._batches += 1
            self._requests += n_real
            self._rows_real += n_real
            self._rows_padded += bucket - n_real
            self._occupancy[n_real] = self._occupancy.get(n_real, 0) + 1
            self._depth_sum += queue_depth
            self._depth_n += 1
            self._depth_max = max(self._depth_max, queue_depth)
            for lat in latencies_s:
                self._seen += 1
                if len(self._latencies_s) < _RESERVOIR:
                    self._latencies_s.append(float(lat))
                else:
                    j = int(self._rng.integers(self._seen))
                    if j < _RESERVOIR:
                        self._latencies_s[j] = float(lat)

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self._shed += n

    def record_rejected(self, n: int = 1) -> None:
        with self._lock:
            self._rejected += n

    # ---- reading ---------------------------------------------------------

    def latency_quantiles_ms(self) -> Dict[str, float]:
        with self._lock:
            lats = np.asarray(self._latencies_s, dtype=np.float64)
        return _quantiles_ms(lats)

    def occupancy_histogram(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._occupancy)

    def padded_waste(self) -> float:
        with self._lock:
            total = self._rows_real + self._rows_padded
            return (self._rows_padded / total) if total else 0.0

    def snapshot(self) -> Dict[str, object]:
        """Every field, read under one lock acquisition, so a dispatch
        landing mid-snapshot cannot leave ``requests`` and the quantiles
        disagreeing (the reference's schema)."""
        with self._lock:
            lats = np.asarray(self._latencies_s, dtype=np.float64)
            total_rows = self._rows_real + self._rows_padded
            snap = {
                "requests": self._requests,
                "batches": self._batches,
                "shed": self._shed,
                "rejected": self._rejected,
                "rows_real": self._rows_real,
                "rows_padded": self._rows_padded,
                "occupancy": dict(self._occupancy),
                "padded_waste": (self._rows_padded / total_rows
                                 if total_rows else 0.0),
                "queue_depth_mean": (self._depth_sum / self._depth_n
                                     if self._depth_n else 0.0),
                "queue_depth_max": self._depth_max,
            }
        snap["latency_ms"] = _quantiles_ms(lats)
        return snap

    def publish(self, summary, step: int) -> None:
        raise NotImplementedError(
            "MetricsRegistry.publish writes through a visualization "
            "summary, which is not ported yet (ROADMAP.md queue 1, item "
            "13: visualization/); read snapshot() instead")
