"""Per-stage wall-clock accounting for the processors (port of
``StageTimer`` in ``msa_tpu/utils/profiling.py``). The JAX module's
``device_trace`` and ``fetch_timed`` drive the JAX profiler and are not
ported: time the card with ``torch.profiler`` or CUDA events."""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator

logger = logging.getLogger(__name__)


class StageTimer:
    """Accumulates wall-clock per named stage. Cheap enough to always be on.
    A stage's time is the host's: it holds device work only where the stage
    waits for the device."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def reset(self) -> None:
        """Zero the accumulators (e.g. between a warmup and a timed pass)."""
        self.totals.clear()
        self.counts.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 2),
            }
            for name in sorted(self.totals)
        }

    def log_summary(self, prefix: str = "stage timings") -> None:
        for name, s in self.summary().items():
            logger.info("%s: %-12s total=%.3fs n=%d mean=%.1fms", prefix, name, s["total_s"], s["count"], s["mean_ms"])
