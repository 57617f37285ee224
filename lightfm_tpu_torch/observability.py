"""Per-fit throughput counters (``LightFM.fit_stats_``).

Counterpart of ``lightfm_tpu/observability.py:30-55``.  The profiler hook
``trace`` is not ported yet (ROADMAP.md, host side).
"""

from __future__ import annotations

import time
from typing import Optional


class FitStats:
    """Wall-clock + throughput bookkeeping for one fit call.  ``fit`` ends
    in a device synchronisation (its finiteness check reads a sum back), so
    the wall time covers the device work."""

    def __init__(self, n_examples: int, epochs: int):
        self.n_examples = n_examples
        self.epochs = epochs
        self.wall_s: Optional[float] = None
        self.examples_per_sec: Optional[float] = None
        self._t0 = time.perf_counter()

    def finish(self) -> "FitStats":
        self.wall_s = time.perf_counter() - self._t0
        total = self.n_examples * self.epochs
        self.examples_per_sec = total / self.wall_s if self.wall_s > 0 else 0.0
        return self

    def as_dict(self) -> dict:
        return {
            "examples": self.n_examples,
            "epochs": self.epochs,
            "wall_s": self.wall_s,
            "examples_per_sec": self.examples_per_sec,
        }

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"FitStats({self.as_dict()})"
