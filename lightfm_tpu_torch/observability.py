"""Observability: the profiler hook and per-fit throughput counters.

Counterpart of ``lightfm_tpu/observability.py``: :func:`trace` records a
``torch.profiler`` trace where the JAX package records a ``jax.profiler``
one, and :class:`FitStats` is ``LightFM.fit_stats_``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(logdir: str, device=None) -> Iterator[object]:
    """Capture a profiler trace viewable in TensorBoard/Perfetto.

    ``device=None`` means CUDA, as everywhere in the package: the trace
    records CPU and CUDA activity, and a machine without a CUDA device
    raises.  ``device="cpu"`` records CPU activity only.  The trace is
    written on exit as ``<logdir>/<host>_<pid>.<time>.pt.trace.json``
    (``torch.profiler.tensorboard_trace_handler``).  Yields the
    ``torch.profiler.profile`` object.

    Example::

        with lightfm_tpu_torch.observability.trace("/tmp/trace"):
            model.fit(interactions, epochs=10)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from lightfm_tpu_torch import model

    dev = model.resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


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
