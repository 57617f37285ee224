"""Observability: spans and counters at the port's layer boundaries, the
profiler hook and per-fit throughput counters.

Counterpart of ``lightfm_tpu/observability.py``: :func:`trace` records a
``torch.profiler`` trace where the JAX package records a ``jax.profiler``
one, and :class:`FitStats` is ``LightFM.fit_stats_``.

**Spans.**  :func:`span` (a context manager) and :func:`spanned` (a
decorator) mark one layer of the program by name.  While neither a
``torch.profiler`` nor a :func:`recording` is active, a span costs one
test and reads no clock.  Under an active profiler it is a range named
``lightfm.<name>`` in the profiler's trace, on the same clock as the
device's activity; it is a function-scope range, like an operator's, so
it adds no annotation to the device's timeline.  Under a
:func:`recording` or an active profiler it is also kept in memory as a
:class:`Span`, with its times in ns on the profiler's clock (the Unix
epoch, ``time.time_ns``, as the profiler's host events).  The spans of
one ``fit``, ``predict_rank``, ``predict`` or ``recommend`` call carry
that call's id.

**Counters.**  :func:`count` adds to a host integer and never reads a
device value; :func:`counters` returns a copy of them.  A count that
lives on the device is added by :func:`count_on_device` without a read,
and read (a synchronisation) by :func:`device_counter` only when asked.

Spans and counter increments made under an active profiler, outside any
recording, are kept in a bounded log (the newest ``LOG_LIMIT`` entries):
:func:`kept_between` reads those that lie in a window of the profiler's
clock, such as a traced window's.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Iterator, NamedTuple, Optional

import torch

# Read through the module at call time, so tests can count the calls.
_clock = time.time_ns
_profiler_range = torch._C._profiler._RecordFunctionFast
_profiler_enabled = torch._C._autograd._profiler_enabled

PREFIX = "lightfm."
# Entries the log keeps while no recording is open.
LOG_LIMIT = 1 << 16

_recordings = 0  # recording() bodies open
_log: list = []  # _Open spans and _Count increments, in the order they began
_counts: dict = {}
_device_counts: dict = {}
_calls = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    """One kept span: times in ns on the profiler's clock; ``parent`` is
    the index of the innermost enclosing span in the same record (None at
    its top); ``call`` the id of the public call it ran in (None outside
    one)."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call: Optional[int]


class Record:
    """The spans and counter increments of a :func:`recording` body or of
    a window of the log (:func:`kept_between`)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}

    def _fill(self, entries) -> "Record":
        opened = [e for e in entries if isinstance(e, _Open)]
        index = {id(e): i for i, e in enumerate(opened)}
        self.spans = [Span(e.name, e.start_ns, e.end_ns, index.get(id(e.parent)), e.call)
                      for e in opened]
        for e in entries:
            if isinstance(e, _Count):
                self.counters[e.name] = self.counters.get(e.name, 0) + e.n
        return self

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def self_ns(self, i: int) -> int:
        """Span ``i``'s duration less the part its child spans cover."""
        s = self.spans[i]
        covered, t = 0, s.start_ns
        for c in sorted((c for c in self.spans if c.parent == i), key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, t), min(c.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                t = hi
        return s.end_ns - s.start_ns - covered


class _Count(NamedTuple):
    name: str
    n: int
    t_ns: int


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _trim() -> None:
    """Drop the oldest entries past ``LOG_LIMIT``, unless a recording
    still reads them."""
    if len(_log) > LOG_LIMIT and not _recordings:
        del _log[:len(_log) - LOG_LIMIT // 2]


def _keep(entry) -> None:
    _trim()
    _log.append(entry)


class _Open:
    """A span while it is on: the profiler's range, and the kept times."""

    __slots__ = ("name", "call", "parent", "start_ns", "end_ns", "_range", "_new_call")

    def __init__(self, name: str, new_call: bool):
        self.name = name
        self._new_call = new_call

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.call = self.parent.call if self.parent is not None else None
        if self._new_call and self.call is None:
            self.call = next(_calls)
        self._range = None
        if _profiler_enabled():
            self._range = _profiler_range(PREFIX + self.name)
            self._range.__enter__()
        self.end_ns = 0
        _keep(self)
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False


class _Off:
    """The span while nothing observes it."""

    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_OFF = _Off()


def span(name: str):
    """``with span("rank.prep"):`` marks its body as the layer ``name``."""
    if _recordings or _profiler_enabled():
        return _Open(name, False)
    return _OFF


def spanned(name: str, call: bool = False):
    """Decorator: each call of the function is a span ``name``; with
    ``call=True`` it is a public call, whose id its spans carry."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _recordings or _profiler_enabled():
                with _Open(name, call):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer) to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n
    if _recordings or _profiler_enabled():
        _keep(_Count(name, n, _clock()))


def counters() -> dict:
    """A copy of every host counter's total."""
    return dict(_counts)


def count_on_device(name: str, n: torch.Tensor) -> None:
    """Add the integer tensor ``n`` to the device counter ``name`` on its
    device, with no read back to the host."""
    key = (name, n.device)
    n = n.detach().to(torch.int64)
    total = _device_counts.get(key)
    # Out of place: a total first made under torch.inference_mode() is an
    # inference tensor, which may not be updated in place outside it.
    _device_counts[key] = n if total is None else total + n


def device_counter(name: str) -> int:
    """The device counter's total over every device (reading it waits for
    the device)."""
    return sum(int(t.item()) for (k, _), t in list(_device_counts.items()) if k == name)


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Keep every span and counter increment of the body in memory.
    Yields a :class:`Record`, filled when the body exits.

    Example::

        with lightfm_tpu_torch.observability.recording() as rec:
            model.predict_rank(test, train_interactions=train)
        [(s.name, (s.end_ns - s.start_ns) / 1e6) for s in rec.spans]
    """
    global _recordings
    rec = Record()
    _recordings += 1
    first = len(_log)
    try:
        yield rec
    finally:
        _recordings -= 1
        rec._fill([e for e in _log[first:] if not isinstance(e, _Open) or e.end_ns])
        _trim()


def kept_between(start_ns: int, end_ns: int) -> Record:
    """The kept spans that lie wholly in ``[start_ns, end_ns]`` and the
    counter increments made in it, on the profiler's clock."""
    return Record()._fill([
        e for e in list(_log)
        if (isinstance(e, _Count) and start_ns <= e.t_ns <= end_ns)
        or (isinstance(e, _Open) and e.end_ns and start_ns <= e.start_ns
            and e.end_ns <= end_ns)
    ])


@contextlib.contextmanager
def trace(logdir: str, device=None) -> Iterator[object]:
    """Capture a profiler trace viewable in TensorBoard/Perfetto, with the
    program's spans (``lightfm.*``) beside the operators and kernels.

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
