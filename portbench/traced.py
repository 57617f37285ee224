"""Traced runs: the benchmark's own spans around calls into the port,
records of the kernel wrappers' arguments, and the reading of the
profiler's device trace, kept in memory.

Nothing here edits the port: spans and records come from wrapping the
port's functions (module attributes and methods) for the traced window
only, and the wrappers are removed after it.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

PREFIX = "portbench."


class Patches:
    """Replacements of attributes, undone in reverse order on exit."""

    def __init__(self):
        self._undo = []

    def wrap(self, owner, attr: str, make):
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._undo.append((owner, attr, orig))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)


def spanned(torch, name: str, fn, record=None):
    """``fn`` inside a profiler span ``portbench.<name>``; ``record(*args,
    **kwargs)`` is called first when given."""
    def inner(*args, **kwargs):
        if record is not None:
            record(*args, **kwargs)
        with torch.profiler.record_function(PREFIX + name):
            return fn(*args, **kwargs)

    return inner


def span_all(torch, patches: Patches, targets, records=None):
    """Wrap each ``(owner, attr, span name)`` of ``targets`` in its span,
    with ``records[span name]`` as its recorder when given."""
    records = records or {}
    for owner, attr, name in targets:
        patches.wrap(owner, attr, lambda fn, name=name: spanned(torch, name, fn,
                                                               records.get(name)))


class Profiler:
    """``torch.profiler`` over a window opened by ``start()`` and closed by
    ``stop()``, inside the span ``portbench.window`` and synchronised at
    both ends (host activity alone on the CPU); after ``stop()``,
    ``trace`` holds the window's ``DeviceTrace``."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.cuda = device.type == "cuda"
        self.active = False
        self.trace = None

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.sync()
        self._prof = profile(activities=activities)
        self._prof.start()
        self._span = self.torch.profiler.record_function(PREFIX + "window")
        self._span.__enter__()
        self.active = True

    def stop(self):
        self.sync()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.active = False
        self.trace = DeviceTrace(self.torch, self._prof)
        self._prof = self._span = None


@contextlib.contextmanager
def profiled(torch, device):
    """The body as the profiled window; yields the ``Profiler``."""
    prof = Profiler(torch, device)
    prof.start()
    yield prof
    prof.stop()


def _union(intervals):
    """Merged, sorted ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """The device activity of a traced window, with the launch (host
    runtime call) of each device operation and the benchmark's spans.
    Times are ns on the profiler's clock."""

    def __init__(self, torch, prof):
        from torch.autograd import DeviceType

        gpu, runtime, spans = [], [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start, length = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                # Device annotations mirror the host spans: not operations.
                if not name.startswith(PREFIX):
                    kind = ("memcpy" if name.startswith("Memcpy") else
                            "memset" if name.startswith("Memset") else "kernel")
                    gpu.append((start, start + length, name, e.correlation_id(), kind))
            elif name.startswith(PREFIX):
                spans.append((start, start + length, name[len(PREFIX):]))
            elif name.startswith("cu") and "::" not in name:  # CUDA runtime and driver calls
                runtime.append((start, e.correlation_id()))
        windows = [s for s in spans if s[2] == "window"]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} window spans, not 1")
        self.t0, self.t1 = windows[0][0], windows[0][1]
        self.spans = sorted(s for s in spans if s[2] != "window")
        self.gpu = sorted(g for g in gpu if g[1] > self.t0 and g[0] < self.t1)
        self.runtime = sorted(runtime)
        self._runtime_starts = [r[0] for r in self.runtime]
        self._busy = _union([(max(s, self.t0), min(e, self.t1)) for s, e, *_ in self.gpu])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy) * 1e-9

    def kernel_count(self) -> int:
        return sum(1 for g in self.gpu if g[4] == "kernel")

    def instances(self, name: str) -> list:
        """``(start, end)`` of each span of that name."""
        return [(s, e) for s, e, n in self.spans if n == name]

    def device_s_launched_in(self, start: int, end: int) -> float:
        """Device seconds of the operations whose launch lies in ``[start,
        end]``."""
        lo = bisect.bisect_left(self._runtime_starts, start)
        hi = bisect.bisect_right(self._runtime_starts, end)
        corr = {c for _, c in self.runtime[lo:hi]}
        return sum(e - s for s, e, _, c, _ in self.gpu if c in corr) * 1e-9

    def device_s_of_span(self, name: str) -> float:
        """Device seconds of the operations launched inside spans of that
        name."""
        corr = set()
        for s, e in self.instances(name):
            lo = bisect.bisect_left(self._runtime_starts, s)
            hi = bisect.bisect_right(self._runtime_starts, e)
            corr.update(c for _, c in self.runtime[lo:hi])
        return sum(e - s for s, e, _, c, _ in self.gpu if c in corr) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        total = defaultdict(int)
        for s, e, name, *_ in self.gpu:
            total[name[:160]] += e - s
        return [[k, v * 1e-9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, n: int = 10) -> list:
        """Idle device time inside the window, summed by the innermost
        benchmark span open on the host during it ("none" outside every
        span)."""
        gaps, t = [], self.t0
        for s, e in self._busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.t1:
            gaps.append((t, self.t1))
        total = defaultdict(int)
        segs = self._innermost()
        k = 0
        for g0, g1 in gaps:
            while k < len(segs) and segs[k][1] <= g0:
                k += 1
            j = k
            while j < len(segs) and segs[j][0] < g1:
                total[segs[j][2]] += min(g1, segs[j][1]) - max(g0, segs[j][0])
                j += 1
        return [[k, v * 1e-9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def _innermost(self) -> list:
        """The window cut into ``(start, end, name)`` segments, each named by
        the innermost span open in it."""
        marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(self.spans)]
                       + [(e, 0, i) for i, (_, e, _) in enumerate(self.spans)])
        segs, stack, t = [], [], self.t0
        for when, opens, i in marks + [(self.t1, 0, -1)]:
            when = min(max(when, self.t0), self.t1)
            if when > t:
                segs.append((t, when, self.spans[stack[-1]][2] if stack else "none"))
                t = when
            if opens:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
        return segs
