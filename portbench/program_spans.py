"""The program's own spans and counters in a traced window: what
``lightfm_tpu_torch.observability`` kept while the profiler ran, on the
profiler's clock, read by time against the window's device trace.

A program that keeps no spans (one older than its observability module's
``kept_between``) gives None here, and its readers report nothing; so does
a window without device operations.  On a program that keeps them, a window
without the spans its traffic must make raises: a renamed or lost span
fails the run instead of dropping a metric.
"""

from __future__ import annotations

import statistics

from portbench import traced


def window_record(ctx, name: str, expected: str):
    """The kept spans and counter increments inside the traced window.
    The window must hold one span ``name`` for each of ``ctx[expected]``
    (the traced requests or steps).  None on a program that keeps no spans,
    and where the window ran no device operation (a CPU run, whose traced
    line carries no per-layer metric)."""
    from lightfm_tpu_torch import observability

    kept = getattr(observability, "kept_between", None)
    if kept is None:
        return None
    tr = ctx["trace"]
    rec = kept(tr.t0, tr.t1)
    found = len(rec.named(name))
    if found != ctx[expected]:
        raise RuntimeError(f"the traced window holds {found} {name!r} spans of the program, "
                           f"not one for each of its {ctx[expected]} {expected}")
    return rec if tr.gpu else None


def request_record(ctx):
    return window_record(ctx, "predict_rank", "requests")


def calls(rec, name: str) -> list:
    """``(index, [indices of the spans it contains])`` of each span
    ``name``, a public call such as ``predict_rank``."""
    out = []
    for i, s in enumerate(rec.spans):
        if s.name == name:
            inside = [j for j, c in enumerate(rec.spans)
                      if j != i and c.call == s.call and s.start_ns <= c.start_ns
                      and c.end_ns <= s.end_ns]
            out.append((i, inside))
    return out


def parts_per_request(rec, parts) -> list:
    """For each traced ``predict_rank``, the indices of the spans inside it
    named in ``parts``; raises where a request holds no span of a part."""
    out = []
    for _, inside in calls(rec, "predict_rank"):
        mine = [j for j in inside if rec.spans[j].name in parts]
        missing = set(parts) - {rec.spans[j].name for j in mine}
        if missing:
            raise RuntimeError(f"a traced predict_rank holds no {sorted(missing)} span")
        out.append(mine)
    return out


def median_ms(values) -> float:
    return statistics.median(values) * 1e-6


def device_ms_per_step(ctx, name: str) -> float | None:
    """Device ms of the operations launched inside the spans ``name``, per
    traced step."""
    rec = window_record(ctx, name, "steps")
    if rec is None:
        return None
    tr = ctx["trace"]
    return sum(tr.device_s_launched_in(s.start_ns, s.end_ns)
               for s in rec.named(name)) * 1e3 / ctx["steps"]


def unnamed_idle_ns(tr, rec, i: int, inside: list) -> int:
    """Time inside span ``i`` with no device operation running and no
    span inside it open."""
    s = rec.spans[i]
    cover = [(max(a, s.start_ns), min(b, s.end_ns)) for a, b, *_ in tr.gpu
             if b > s.start_ns and a < s.end_ns]
    cover += [(rec.spans[j].start_ns, rec.spans[j].end_ns) for j in inside]
    return s.end_ns - s.start_ns - sum(b - a for a, b in traced._union(cover))
