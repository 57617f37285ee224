"""The program's spans of host work in a traced window, for the readers of
``recommend``'s parts and of the training step's host time and launches.

Like :mod:`portbench.generic_spans`: None where the program marks none of
the spans a reader reads (a program older than them), and where the window
ran no device operation.  A window in which some traced calls hold a part
and others do not raises, as a window that lost a step's span does.
"""

from __future__ import annotations

import bisect

from portbench import generic_spans, program_spans

PART = "recommend."


def recommend_parts(ctx, part: str | None = None):
    """``(record, [(i, inside, parts)])`` for each traced ``recommend``: its
    index, the indices of every span inside it, and those of its spans
    named ``part`` (every ``recommend.*`` span where ``part`` is None)."""
    rec = program_spans.window_record(ctx, "recommend", "requests")
    if rec is None:
        return None
    calls = [(i, inside, [j for j in inside if _is_part(rec.spans[j].name, part)])
             for i, inside in program_spans.calls(rec, "recommend")]
    holding = sum(1 for *_, parts in calls if parts)
    if not holding:
        return None
    if holding < len(calls):
        raise RuntimeError(f"{holding} of the {len(calls)} traced recommend calls hold a "
                           f"{part or PART + '*'} span")
    return rec, calls


def _is_part(name: str, part: str | None) -> bool:
    return name == part if part else name.startswith(PART)


def median_part_ms(ctx, part: str):
    """The median over the traced calls of the host time of their ``part``."""
    got = recommend_parts(ctx, part)
    if got is None:
        return None
    rec, calls = got
    return program_spans.median_ms(
        sum(rec.spans[j].end_ns - rec.spans[j].start_ns for j in parts) for *_, parts in calls)


def steps(ctx):
    """The whole ``step`` spans kept in the window.  The generic drivers
    start the profiler inside the first traced step's span, which is then
    neither kept nor whole, so the window holds ``ctx["steps"]`` or one
    fewer."""
    from lightfm_tpu_torch import observability

    kept = getattr(observability, "kept_between", None)
    if kept is None:
        return None
    tr = ctx["trace"]
    found = kept(tr.t0, tr.t1).named("step")
    if not found:
        return None
    if len(found) not in (ctx["steps"] - 1, ctx["steps"]):
        raise RuntimeError(f"the traced window holds {len(found)} whole 'step' spans of the "
                           f"program, for its {ctx['steps']} steps")
    return found if tr.gpu else None


def update_spans(ctx):
    """The window's ``step.update`` spans (one a traced step) and ``step.l2``
    spans (two a traced step with L2 on, else none)."""
    rec = generic_spans.record(ctx, "step.update")
    if rec is None:
        return None
    l2 = rec.named("step.l2")
    if len(l2) not in (0, 2 * ctx["steps"]):
        raise RuntimeError(f"the traced window holds {len(l2)} 'step.l2' spans of the program, "
                           f"not two for each of its {ctx['steps']} steps or none")
    return rec.named("step.update") + l2


def launched_in(tr, spans) -> int:
    """Device operations whose launch (runtime call) lies inside one of
    ``spans``, matched by correlation id."""
    starts = [r[0] for r in tr.runtime]
    corr = set()
    for s in spans:
        lo = bisect.bisect_left(starts, s.start_ns)
        hi = bisect.bisect_right(starts, s.end_ns)
        corr.update(c for _, c in tr.runtime[lo:hi])
    return sum(1 for g in tr.gpu if g[3] in corr)
