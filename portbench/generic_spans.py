"""The program's spans of its generic step in a traced window, for the
readers of metrics that this step's spans brought: like
:mod:`portbench.program_spans`, but None where the program marks no span
of the name at all (a program older than those spans) instead of raising.
"""

from __future__ import annotations

from portbench import program_spans


def record(ctx, name: str, per_step: int = 1):
    """The window's kept record, holding ``per_step`` spans ``name`` a
    traced step; None where the program keeps no spans, marks no ``name``
    in the window, or the window ran no device operation."""
    from lightfm_tpu_torch import observability

    kept = getattr(observability, "kept_between", None)
    if kept is None or not kept(ctx["trace"].t0, ctx["trace"].t1).named(name):
        return None
    return program_spans.window_record(dict(ctx, spans=per_step * ctx["steps"]), name, "spans")


def device_s(ctx, rec, name: str) -> float:
    """Device seconds of the operations launched inside the spans ``name``."""
    tr = ctx["trace"]
    return sum(tr.device_s_launched_in(s.start_ns, s.end_ns) for s in rec.named(name))
