"""recommend_idle_unnamed_ms.eval: the median over the traced requests of
the time inside ``recommend`` in which the device ran nothing and no span
of the program inside the call was open: the idle time that no part names.
None on a program whose ``recommend`` marks no parts."""

from portbench import host_spans, program_spans


def read(ctx):
    got = host_spans.recommend_parts(ctx)
    if got is None:
        return None
    rec, calls = got
    return program_spans.median_ms(
        program_spans.unnamed_idle_ns(ctx["trace"], rec, i, inside) for i, inside, _ in calls)
