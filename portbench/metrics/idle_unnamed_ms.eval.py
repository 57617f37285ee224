"""idle_unnamed_ms.eval: the median over the traced requests of the time
inside ``predict_rank`` in which the device ran nothing and no span of the
program inside the call was open: the idle time that no span names."""

from portbench import program_spans


def read(ctx):
    rec = program_spans.request_record(ctx)
    if rec is None:
        return None
    return program_spans.median_ms(
        program_spans.unnamed_idle_ns(ctx["trace"], rec, i, inside)
        for i, inside in program_spans.calls(rec, "predict_rank"))
