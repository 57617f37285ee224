"""adadelta_update_roofline.fit: the least time of the traced steps'
adadelta passes (``work_kos.adadelta_bound_s``: each active touch's id and
gradient row read once, each distinct row's table, accumulator and moment
read and written once, over the HBM rate) over the device time of the
operations launched inside the program's ``step.update`` spans.  The
touches are the active ones ``drivers/fit_partial.py`` saw handed to the
optimizer (those of examples that update) and the distinct rows those
touch.  None where the program marks no ``step.update``."""

from portbench import generic_spans, work, work_kos


def read(ctx):
    rec = generic_spans.record(ctx, "step.update")
    if rec is None or not ctx.get("update_touches"):
        return None
    bound = work_kos.adadelta_bound_s(ctx["update_touches"], ctx["table_width"],
                                      ctx["update_distinct"])
    return work.share_pct(bound, generic_spans.device_s(ctx, rec, "step.update"))
