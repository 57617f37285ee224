"""hybrid_update_roofline.fit: the least time of the traced steps'
optimizer passes (``work.k1_bound_s``: each touch's id and gradient row
read once, each distinct row's table and accumulator read and written
once, over the HBM rate) over the device time of the operations launched
inside the program's ``step.update`` spans.  The touches are the active
ones the driver saw handed to the optimizer (real features of examples
that update, no padding) and the distinct rows those touch.  None where
the program marks no ``step.update``."""

from portbench import generic_spans, work


def read(ctx):
    rec = generic_spans.record(ctx, "step.update")
    if rec is None or not ctx.get("update_touches"):
        return None
    bound = work.k1_bound_s(ctx["update_touches"], ctx["table_width"], ctx["update_distinct"])
    return work.share_pct(bound, generic_spans.device_s(ctx, rec, "step.update"))
