"""step_l2_ms.fit: the device time of the operations launched inside the
program's ``step.l2`` spans, per traced step: two a step, the lazy-L2
scale bump that ends the step and the rescale guard after it, which
rewrites both tables.  None on a program whose step marks no ``step.l2``."""

from portbench import generic_spans


def read(ctx):
    rec = generic_spans.record(ctx, "step.l2", per_step=2)
    if rec is None:
        return None
    return generic_spans.device_s(ctx, rec, "step.l2") * 1e3 / ctx["steps"]
