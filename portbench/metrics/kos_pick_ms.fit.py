"""kos_pick_ms.fit: the device time of the operations launched inside the
program's ``step.kos`` spans (the k-OS step's sampled positives, their
scores, their order and the pick), per traced step.  None on a program
whose step marks no ``step.kos``."""

from portbench import generic_spans


def read(ctx):
    rec = generic_spans.record(ctx, "step.kos")
    if rec is None:
        return None
    return generic_spans.device_s(ctx, rec, "step.kos") * 1e3 / ctx["steps"]
