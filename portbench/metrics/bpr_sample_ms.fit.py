"""bpr_sample_ms.fit: the device time of the operations launched inside the
program's ``step.bpr`` spans (the BPR step's tries' items, their test
against the user's positives and the first accepted try), per traced step.
None on a program whose step marks no ``step.bpr``."""

from portbench import generic_spans


def read(ctx):
    rec = generic_spans.record(ctx, "step.bpr")
    if rec is None:
        return None
    return generic_spans.device_s(ctx, rec, "step.bpr") * 1e3 / ctx["steps"]
