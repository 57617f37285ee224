"""hybrid_score_roofline.fit: the least time of the traced steps' scoring
(``work_hybrid.score_bound_s`` a step: the candidates' feature sums and
scores over the fp32 peak, or their feature ids and weights, the users'
rows and the feature table over the HBM rate, whichever is larger) over
the device time of the operations launched inside the program's
``step.score`` spans.  None where the program marks no ``step.score``."""

from portbench import generic_spans, work


def read(ctx):
    rec = generic_spans.record(ctx, "step.score")
    if rec is None or not ctx.get("score_bound_s"):
        return None
    return work.share_pct(ctx["score_bound_s"] * ctx["steps"],
                          generic_spans.device_s(ctx, rec, "step.score"))
