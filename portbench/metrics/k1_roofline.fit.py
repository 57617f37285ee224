"""k1_roofline.fit: the least time of every K1 call (``work.k1_bound_s``
from its touches, width and distinct rows) over the device time of what
those calls launched."""

from portbench import work


def read(ctx):
    if not ctx["trace"].gpu:
        return None
    calls = ctx.get("k1_calls")
    if not calls:
        return None
    bound = sum(work.k1_bound_s(M, W, distinct) for M, W, distinct in calls)
    return work.share_pct(bound, ctx["trace"].device_s_of_span("k1"))
