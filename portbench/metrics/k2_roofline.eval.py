"""k2_roofline.eval: the least time of every K2 call (``work.k2_bound_s``
from its users and test slots, over the catalog's items at the width the
scores need) over the device time of what those calls launched."""

from portbench import work


def read(ctx):
    if not ctx["trace"].gpu:
        return None
    calls = ctx.get("k2_calls")
    if not calls:
        return None
    bound = sum(work.k2_bound_s(U, ctx["k2_items"], ctx["k2_width"], T) for U, T in calls)
    return work.share_pct(bound, ctx["trace"].device_s_of_span("k2"))
