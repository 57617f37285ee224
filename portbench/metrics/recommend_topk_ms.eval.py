"""recommend_topk_ms.eval: the median over the traced requests of the device
time of the operations launched inside the program's ``recommend.topk``
span (the catalog scoring, the exclusion and the top-k).  None on a program
whose ``recommend`` marks no parts."""

import statistics

from portbench import host_spans


def read(ctx):
    got = host_spans.recommend_parts(ctx, "recommend.topk")
    if got is None:
        return None
    rec, calls = got
    tr = ctx["trace"]
    return statistics.median(
        sum(tr.device_s_launched_in(rec.spans[j].start_ns, rec.spans[j].end_ns) for j in parts)
        for *_, parts in calls) * 1e3
