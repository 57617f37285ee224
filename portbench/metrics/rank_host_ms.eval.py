"""rank_host_ms.eval: the median over traced requests of the host wall
time of a ``predict_rank`` call less the device time of what it
launched."""

import statistics


def read(ctx):
    tr = ctx["trace"]
    if not tr.gpu:
        return None
    spans = tr.instances("request")
    if not spans:
        return None
    return statistics.median(((e - s) * 1e-9 - tr.device_s_launched_in(s, e)) * 1e3
                             for s, e in spans)
