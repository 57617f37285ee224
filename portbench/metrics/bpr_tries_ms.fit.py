"""bpr_tries_ms.fit: the median over the traced run's recorded calls of the
host time of the program's ``fit.bpr_tries`` span (sizing BPR's tries from
the interactions while a call stages them), in ms a call.  None on a
program that marks no ``fit.bpr_tries``, and where the traced steps ran no
device operation."""

import statistics


def read(ctx):
    if not ctx["trace"].gpu or not ctx.get("bpr_tries_ns"):
        return None
    return statistics.median(ctx["bpr_tries_ns"]) * 1e-6
