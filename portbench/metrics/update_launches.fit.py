"""update_launches.fit: device operations whose launch lies inside the
program's ``step.update`` and ``step.l2`` spans, per traced step: the count
that a cheaper host enqueue of the update lowers, free of the profiler's
cost to the host."""

from portbench import host_spans


def read(ctx):
    spans = host_spans.update_spans(ctx)
    if spans is None:
        return None
    return host_spans.launched_in(ctx["trace"], spans) / ctx["steps"]
