"""update_host_ms.fit: the host time of the program's ``step.update`` and
``step.l2`` spans (the optimizer passes of both tables, and with L2 on the
scale bump and the rescale guard), per traced step."""

from portbench import host_spans


def read(ctx):
    spans = host_spans.update_spans(ctx)
    if spans is None:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6 / ctx["steps"]
