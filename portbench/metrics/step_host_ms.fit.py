"""step_host_ms.fit: the host time of the program's ``step`` spans, over the
whole ``step`` spans in the traced window, in ms a step.  Where the host
enqueues a step more slowly than the device runs it, this sets the pace."""

from portbench import host_spans


def read(ctx):
    found = host_spans.steps(ctx)
    if found is None:
        return None
    return sum(s.end_ns - s.start_ns for s in found) * 1e-6 / len(found)
