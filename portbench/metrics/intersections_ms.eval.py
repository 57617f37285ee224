"""intersections_ms.eval: the median over the traced requests of the host
time of ``predict_rank``'s train/test intersection check (the program's
span ``predict_rank.intersections``)."""

from portbench import program_spans


def read(ctx):
    rec = program_spans.request_record(ctx)
    if rec is None:
        return None
    return program_spans.median_ms(
        sum(rec.spans[j].end_ns - rec.spans[j].start_ns for j in parts)
        for parts in program_spans.parts_per_request(rec, ("predict_rank.intersections",)))
