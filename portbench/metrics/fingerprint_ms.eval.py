"""fingerprint_ms.eval: the median over the traced requests of a
request's summed content fingerprints (the program's spans
``fingerprint`` inside each ``predict_rank``)."""

from portbench import program_spans


def read(ctx):
    rec = program_spans.request_record(ctx)
    if rec is None:
        return None
    return program_spans.median_ms(
        sum(rec.spans[j].end_ns - rec.spans[j].start_ns for j in parts)
        for parts in program_spans.parts_per_request(rec, ("fingerprint",)))
