"""rank_result_ms.eval: the median over the traced requests of the self
time of the host scatter of the ranks (``rank.scatter``) plus the building
of the result matrix (``predict_rank.result``)."""

from portbench import program_spans

PARTS = ("rank.scatter", "predict_rank.result")


def read(ctx):
    rec = program_spans.request_record(ctx)
    if rec is None:
        return None
    return program_spans.median_ms(
        sum(rec.self_ns(j) for j in parts)
        for parts in program_spans.parts_per_request(rec, PARTS))
