"""recommend_result_ms.eval: the median over the traced requests of the
host time of the program's ``recommend.result`` span (the wait for the
card's top-k and the copy of the scores and ids back).  None on a program
whose ``recommend`` marks no parts."""

from portbench import host_spans


def read(ctx):
    return host_spans.median_part_ms(ctx, "recommend.result")
