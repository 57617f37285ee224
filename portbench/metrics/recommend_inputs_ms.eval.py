"""recommend_inputs_ms.eval: the median over the traced requests of the host
time of the program's ``recommend.inputs`` span (the user ids, the feature
matrices and their padded forms, the ids' copy to the card).  None on a
program whose ``recommend`` marks no parts."""

from portbench import host_spans


def read(ctx):
    return host_spans.median_part_ms(ctx, "recommend.inputs")
