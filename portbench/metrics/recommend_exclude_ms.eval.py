"""recommend_exclude_ms.eval: the median over the traced requests of the
host time of the program's ``recommend.exclude`` span (the padded list of
each user's train items and its copy to the card).  None on a program whose
``recommend`` marks no parts."""

from portbench import host_spans


def read(ctx):
    return host_spans.median_part_ms(ctx, "recommend.exclude")
