"""step_score_ms.fit: the device time of the operations launched inside
the program's ``step.score`` spans (representations, pool scores,
violator search, rank weights), per traced step."""

from portbench import program_spans


def read(ctx):
    return program_spans.device_ms_per_step(ctx, "step.score")
