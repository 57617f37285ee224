"""step_update_ms.fit: the device time of the operations launched inside
the program's ``step.update`` spans (the adagrad updates, K1 among them),
per traced step."""

from portbench import program_spans


def read(ctx):
    return program_spans.device_ms_per_step(ctx, "step.update")
