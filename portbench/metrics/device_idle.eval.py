"""device_idle.eval: the share of the traced window in which no device
operation ran."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.gpu or not ctx.get("requests"):
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
