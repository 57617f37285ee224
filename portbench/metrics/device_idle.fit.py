"""device_idle.fit: the share of a steady run of training steps in which
the device ran nothing: one less the device-busy seconds of the traced
steps over the wall time of the same steps in an untraced fit (the
profiler slows the host's enqueue, so the traced window's own idle share
overstates it)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.gpu or not ctx.get("steps_wall_s"):
        return None
    return 100.0 * (1.0 - tr.busy_s / ctx["steps_wall_s"])
