"""launches_per_step.fit: kernels the device ran in the traced run of
training steps (the profiler's kernel records) per step in it."""


def read(ctx):
    if not ctx["trace"].gpu or not ctx.get("steps"):
        return None
    return ctx["trace"].kernel_count() / ctx["steps"]
