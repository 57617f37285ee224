"""mfu.eval: model operations a second of the untraced requests timed in
the traced run (their users a second on the host's clock times
``work.py``'s operations a user) over the chips' float32 peak.  Read only
where the traced requests ran on the device."""

from portbench import work


def read(ctx):
    if not ctx["trace"].gpu or not ctx.get("users_per_s"):
        return None
    return work.share_pct(ctx["users_per_s"] * ctx["flops_per_user"],
                          ctx["chips"] * work.PEAK_FP32_FLOPS)
