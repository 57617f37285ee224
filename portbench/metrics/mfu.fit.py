"""mfu.fit: model FLOPs a second of the untraced fits timed in the traced
run (their examples a second on the host's clock times ``work.py``'s FLOPs
an example) over the chips' float32 peak.  Read only where the traced
steps ran on the device."""

from portbench import work


def read(ctx):
    if not ctx["trace"].gpu or not ctx.get("examples_per_s"):
        return None
    return work.share_pct(ctx["examples_per_s"] * ctx["flops_per_example"],
                          ctx["chips"] * work.PEAK_FP32_FLOPS)
