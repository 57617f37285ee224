"""fingerprint_mb.eval: MB that content fingerprints hashed per traced
request (the program's counter ``fingerprint_bytes`` over the traced
window, over its ``predict_rank`` calls)."""

from portbench import program_spans


def read(ctx):
    rec = program_spans.request_record(ctx)
    if rec is None:
        return None
    program_spans.parts_per_request(rec, ("fingerprint",))
    if "fingerprint_bytes" not in rec.counters:
        raise RuntimeError("the traced window's fingerprints counted no fingerprint_bytes")
    return rec.counters["fingerprint_bytes"] / ctx["requests"] / 1e6
