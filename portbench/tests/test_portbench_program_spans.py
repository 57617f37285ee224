"""The readers of the program's own spans and counters: nothing from a
window without device operations or from a program that keeps no spans;
on a traced window, the numbers its kept spans, counters and device
operations give; a window that lacks a span its traffic makes raises.  On
the card, the program's spans add no operation to the device trace."""

import contextlib
import importlib
import statistics

import pytest
import torch

from portbench import traced
from _tiny import cell, tiny_copy

EVAL_READERS = ("intersections_ms.eval", "fingerprint_ms.eval", "fingerprint_mb.eval",
                "rank_result_ms.eval", "idle_unnamed_ms.eval")
FIT_READERS = ("step_score_ms.fit", "step_update_ms.fit")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


def _traced_ctx(root, name, seed=31):
    c = cell(root, name)
    driver = importlib.import_module(f"portbench.drivers.{c.traffic['driver']}")
    run = driver.Run(c, seed, torch.device("cpu"))
    run.setup()
    ctx = run.traced()
    run.release()
    return c, ctx


def _launch_inside(tr, spans, ns=10_000):
    """One synthetic device operation launched in each span, running
    ``ns`` from its launch."""
    for k, s in enumerate(spans):
        at = (s.start_ns + s.end_ns) // 2
        tr.gpu.append((at, at + ns, "synthetic", 10_000 + k, "kernel"))
        tr.runtime.append((at, 10_000 + k))
    tr.gpu.sort()
    tr.runtime.sort()
    tr._runtime_starts = [r[0] for r in tr.runtime]


def _read(c, names, ctx):
    return {n: c.reader(n).read(ctx) for n in names}


def test_eval_readers_read_the_kept_spans_of_the_window(root, monkeypatch):
    from lightfm_tpu_torch import observability

    c, ctx = _traced_ctx(root, "tiny-mf.eval")
    tr = ctx["trace"]
    assert _read(c, EVAL_READERS, ctx) == dict.fromkeys(EVAL_READERS)  # no device operation
    rec = observability.kept_between(tr.t0, tr.t1)
    requests = rec.named("predict_rank")
    assert len(requests) == ctx["requests"]
    _launch_inside(tr, rec.named("rank.tier"))
    got = _read(c, EVAL_READERS, ctx)
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got

    def med(values):
        return statistics.median(values) * 1e-6

    assert got["intersections_ms.eval"] == med(
        s.end_ns - s.start_ns for s in rec.named("predict_rank.intersections"))
    assert got["fingerprint_mb.eval"] == rec.counters["fingerprint_bytes"] / len(requests) / 1e6
    calls = [s.call for s in requests]
    assert got["fingerprint_ms.eval"] == med(
        sum(s.end_ns - s.start_ns for s in rec.named("fingerprint") if s.call == k)
        for k in calls)
    assert got["rank_result_ms.eval"] == med(
        sum(rec.self_ns(i) for i, s in enumerate(rec.spans)
            if s.call == k and s.name in ("rank.scatter", "predict_rank.result"))
        for k in calls)

    # Every child span names its time, so the unnamed idle time lies in the
    # call's own gaps between them.
    gaps = med((r.end_ns - r.start_ns) - sum(
        s.end_ns - s.start_ns for i, s in enumerate(rec.spans)
        if s.parent is not None and rec.spans[s.parent] == r) for r in requests)
    assert got["idle_unnamed_ms.eval"] <= gaps + 1e-9

    # A span the traffic makes, renamed: its readers raise.
    kept = observability.kept_between

    def renamed(t0, t1):
        r = kept(t0, t1)
        r.spans = [s._replace(name="hash") if s.name == "fingerprint" else s for s in r.spans]
        return r

    with monkeypatch.context() as m:
        m.setattr(observability, "kept_between", renamed)
        for n in ("fingerprint_ms.eval", "fingerprint_mb.eval"):
            with pytest.raises(RuntimeError, match="fingerprint"):
                c.reader(n).read(ctx)
    # A window that lost a request's spans: every reader raises.
    t1 = tr.t1
    tr.t1 = requests[-1].end_ns - 1
    for n in EVAL_READERS:
        with pytest.raises(RuntimeError, match="predict_rank"):
            c.reader(n).read(ctx)
    tr.t1 = t1

    # A program that keeps no spans gives no reading and does not raise.
    monkeypatch.delattr(observability, "kept_between")
    assert _read(c, EVAL_READERS, ctx) == dict.fromkeys(EVAL_READERS)


def test_fit_readers_take_the_device_time_launched_in_the_step_parts(root, monkeypatch):
    from lightfm_tpu_torch import observability

    c, ctx = _traced_ctx(root, "tiny-mf.fit")
    tr = ctx["trace"]
    assert _read(c, FIT_READERS, ctx) == dict.fromkeys(FIT_READERS)  # no device operation
    rec = observability.kept_between(tr.t0, tr.t1)
    assert len(rec.named("step")) == len(rec.named("step.score")) == ctx["steps"]
    _launch_inside(tr, rec.named("step.score"), ns=2_000_000)
    got = _read(c, FIT_READERS, ctx)
    assert got["step_score_ms.fit"] == pytest.approx(2.0)
    assert got["step_update_ms.fit"] == 0.0

    t1 = tr.t1
    tr.t1 = rec.named("step.score")[-1].start_ns  # the last step's parts fall out
    for n in FIT_READERS:
        with pytest.raises(RuntimeError, match="step"):
            c.reader(n).read(ctx)
    tr.t1 = t1
    monkeypatch.delattr(observability, "kept_between")
    assert _read(c, FIT_READERS, ctx) == dict.fromkeys(FIT_READERS)


@pytest.mark.card
def test_program_spans_add_no_device_operation_to_the_trace(card):
    """On the card the program's spans are host ranges only: a window with
    them counts the kernels of the same window without them, its device
    trace holds no ``lightfm.*`` event, and the kept spans find the device
    time their launches took."""
    from lightfm_tpu_torch import observability

    x = torch.randn(512, 512, device=card)

    def window(spans: bool):
        prof = traced.Profiler(torch, card)
        prof.start()
        for _ in range(4):
            with observability.span("step") if spans else contextlib.nullcontext():
                with observability.span("step.score") if spans else contextlib.nullcontext():
                    y = x @ x
                y.sum()
        prof.stop()
        return prof.trace

    window(True)
    plain, spanned = window(False), window(True)
    assert spanned.kernel_count() == plain.kernel_count() > 0
    assert not [g for g in spanned.gpu if g[2].startswith(observability.PREFIX)]
    rec = observability.kept_between(spanned.t0, spanned.t1)
    assert len(rec.named("step")) == len(rec.named("step.score")) == 4
    assert sum(spanned.device_s_launched_in(s.start_ns, s.end_ns)
               for s in rec.named("step.score")) > 0
